"""Keygen: AIR inventory -> multi-STARK proving and verifying keys.

Port of openvm_tpu/stark/keygen.py:24-191: the same dataclasses, the same
``_vk_pre_hash`` (through the port's ``Poseidon2Host``) and the same DAGs,
so a verifying key's ``pre_hash`` equals the JAX package's.  The
preprocessed trace is extended with ``ntt.coset_lde`` (K3) and committed
with ``merkle.commit`` (K4, K5) on ``device``.  Proving-key files
(``save_pk``/``load_pk``/``cached_keygen``, keygen.py:199-309) are not
ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import merkle, ntt, poseidon2 as p2
from .._device import resolve_device
from ..field import babybear as bb
from .config import StarkConfig
from .logup import append_logup_constraints, chunk_interactions
from .symbolic import Air, AirBuilder, SymbolicDag


@dataclass
class AirWidths:
    preprocessed: int = 0
    cached_mains: tuple = ()
    common_main: int = 0
    after_challenge: int = 0  # in extension elements (m chunks + 1 cumsum)

    def main_widths(self):
        return list(self.cached_mains) + (
            [self.common_main] if self.common_main else [])


@dataclass
class AirVerifyingKey:
    name: str
    widths: AirWidths
    num_public_values: int
    num_exposed: int  # 0 or 1 (cumulative sum)
    log_quotient_degree: int
    dag: SymbolicDag
    interaction_chunks: list
    preprocessed_commit: Optional[np.ndarray] = None  # (8,) canonical digest

    @property
    def quotient_degree(self) -> int:
        return 1 << self.log_quotient_degree


@dataclass
class TraceHeightConstraint:
    """sum_i coefficients[i] * height_i < threshold."""

    coefficients: np.ndarray  # (num_airs,) uint64
    threshold: int
    is_threshold_at_p: bool = False


@dataclass
class MultiStarkVerifyingKey:
    config: StarkConfig
    per_air: list  # list[AirVerifyingKey]
    trace_height_constraints: list = field(default_factory=list)
    pre_hash: np.ndarray = None  # (8,) canonical

    @property
    def num_phases(self) -> int:
        return 1 if any(vk.widths.after_challenge for vk in self.per_air) else 0

    @property
    def num_challenges_to_sample(self):
        return [2] if self.num_phases else []


@dataclass
class AirProvingKey:
    vk: AirVerifyingKey
    air: Air
    preprocessed_lde: object = None  # committed LDE (bitrev) tensor or None
    preprocessed_tree: object = None
    preprocessed_trace: object = None  # natural-domain Montgomery tensor


@dataclass
class MultiStarkProvingKey:
    vk: MultiStarkVerifyingKey
    per_air: list  # list[AirProvingKey]
    # the prover's quotient programs and their code on the device, by the
    # set of AIRs proved (stark/prover.py): the same in every prove
    quotient_code: dict = field(default_factory=dict, repr=False, compare=False)
    # the histogram and LogUp kernels' per-key state (vm/machine.py,
    # stark/logup.py): their layouts and columns programs
    kernel_plans: dict = field(default_factory=dict, repr=False, compare=False)


def _vk_pre_hash(per_air, config: StarkConfig, height_constraints) -> np.ndarray:
    """Poseidon2 sponge over a canonical serialization of the vkey."""
    items: list[int] = [
        config.fri.log_blowup, config.fri.num_queries,
        config.fri.proof_of_work_bits, config.log_up_pow_bits,
        len(per_air),
    ]
    for vk in per_air:
        items += [vk.widths.preprocessed, len(vk.widths.cached_mains),
                  *vk.widths.cached_mains, vk.widths.common_main,
                  vk.widths.after_challenge, vk.num_public_values,
                  vk.num_exposed, vk.log_quotient_degree]
        for node in vk.dag.nodes:
            for part in node:
                if isinstance(part, str):
                    items += [sum(part.encode())]
                else:
                    items += [int(part)]
        items += [len(vk.dag.constraint_roots), *vk.dag.constraint_roots]
        if vk.preprocessed_commit is not None:
            items += [int(x) for x in vk.preprocessed_commit]
    for c in height_constraints:
        items += [int(x) for x in c.coefficients] + [c.threshold % bb.P]

    host = p2.Poseidon2Host()
    state = np.zeros(16, dtype=np.uint64)
    vals = np.asarray([v % bb.P for v in items], dtype=np.uint64)
    for c0 in range(0, len(vals), p2.RATE):
        chunk = vals[c0:c0 + p2.RATE]
        state[:len(chunk)] = chunk
        state = host.permute(state)
    return state[:8].copy()


def keygen(airs: list[Air], config: StarkConfig = StarkConfig(),
           trace_height_constraints: list | None = None,
           device=None) -> MultiStarkProvingKey:
    """Proving key for ``airs``; preprocessed traces go to ``device``
    (CUDA unless the caller names another)."""
    dev = resolve_device(device)
    per_air_vk = []
    per_air_pk_data = []
    for air in airs:
        builder = AirBuilder(air)
        air.eval(builder)
        interactions = list(builder.interactions)
        chunks = chunk_interactions(interactions, config.max_constraint_degree)
        num_chunks = append_logup_constraints(builder,
                                              config.max_constraint_degree)
        dag = SymbolicDag.from_builder(builder)

        # quotient degree = 2^ceil(log2(max_deg - 1)) as in the reference
        max_deg = max(dag.max_degree(), 2)
        log_qd = math.ceil(math.log2(max(max_deg - 1, 1)))
        if log_qd > config.fri.log_blowup:
            raise ValueError(
                f"air {air.name}: constraint degree {max_deg} needs quotient "
                f"blowup {log_qd} > fri log_blowup {config.fri.log_blowup}")

        prep = air.preprocessed_trace()
        prep_commit = None
        prep_lde = prep_tree = prep_dev = None
        if prep is not None:
            prep = np.asarray(prep, dtype=np.uint64) % bb.P
            prep_dev = bb.monty(prep, device=dev)
            prep_lde = ntt.coset_lde(prep_dev, config.fri.log_blowup)
            prep_tree = merkle.commit([prep_lde])
            prep_commit = prep_tree.root

        widths = AirWidths(
            preprocessed=0 if prep is None else int(prep.shape[1]),
            cached_mains=tuple(air.cached_main_widths),
            common_main=air.width,
            after_challenge=(num_chunks + 1) if interactions else 0,
        )
        vk = AirVerifyingKey(
            name=air.name,
            widths=widths,
            num_public_values=air.num_public_values,
            num_exposed=1 if interactions else 0,
            log_quotient_degree=log_qd,
            dag=dag,
            interaction_chunks=chunks,
            preprocessed_commit=prep_commit,
        )
        per_air_vk.append(vk)
        per_air_pk_data.append((prep_lde, prep_tree, prep_dev))

    height_constraints = list(trace_height_constraints or [])
    pre_hash = _vk_pre_hash(per_air_vk, config, height_constraints)
    mvk = MultiStarkVerifyingKey(config=config, per_air=per_air_vk,
                                 trace_height_constraints=height_constraints,
                                 pre_hash=pre_hash)
    per_air_pk = [
        AirProvingKey(vk=vk, air=air, preprocessed_lde=lde,
                      preprocessed_tree=tree, preprocessed_trace=dev_trace)
        for vk, air, (lde, tree, dev_trace) in zip(per_air_vk, airs,
                                                   per_air_pk_data)
    ]
    return MultiStarkProvingKey(vk=mvk, per_air=per_air_pk)
