"""VirtualMachine: config, keygen, prove, verify, for RV32IM on the card.

Port of openvm_tpu/vm/machine.py for the volatile-memory configuration:
``Rv32Config`` and ``VirtualMachine`` (:44-96, :135-193), ``keygen``
without the disk cache (:195), ``commit_exe`` (:211) on the port's ``ntt``
and ``merkle``, ``prove`` (:369-549, the volatile-memory branch),
``_assemble_and_prove`` (:551-589), ``_lookup_multiplicities`` (:591-660,
on kernel K8 and the quotient interpreter's columns mode) and ``verify``
(:790-833).  Persistent memory, continuations, metered execution, the
native (recursion) VM and the extension chips are later slices of the port.

Every trace goes to the device once, as Montgomery words: the histograms
read the executor traces there, and the prover takes the same tensors.
The preflight runs the C++ core (``native.NativeVmHandle``) unless the
caller passes ``native=False``; a core that does not build raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import merkle, ntt
from .._device import resolve_device
from ..field import babybear as bb
from ..stark import (AirProvingContext, StarkConfig, FriParameters,
                     keygen as stark_keygen, prove as stark_prove,
                     verify as stark_verify)
from ..stark import lookup
from ..stark import quotient as qmod
from ..stark.verifier import VerificationError
from .circuit import buses as B
from .circuit.rv32im import (AuipcAir, BaseAluAir, BranchEqAir, BranchLtAir,
                             DivRemAir, HintStoreAir, JalLuiAir, JalrAir,
                             LessThanAir, LoadStoreAir, MulAir, ShiftAir,
                             _pad_pow2)
from .circuit.system import (BitwiseLookupAir, ConnectorAir, PhantomAir,
                             ProgramAir, PublicValuesAir, RangeCheckerAir,
                             RangeTupleCheckerAir, VolatileBoundaryAir,
                             connector_trace, program_cached_trace)
from .instructions import VmExe
from .native import NativeVmHandle
from .preflight import PreflightInterpreter

P = bb.P


def _check(cond, msg):
    if not cond:
        raise VerificationError(msg)


FULL_EXECUTORS = ("alu", "lt", "beq", "blt", "jal_lui", "jalr", "auipc",
                  "loadstore", "shift", "mul", "divrem", "hintstore")


@dataclass
class Rv32Config:
    num_pv_words: int = 8
    stark: StarkConfig = None
    # executor chip families to include (reference VmConfig's modular
    # extension list, config.rs:60-103); tests can use a reduced set
    executors: tuple = FULL_EXECUTORS

    def __post_init__(self):
        if self.stark is None:
            # the reference's standard_with_100_bits_conjectured_security(1)
            # (crates/sdk/src/config/mod.rs:130-141): 84 queries, 16 PoW
            # bits at blowup 2
            self.stark = StarkConfig(
                fri=FriParameters.standard_with_100_bits_conjectured_security(1))


_EXECUTOR_AIRS = {
    "alu": BaseAluAir, "lt": LessThanAir, "beq": BranchEqAir,
    "blt": BranchLtAir, "jal_lui": JalLuiAir, "jalr": JalrAir,
    "auipc": AuipcAir, "loadstore": LoadStoreAir, "shift": ShiftAir,
    "mul": MulAir, "divrem": DivRemAir, "hintstore": HintStoreAir,
}


class VirtualMachine:
    """The volatile-memory RV32IM VM; its tensors live on ``device``
    (CUDA unless the caller names another)."""

    def __init__(self, config: Rv32Config | None = None, device=None):
        self.config = config or Rv32Config()
        self.device = resolve_device(device)
        system = [
            ProgramAir(), ConnectorAir(),
            PublicValuesAir(self.config.num_pv_words),
            VolatileBoundaryAir(), RangeCheckerAir(),
            BitwiseLookupAir(), PhantomAir(),
        ]
        self.NUM_SYSTEM_AIRS = len(system)
        executors = tuple(self.config.executors)
        self.airs = system + [_EXECUTOR_AIRS[name]() for name in executors]
        if "mul" in executors:
            # mul chips check (product limb, carry) pairs via the tuple
            # table (reference Rv32M periphery, extension/mod.rs:484-487)
            self.airs.append(RangeTupleCheckerAir())
        self.air_index = {a.name: i for i, a in enumerate(self.airs)}
        self.pk = None

    def keygen(self):
        """The multi-STARK proving key (machine.py:195, without the disk
        cache)."""
        self.pk = stark_keygen(self.airs, self.config.stark, device=self.device)
        return self.pk

    # -- commitment of the executable (program ROM cached trace) ---------
    def commit_exe(self, exe: VmExe, height: int | None = None) -> np.ndarray:
        cached = program_cached_trace(exe.program, height)
        lde = ntt.coset_lde(bb.monty(cached, device=self.device),
                            self.config.stark.fri.log_blowup)
        return merkle.commit([lde]).root

    # -- proving ---------------------------------------------------------
    def prove(self, exe: VmExe, inputs=None, max_insns=None, native=True,
              stages: dict | None = None, record: dict | None = None):
        """Preflight -> tracegen -> lookup histograms -> STARK proof.
        ``native=False`` runs the preflight's Python loop instead of the C++
        core.  ``stages`` (a dict) gets the seconds of each stage, the STARK
        prover's included; ``record`` (a dict) gets the inputs of the
        histogram kernels (``"lookup"``) and of the prover's kernels (see
        ``stark.prove``).  Returns (proof, preflight result)."""
        if self.pk is None:
            raise RuntimeError("call keygen() first")
        marks = [time.perf_counter()]

        def mark(stage):
            if stages is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                now = time.perf_counter()
                stages[stage] = now - marks[0]
                marks[0] = now

        nvm = NativeVmHandle(exe) if native else None
        if nvm is not None:
            nvm.set_mode(False)
        pre = PreflightInterpreter(exe, self.config.num_pv_words).execute(
            inputs, max_insns, nvm=nvm)
        mark("preflight")

        traces: dict[str, np.ndarray] = {}
        # program: cached [pc|opcode|operands], common [mult]
        cached = program_cached_trace(exe.program)
        mult = np.zeros((len(cached), 1), dtype=np.uint64)
        for idx, cnt in pre.exec_counts.items():
            mult[idx, 0] = cnt
        # the connector's end row fetches the TERMINATE instruction when the
        # segment terminates (soundness: final_pc must hold TERMINATE)
        if pre.exit_code is not None:
            t_idx = (pre.final_pc - exe.program.pc_base) // exe.program.step
            mult[t_idx, 0] += 1
        traces["program"] = mult

        suspended = pre.exit_code is None
        traces["connector"] = connector_trace(
            exe.pc_start, pre.final_pc, pre.final_ts,
            42 if suspended else pre.exit_code, 0 if suspended else 1)

        # public values air: data + final ts per word
        npv = self.config.num_pv_words
        pvt = np.zeros((npv, self.airs[self.air_index["public_values"]].width),
                       dtype=np.uint64)
        for i in range(npv):
            w = pre.touched.get((3, i))
            if w:
                pvt[i, :4] = w[:4]
                pvt[i, 4] = w[4]
        traces["public_values"] = pvt

        # boundary: touched words in AS 1 and 2, sorted by key
        entries = sorted((k, v) for k, v in pre.touched.items() if k[0] in (1, 2))
        brows = np.zeros((max(len(entries), 1),
                          self.airs[self.air_index["memory_boundary"]].width),
                         dtype=np.uint64)
        for r, ((a_s, wa), w) in enumerate(entries):
            init = pre.init_words[(a_s, wa)]
            brows[r, 0] = 1
            brows[r, 1] = a_s
            brows[r, 2] = wa
            brows[r, 3:7] = init
            brows[r, 7:11] = w[:4]
            brows[r, 11] = w[4]
        keys = [a_s * (1 << 27) + wa for ((a_s, wa), _) in entries]
        for r in range(len(entries) - 1):
            d = keys[r + 1] - keys[r] - 1
            brows[r, 12] = d & 0x7FFF
            brows[r, 13] = d >> 15
            brows[r, 14] = 1  # has_next_valid
        traces["memory_boundary"] = _pad_pow2(brows)

        # phantom
        ph = pre.records.get("phantom")
        width = self.airs[self.air_index["phantom"]].width
        if ph:
            pt = np.zeros((len(ph["pc"]), width), dtype=np.uint64)
            pt[:, 0] = 1
            pt[:, 1] = ph["pc"]
            pt[:, 2] = ph["ts"]
            pt[:, 3] = ph["a"]
            pt[:, 4] = ph["b"]
            pt[:, 5] = ph["c"]
            traces["phantom"] = _pad_pow2(pt)
        else:
            traces["phantom"] = np.zeros((1, width), dtype=np.uint64)

        # executor chips
        for name in pre.records:
            if name != "phantom" and name not in self.air_index:
                raise RuntimeError(
                    f"program uses {name} but the VM config excludes it")
        for air in self.airs[self.NUM_SYSTEM_AIRS:]:
            rec = pre.records.get(air.name)
            traces[air.name] = (air.trace(rec) if rec else
                                np.zeros((1, air.width), dtype=np.uint64))
        mark("tracegen")

        # every trace to the device once, reduced mod p (machine.py:625)
        mont = {name: bb.monty(t, device=self.device) for name, t in traces.items()}
        cached_m = bb.monty(cached, device=self.device)
        range_mult, bitwise_mult, tuple_mult = self._lookup_multiplicities(
            mont, cached_m, record)
        mont["range_checker"] = range_mult
        mont["bitwise_lookup"] = bitwise_mult
        if "range_tuple" in self.air_index:
            mont["range_tuple"] = tuple_mult
        mark("histograms")
        return self._assemble_and_prove(mont, pre, exe, cached_m, stages,
                                        record), pre

    def _assemble_and_prove(self, traces, pre, exe, program_cached, stages,
                            record):
        ctxs = []
        for i, air in enumerate(self.airs):
            kwargs = dict(air_id=i, common_main=traces[air.name])
            if air.name == "program":
                kwargs["cached_mains"] = [program_cached]
            if air.name == "connector":
                suspended = pre.exit_code is None
                kwargs["public_values"] = [
                    exe.pc_start, pre.final_pc,
                    42 if suspended else pre.exit_code, 0 if suspended else 1]
            if air.name == "public_values":
                kwargs["public_values"] = list(pre.public_values)
            ctxs.append(AirProvingContext(**kwargs))
        if record is not None:
            record["ctxs"] = ctxs
        return stark_prove(self.pk, ctxs, device=self.device, stages=stages,
                           record=record)

    def _lookup_multiplicities(self, traces: dict, program_cached, record=None):
        """Every AIR's RANGE/BITWISE/TUPLE sends evaluated over its trace
        (the quotient interpreter's columns mode, K7, a launch an AIR) and
        histogrammed on the device (K8, one launch for every AIR) into three
        tables, copied to the host once (machine.py:591-660).  ``traces``:
        Montgomery tensors by AIR name.  Returns the range, bitwise and
        tuple multiplicity traces as Montgomery tensors (the tuple one None
        without a tuple AIR)."""
        range_h = len(self.airs[self.air_index["range_checker"]].preprocessed_trace())
        tuple_sizes = ()
        if "range_tuple" in self.air_index:
            tuple_sizes = self.airs[self.air_index["range_tuple"]].sizes
        tuple_total = tuple_sizes[0] * tuple_sizes[1] if tuple_sizes else 0
        sizes1 = tuple_sizes[1] if tuple_sizes else 1
        if "lookup" not in self.pk.kernel_plans:
            self.pk.kernel_plans["lookup"] = self._send_plan()
        entries = self.pk.kernel_plans["lookup"]
        tables = lookup.new_tables(range_h, tuple_total, self.device)
        cols, airs = [], []
        for i, prog, layout in entries:
            air = self.airs[i]
            mains = ([program_cached, traces[air.name]] if air.name == "program"
                     else [traces[air.name]])
            prep = self.pk.per_air[i].preprocessed_trace
            sources = mains + ([prep] if prep is not None else [])
            log_n = int(mains[0].shape[0]).bit_length() - 1
            cols.append(qmod.evaluate_columns(prog, sources, log_n))
            airs.append((air.name, prog, sources, log_n, layout))
        lookup.lookup_hist_many(cols, [e[2] for e in entries], tables, sizes1)
        del cols
        if record is not None:
            record["lookup"] = {"airs": airs, "tables": tables,
                                "sizes": (range_h, tuple_total, sizes1)}
        range_h_np, bitwise_np, tuple_np = lookup.tables_to_host(tables)
        return (bb.monty(range_h_np[:, None], device=self.device),
                bb.monty(bitwise_np.reshape(-1, 2), device=self.device),
                bb.monty(tuple_np[:, None], device=self.device)
                if tuple_sizes else None)

    def _send_plan(self) -> list:
        """Each AIR's lookup sends (index, columns program, layout): the
        same in every prove, so built once per proving key.  The program's
        pool holds no prove's values."""
        kind_of = {B.RANGE_BUS: "range", B.BITWISE_BUS: "bitwise",
                   B.RANGE_TUPLE_BUS: "tuple"}
        entries = []
        for i, air in enumerate(self.airs):
            dag = self.pk.vk.per_air[i].dag
            sends = [(kind_of[bus], frs, cr) for (bus, frs, cr, is_send)
                     in dag.interactions if is_send and bus in kind_of]
            if not sends:
                continue
            layout = lookup.send_layout(sends)
            prog = qmod.compile_columns(
                dag, layout.roots, n_main=2 if air.name == "program" else 1,
                has_preprocessed=self.pk.per_air[i].preprocessed_trace is not None,
                publics=[0] * 64)
            entries.append((i, prog, layout))
        return entries

    # -- verification ----------------------------------------------------
    def verify(self, proof, expected_exe_commit=None, exe: VmExe = None):
        """Verify a single (terminating) proof (machine.py:790-833)."""
        stark_verify(self.pk.vk, proof)
        # all airs must be present, in order
        _check([p.air_id for p in proof.per_air] == list(range(len(self.airs))),
               "missing AIRs")
        conn = proof.per_air[self.air_index["connector"]]
        _check(conn.public_values[3] == 1, "program did not terminate")
        _check(conn.public_values[2] == 0, f"exit code {conn.public_values[2]}")
        if expected_exe_commit is not None:
            got = np.asarray(proof.commitments.main_trace[0], dtype=np.uint64)
            _check(np.array_equal(got, np.asarray(expected_exe_commit,
                                                  dtype=np.uint64)),
                   "program commitment mismatch")
        if exe is not None:
            _check(conn.public_values[0] == exe.pc_start, "wrong entry pc")
        pv_air = proof.per_air[self.air_index["public_values"]]
        return {"initial_pc": conn.public_values[0],
                "final_pc": conn.public_values[1],
                "public_values": pv_air.public_values}
