"""VirtualMachine: config, keygen, prove, verify, for RV32IM on the card.

Port of openvm_tpu/vm/machine.py for the volatile- and persistent-memory
configurations: ``Rv32Config`` (with ``bigint``, ``moduli``, ``curves``,
``fp2``, ``keccak``, ``sha256`` and ``persistent``) and ``VirtualMachine`` (:44-96,
:98-119 the int256, keccak and sha256 AIRs and executor names, :135-193 with the
executors appended at :168-176, int256 before keccak and sha256, the
modular AIRs after RangeTupleCheckerAir :182-185, the ECC AIRs after
them :186-188 and the Fp2 AIRs after those :189-191, the persistent system
AIRs :150-158), ``_interp`` with the moduli, curves and Fp2 moduli
(:236-240), ``keygen``
without the disk cache (:195), ``commit_exe`` (:211) on the port's ``ntt``
and ``merkle``, ``_segment_ctx`` (:242), ``execute_metered`` (:279),
``_initial_tree`` (:305), ``_persistent_traces`` (:316), ``prove``
(:369-549, with ``state``, ``initial_tree``, ``fixed_heights``, ``nvm``,
``seg_ctx``, ``heights_only`` and ``debug``; up to the STARK prove in
``_contexts``), ``_assemble`` (:551-589, the memory_merkle public values
:580-581), ``_lookup_multiplicities`` (:591-660, on kernel K8 and the quotient
interpreter's columns mode), the continuations ``_segment_sweep`` (:663),
``segment_height_profile`` (:698), ``prove_continuations`` (:718) and
``verify_segments`` (:745), ``verify`` (:790-833, the persistent branch
:819-826) and ``commit_init_memory`` (:834).  The native (recursion) VM
is a later slice of the port.

Every trace goes to the device once, as Montgomery words: the histograms
read the executor traces there, and the prover takes the same tensors.
The preflight runs the C++ core (``native.NativeVmHandle``) unless the
caller passes ``native=False``; a core that does not build raises, in
every entry point (the JAX package's continuations fall back to the
Python loop there, machine.py:226-233,676-677; the port does not).
"""

from __future__ import annotations

import itertools
import os
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
from ..stark.debug import check_constraints
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
from .circuit.bigint import INT256_AIRS
from .circuit.ecc import ecc_airs
from .circuit.fp2 import fp2_airs
from .circuit.keccak import KECCAK_AIRS
from .circuit.merkle_chip import MemoryMerkleAir
from .circuit.modular import modular_airs
from .circuit.persistent_boundary import PersistentBoundaryAir
from .circuit.poseidon2_chip import Poseidon2Air
from .circuit.sha256 import SHA256_AIRS
from .instructions import VmExe
from .memory_tree import SparseMemoryTree, hash_leaf, leaf_index
from .native import NativeVmHandle
from .preflight import PreflightInterpreter, SegmentCtx

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
    # enable the Int256 (bigint) extension chips (reference
    # extensions/bigint, SURVEY.md section 2.8)
    bigint: bool = False
    # keccak256 extension (reference extensions/keccak256, SURVEY.md 2.6)
    keccak: bool = False
    # sha256 extension (reference extensions/sha256, SURVEY.md 2.7)
    sha256: bool = False
    # modular-arithmetic (algebra) extension: one chip trio per modulus
    # (reference ModularExtension{supported_moduli}, SURVEY.md section 2.9)
    moduli: tuple = ()
    # ECC extension: (modulus, a_coeff) per short-Weierstrass curve
    # (reference WeierstrassExtension{supported_curves}, SURVEY.md 2.10)
    curves: tuple = ()
    # Fp2 (complex extension field) moduli (reference Fp2Extension)
    fp2: tuple = ()
    # persistent memory: Merkle-committed memory state (continuations mode,
    # reference SystemConfig.continuation_enabled)
    persistent: bool = False

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
    **INT256_AIRS, **KECCAK_AIRS, **SHA256_AIRS,
}

INT256_EXECUTORS = ("int256_alu", "int256_lt", "int256_mul", "int256_beq",
                    "int256_blt", "int256_shift")

KECCAK_EXECUTORS = ("keccak_sponge", "keccakf")

SHA256_EXECUTORS = ("sha256_sponge", "sha256")


class VirtualMachine:
    """The RV32IM VM, with volatile or persistent memory; its tensors live
    on ``device`` (CUDA unless the caller names another)."""

    def __init__(self, config: Rv32Config | None = None, device=None):
        self.config = config or Rv32Config()
        self.device = resolve_device(device)
        if self.config.persistent:
            system = [
                ProgramAir(), ConnectorAir(), PersistentBoundaryAir(),
                MemoryMerkleAir(), Poseidon2Air(), RangeCheckerAir(),
                BitwiseLookupAir(), PhantomAir(),
            ]
        else:
            system = [
                ProgramAir(), ConnectorAir(),
                PublicValuesAir(self.config.num_pv_words),
                VolatileBoundaryAir(), RangeCheckerAir(),
                BitwiseLookupAir(), PhantomAir(),
            ]
        self.NUM_SYSTEM_AIRS = len(system)
        executors = tuple(self.config.executors)
        if self.config.bigint:
            executors += tuple(n for n in INT256_EXECUTORS
                               if n not in executors)
        if self.config.keccak:
            executors += tuple(n for n in KECCAK_EXECUTORS
                               if n not in executors)
        if self.config.sha256:
            executors += tuple(n for n in SHA256_EXECUTORS
                               if n not in executors)
        self.airs = system + [_EXECUTOR_AIRS[name]() for name in executors]
        if "mul" in executors:
            # mul chips check (product limb, carry) pairs via the tuple
            # table (reference Rv32M periphery, extension/mod.rs:484-487)
            self.airs.append(RangeTupleCheckerAir())
        if self.config.moduli:
            self.airs += list(modular_airs(self.config.moduli).values())
        if self.config.curves:
            self.airs += list(ecc_airs(self.config.curves).values())
        if self.config.fp2:
            self.airs += list(fp2_airs(self.config.fp2).values())
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

    # -- preflight plumbing ---------------------------------------------
    def _interp(self, exe: VmExe) -> PreflightInterpreter:
        return PreflightInterpreter(exe, self.config.num_pv_words,
                                    moduli=self.config.moduli,
                                    curves=self.config.curves,
                                    fp2=self.config.fp2)

    def _segment_ctx(self, nvm, limits: dict | None = None) -> SegmentCtx:
        """Install metered segmentation thresholds on the handle and build
        the Python-side chip accounting (machine.py:242; reference
        SegmentationLimits defaults, segment_ctx.rs:6-10; the powdr fork's
        POWDR_OPENVM_SEGMENT_DELTA timestamp-pressure knob is honored).
        The default ``max_height`` is the JAX package's, 2^26 - 10,000 at
        log_blowup 1; the reference's is 2^23 - 10,000."""
        if self.pk is None:
            raise RuntimeError("segmentation needs keygen() first")
        cap = 1 << self.config.stark.fri.max_log_trace_height
        defaults = {
            "max_height": cap - 10000 if cap > 20000 else cap,
            "max_cells": 2_000_000_000,
            "max_interactions": P,
            "check_insns": 1000,
        }
        defaults.update(limits or {})
        widths = {a.name: a.width for a in self.airs}
        inters = {a.name: len(self.pk.vk.per_air[i].dag.interactions)
                  for i, a in enumerate(self.airs)}
        ts_delta = int(os.environ.get("POWDR_OPENVM_SEGMENT_DELTA", -1))
        # per-touched-word trace pressure: one boundary row per word plus
        # merkle path rows (amortized estimate; paths share prefixes)
        tw = widths.get("persistent_boundary", 0) \
            + 4 * widths.get("memory_merkle", 0)
        ti = inters.get("persistent_boundary", 0) \
            + 4 * inters.get("memory_merkle", 0)
        nvm.set_limits(max_height=defaults["max_height"],
                       max_cells=defaults["max_cells"],
                       max_interactions=defaults["max_interactions"],
                       ts_delta=ts_delta,
                       check_insns=defaults["check_insns"],
                       widths=widths, inters=inters,
                       touched_width=tw, touched_inters=ti)
        return SegmentCtx(widths=widths, inters=inters)

    # -- metered execution (trace-height accounting) ----------------------
    def execute_metered(self, exe: VmExe, inputs=None, max_insns=None,
                        native=True) -> dict:
        """Count-only execution returning per-chip trace heights
        (machine.py:279).  On the C++ core the chips allocate no record
        buffers (count-only rows, the reference's metered height
        counters); ``native=False`` runs the Python loop."""
        nvm = NativeVmHandle(exe) if native else None
        if nvm is not None:
            nvm.set_mode(True)
        pre = self._interp(exe).execute(inputs, max_insns, nvm=nvm)
        heights = {}
        for air in self.airs[self.NUM_SYSTEM_AIRS:]:
            rec = pre.records.get(air.name)
            n = len(next(iter(rec.values()))) if rec else 1
            heights[air.name] = 1 << max((n - 1).bit_length(), 0)
        max_h = self.config.stark.fri.max_log_trace_height
        fits = all(h <= (1 << max_h) for h in heights.values())
        return {"instret": pre.instret, "chip_heights": heights,
                "exit_code": pre.exit_code,
                "fits_single_segment": fits,
                "total_cells": sum(
                    h * a.width for a, h in
                    zip(self.airs[self.NUM_SYSTEM_AIRS:], heights.values()))}

    # -- persistent-memory system traces --------------------------------
    def _initial_tree(self, exe: VmExe):
        """The executable's initial memory as a SparseMemoryTree and as
        {(as, word): [4 bytes]} (machine.py:305)."""
        tree = SparseMemoryTree()
        words: dict = {}
        for (a_s, addr), byte in exe.init_memory.items():
            w = words.setdefault((a_s, addr // 4), [0, 0, 0, 0])
            w[addr % 4] = byte
        for (a_s, wa), data in words.items():
            tree.write_word(a_s, wa, data)
        return tree, words

    def _persistent_traces(self, traces, pre, exe, initial_tree=None) -> list:
        """Build the persistent boundary, merkle and poseidon2 traces
        (machine.py:316); returns the merkle AIR's public values
        [initial_root || final_root] and leaves the updated tree in
        ``pre.final_memory_tree``."""
        if initial_tree is not None:
            tree, init_words_img = initial_tree
        else:
            tree, init_words_img = self._initial_tree(exe)

        def init_word(a_s, wa):
            if (a_s, wa) in pre.init_words:
                return list(pre.init_words[(a_s, wa)])
            return list(init_words_img.get((a_s, wa), [0, 0, 0, 0]))

        touched = {k: v for k, v in pre.touched.items() if k[0] in (1, 2, 3)}
        leaves = sorted({(a_s, wa // 2) for (a_s, wa) in touched})
        leaf_rows = []
        leaf_updates = {}
        for (a_s, li) in leaves:
            init_cells = init_word(a_s, 2 * li) + init_word(a_s, 2 * li + 1)
            final_cells = list(init_cells)
            fts = [0, 0]
            for k in range(2):
                w = touched.get((a_s, 2 * li + k))
                if w:
                    final_cells[4 * k:4 * k + 4] = w[:4]
                    fts[k] = w[4]
            leaf_rows.append({"as": a_s, "leaf": li,
                              "init": init_cells, "final": final_cells,
                              "fts0": fts[0], "fts1": fts[1]})
            leaf_updates[leaf_index(a_s, 2 * li)] = (
                hash_leaf(init_cells), hash_leaf(final_cells))

        boundary_air = self.airs[self.air_index["persistent_boundary"]]
        merkle_air = self.airs[self.air_index["memory_merkle"]]
        p2_air = self.airs[self.air_index["poseidon2"]]

        btrace = boundary_air.trace(leaf_rows)
        mtrace, init_root, final_root = merkle_air.trace(leaf_updates, tree)
        requests = np.concatenate([boundary_air.p2_requests(btrace),
                                   merkle_air.p2_requests(mtrace)], axis=0)
        traces["persistent_boundary"] = btrace
        traces["memory_merkle"] = mtrace
        traces["poseidon2"] = p2_air.trace(requests)

        for (a_s, wa), w in touched.items():
            tree.write_word(a_s, wa, w[:4])
        pre.final_memory_tree = tree
        return [int(x) for x in init_root] + [int(x) for x in final_root]

    # -- proving ---------------------------------------------------------
    def prove(self, exe: VmExe, inputs=None, max_insns=None, native=True,
              stages: dict | None = None, record: dict | None = None,
              state: dict | None = None, initial_tree=None,
              fixed_heights: dict | None = None, nvm=None,
              seg_ctx: SegmentCtx | None = None, heights_only: bool = False,
              debug: bool = False):
        """Preflight -> tracegen -> lookup histograms -> STARK proof.
        ``native=False`` runs the preflight's Python loop instead of the C++
        core.  ``stages`` (a dict) gets the seconds of each stage, the STARK
        prover's included; ``record`` (a dict) gets the proving contexts
        (``"ctxs"``), each executor AIR's tracegen seconds
        (``"tracegen_s"``), the inputs of the histogram kernels
        (``"lookup"``) and of the prover's kernels (see ``stark.prove``).

        A continuation segment passes the suspended ``state`` of the one
        before, the memory tree it ends with (``initial_tree``: (tree,
        words)), the C++ handle that holds the memory (``nvm``) and the
        metered limits (``seg_ctx``).  ``fixed_heights`` pads the named
        traces to those heights.  ``heights_only`` stops after tracegen and
        returns each trace's height; ``debug`` runs
        ``stark.debug.check_constraints`` on the contexts before the prove.
        Returns (proof, preflight result)."""
        ctxs, pre = self._contexts(
            exe, inputs, max_insns, native, stages, record, state=state,
            initial_tree=initial_tree, fixed_heights=fixed_heights, nvm=nvm,
            seg_ctx=seg_ctx, heights_only=heights_only)
        if heights_only:
            return ctxs, pre
        if debug:
            check_constraints(self.pk, ctxs)
        return stark_prove(self.pk, ctxs, device=self.device, stages=stages,
                           record=record), pre

    def _contexts(self, exe: VmExe, inputs, max_insns, native, stages, record,
                  state=None, initial_tree=None, fixed_heights=None, nvm=None,
                  seg_ctx=None, heights_only=False):
        """``prove`` up to the STARK prove: (the proving contexts, or each
        trace's height when ``heights_only``; the preflight result)."""
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

        if native and nvm is None and state is None:
            nvm = NativeVmHandle(exe)
        if nvm is not None:
            nvm.set_mode(False)
        pre = self._interp(exe).execute(
            inputs, max_insns, state=state, nvm=nvm, seg_ctx=seg_ctx)
        mark("preflight")

        traces: dict[str, np.ndarray] = {}
        # program: cached [pc|opcode|operands], common [mult]
        cached = program_cached_trace(
            exe.program, fixed_heights.get("program") if fixed_heights else None)
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
        initial_pc = state["pc"] if state is not None else exe.pc_start
        traces["connector"] = connector_trace(
            initial_pc, pre.final_pc, pre.final_ts,
            42 if suspended else pre.exit_code, 0 if suspended else 1)

        merkle_pvs = None
        if self.config.persistent:
            merkle_pvs = self._persistent_traces(traces, pre, exe,
                                                 initial_tree=initial_tree)
            mark("persistent_traces")
        else:
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
            entries = sorted((k, v) for k, v in pre.touched.items()
                             if k[0] in (1, 2))
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
        tracegen_s = {}
        for air in self.airs[self.NUM_SYSTEM_AIRS:]:
            rec = pre.records.get(air.name)
            t0 = time.perf_counter()
            traces[air.name] = (air.trace(rec) if rec else
                                np.zeros((1, air.width), dtype=np.uint64))
            tracegen_s[air.name] = time.perf_counter() - t0
        if record is not None:
            record["tracegen_s"] = tracegen_s

        # fixed-height padding: every segment proved at one shape
        if fixed_heights:
            for name, h in fixed_heights.items():
                if name in traces:
                    air = self.airs[self.air_index[name]]
                    traces[name] = air.pad_to(traces[name], h)

        if heights_only:
            # pass 1 of uniform-shape continuations: each trace's (power of
            # two) height, no histograms, commit or prove
            heights = {name: len(tr) for name, tr in traces.items()}
            heights["program"] = len(cached)
            return heights, pre
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
        return self._assemble(mont, pre, exe, cached_m, record,
                              initial_pc=initial_pc, merkle_pvs=merkle_pvs), pre

    def _assemble(self, traces, pre, exe, program_cached, record,
                  initial_pc=None, merkle_pvs=None):
        ctxs = []
        for i, air in enumerate(self.airs):
            kwargs = dict(air_id=i, common_main=traces[air.name])
            if air.name == "program":
                kwargs["cached_mains"] = [program_cached]
            if air.name == "connector":
                suspended = pre.exit_code is None
                kwargs["public_values"] = [
                    exe.pc_start if initial_pc is None else initial_pc,
                    pre.final_pc,
                    42 if suspended else pre.exit_code, 0 if suspended else 1]
            if air.name == "public_values":
                kwargs["public_values"] = list(pre.public_values)
            if air.name == "memory_merkle" and merkle_pvs is not None:
                kwargs["public_values"] = merkle_pvs
            ctxs.append(AirProvingContext(**kwargs))
        if record is not None:
            record["ctxs"] = ctxs
        return ctxs

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

    # -- continuations ---------------------------------------------------
    def _segment_sweep(self, exe, inputs, max_insns_per_segment,
                       segment_limits, native, step, on_segment, stages=None,
                       records: dict | None = None, **step_kw):
        """The continuation loop (machine.py:663; reference VmInstance::
        prove_continuations, arch/vm.rs:966-1021).  One C++ handle spans
        every segment: memory persists in it, and ``segment_reset`` drops
        the records, touched words and counts between segments.  The
        Python loop (``native=False``) carries the memory in the suspended
        state and stops a segment at ``max_insns_per_segment``, 2^20 when
        none is given.  ``step`` (``prove`` or ``_contexts``) runs a
        segment; ``on_segment(result, pre)`` collects each segment's
        result; ``stages`` (a list) gets each segment's stage seconds;
        ``records`` (segment index -> dict) gets the named segments'
        ``record``.  Returns the final memory tree."""
        tree, words = self._initial_tree(exe)
        nvm = NativeVmHandle(exe) if native else None
        seg_ctx = None
        if nvm is not None:
            seg_ctx = self._segment_ctx(nvm, segment_limits)
        elif max_insns_per_segment is None:
            max_insns_per_segment = 1 << 20
        state = None
        for segment in itertools.count():
            seg_stages = {} if stages is not None else None
            result, pre = step(
                exe, inputs if state is None else None, max_insns_per_segment,
                nvm is not None, seg_stages, (records or {}).get(segment),
                state=state, initial_tree=(tree, dict(words)), nvm=nvm,
                seg_ctx=seg_ctx, **step_kw)
            if stages is not None:
                stages.append(seg_stages)
            on_segment(result, pre)
            for k, w in pre.touched.items():
                words[k] = list(w[:4])
            if pre.exit_code is not None:
                return pre.final_memory_tree
            state = pre.suspended_state
            tree = pre.final_memory_tree
            if nvm is not None:
                nvm.segment_reset()
            else:
                words = state["memory_words"]

    def _require_persistent(self):
        if not self.config.persistent:
            raise ValueError("continuations need Rv32Config(persistent=True)")

    def segment_height_profile(self, exe: VmExe, inputs=None,
                               max_insns_per_segment: int | None = None,
                               segment_limits: dict | None = None,
                               native=True) -> dict:
        """Per-chip max (power of two) trace heights across all segments of
        an execution (machine.py:698): proving every segment padded to it
        gives all segment proofs one shape."""
        self._require_persistent()
        profile: dict = {}

        def collect(heights, _pre):
            for k, h in heights.items():
                profile[k] = max(profile.get(k, 1), int(h))

        self._segment_sweep(exe, inputs, max_insns_per_segment,
                            segment_limits, native, self._contexts, collect,
                            heights_only=True)
        return profile

    def segment_contexts(self, exe: VmExe, inputs=None,
                         max_insns_per_segment: int | None = None,
                         segment_limits: dict | None = None,
                         fixed_heights: dict | None = None,
                         native=True) -> tuple:
        """Each segment's proving contexts, as ``prove_continuations`` would
        prove them, without proving: (list of context lists, final memory
        tree)."""
        self._require_persistent()
        segments: list = []
        tree = self._segment_sweep(
            exe, inputs, max_insns_per_segment, segment_limits, native,
            self._contexts, lambda ctxs, pre: segments.append(ctxs),
            fixed_heights=fixed_heights)
        return segments, tree

    def prove_continuations(self, exe: VmExe, inputs=None,
                            max_insns_per_segment: int | None = None,
                            segment_limits: dict | None = None,
                            debug=False, fixed_heights: dict | None = None,
                            uniform_shapes: bool = False, native=True,
                            stages: list | None = None,
                            records: dict | None = None):
        """Segmented proving in persistent mode (machine.py:718): run until
        a metered segmentation limit trips (live trace height, cells and
        interactions, reference segment_ctx.rs:135-217) or the optional
        instruction budget, carry the VM state, and chain (pc, memory root)
        across segments.  ``uniform_shapes=True`` first sweeps every
        segment heights-only and proves each padded to the per-chip
        maximum.  ``stages`` (a list) gets each segment's stage seconds;
        ``records`` maps segment indices to dicts, each of which gets that
        segment's ``record`` (see ``prove``).  Returns (segment proofs,
        final memory tree)."""
        self._require_persistent()
        if uniform_shapes and fixed_heights is None:
            fixed_heights = self.segment_height_profile(
                exe, inputs, max_insns_per_segment, segment_limits, native)
        proofs = []
        tree = self._segment_sweep(
            exe, inputs, max_insns_per_segment, segment_limits, native,
            self.prove, lambda proof, pre: proofs.append(proof), stages=stages,
            records=records, debug=debug, fixed_heights=fixed_heights)
        return proofs, tree

    def verify_segments(self, proofs, exe: VmExe, expected_exe_commit=None):
        """Chain checks across segment proofs (machine.py:745; reference
        verify_segments, arch/vm.rs:1107-1237): each segment's STARK
        validity, program-commit equality, pc chaining, memory-root
        chaining, suspend/terminate discipline.  Every check raises
        VerificationError.  Returns the final root."""
        if not proofs:
            raise VerificationError("no segment proofs")
        prev_conn = prev_mk = None
        init_root = [int(x) for x in self.commit_init_memory(exe)]
        for i, proof in enumerate(proofs):
            stark_verify(self.pk.vk, proof)
            _check([p.air_id for p in proof.per_air] == list(range(len(self.airs))),
                   "missing AIRs")
            if expected_exe_commit is not None:
                got = np.asarray(proof.commitments.main_trace[0], dtype=np.uint64)
                _check(np.array_equal(got, np.asarray(expected_exe_commit,
                                                      dtype=np.uint64)),
                       "program commitment mismatch")
            conn = proof.per_air[self.air_index["connector"]].public_values
            mk = proof.per_air[self.air_index["memory_merkle"]].public_values
            if i == 0:
                _check(conn[0] == exe.pc_start, "wrong entry pc")
                _check(list(mk[:8]) == init_root, "wrong initial memory root")
            else:
                _check(prev_conn[1] == conn[0], "pc chain broken")
                _check(list(prev_mk[8:]) == list(mk[:8]),
                       "memory root chain broken")
            if i == len(proofs) - 1:
                _check(conn[3] == 1, "final segment did not terminate")
                _check(conn[2] == 0, f"exit code {conn[2]}")
            else:
                _check(conn[3] == 0 and conn[2] == 42,
                       "non-final segment must suspend with exit code 42")
            prev_conn, prev_mk = conn, mk
        return {"final_root": list(prev_mk[8:]), "num_segments": len(proofs)}

    # -- verification ----------------------------------------------------
    def verify(self, proof, expected_exe_commit=None, exe: VmExe = None):
        """Verify a single (terminating) proof (machine.py:790-833).  In
        persistent mode pass ``exe`` so that the proof's initial memory
        root and entry pc are anchored to the executable."""
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
        result = {"initial_pc": conn.public_values[0],
                  "final_pc": conn.public_values[1]}
        if self.config.persistent:
            mk = proof.per_air[self.air_index["memory_merkle"]]
            if exe is not None:
                init_root = [int(x) for x in self.commit_init_memory(exe)]
                _check(list(mk.public_values[:8]) == init_root,
                       "wrong initial memory root")
            result["initial_root"] = mk.public_values[:8]
            result["final_root"] = mk.public_values[8:]
        else:
            pv_air = proof.per_air[self.air_index["public_values"]]
            result["public_values"] = pv_air.public_values
        return result

    def commit_init_memory(self, exe: VmExe) -> np.ndarray:
        """Initial-memory Merkle root (persistent mode, machine.py:834): the
        verifier-side anchor that a proof's initial_root must equal."""
        tree, _ = self._initial_tree(exe)
        return tree.root()
