"""Preflight (E3) execution: the record-generating interpreter, RV32IM,
int256, modular arithmetic, short-Weierstrass ECC, Fp2, the native
(recursion) VM, keccak256, sha256 and the pairing hint.

Copy of openvm_tpu/vm/preflight.py:45-510 (records, memory, the RV32IM
dispatch loop), :511-613 (the int256 handler), :614-697 (the modular
handler, taken only when the config has moduli, as the JAX package's
guard takes it), :698-778 (the EC_ADD_NE and EC_DOUBLE handler, taken only
for a configured curve, its record layouts and ExecutionErrors unchanged),
:779-843 (the Fp2 ADD/SUB/MUL/DIV handler, taken only for a configured
Fp2 modulus, its record layouts and ExecutionErrors unchanged), the
native VM's handlers over felt memory in address space 4 (felt arithmetic
:844-878, extension arithmetic :879-911, BEQ/BNE :912-934, loadstore and
loadstore4 with HINT_STOREW(4) :935-981, JAL and RANGE_CHECK :982-1004,
FRI_REDUCED_OPENING :1005-1053, VERIFY_BATCH :1054-1176, PERM_POS2 and
COMP_POS2 :1177-1198, their record layouts and ExecutionErrors
unchanged), :1199-1364 (the KECCAK256 and SHA256 handlers, their
record layouts unchanged), :1365-1476 (phantom with the native phantoms
HINT_INPUT, HINT_FELT, HINT_BITS and PRINT :1377-1400, the HintFinalExp
phantom :1401-1414, whose reads of guest registers and memory are peeks
without bus accesses, the HINT_NON_QR and HINT_SQRT phantoms
:1415-1430, terminate, finalize) and the continuation
half: ``PreflightResult.suspended_state`` and ``segment_full``,
``SegmentCtx`` (:46-70), ``PreflightMemory(initial_words=...)`` (:72-86),
the resume and ``py_stats`` logic of ``execute`` (:133-200), its
``max_insns`` suspend and metered boundary, and the suspended-state dicts
(:1440-1476).  With a
``native.NativeVmHandle`` the C++ core (csrc/host/preflight.cpp) runs the
RV32IM instruction runs and this loop dispatches what it yields on; the
native VM's felt memory lives here, so its programs run this loop alone
(``machine.VirtualMachine`` makes no handle for them).  A modular, ECC or
Fp2 opcode in a config without its modulus or curve, and an opcode no
family owns, end as in the JAX package, in an ExecutionError.

Timestamp discipline mirrors the AIRs exactly: each instruction starts at
`ts` and performs its accesses at fixed ticks (slot k at ts+k), advancing
`ts` by the chip's fixed access count whether or not gated accesses happen.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .circuit import buses as B
from .circuit.ecc import (EC_ADD_NE, EC_DOUBLE, SW_BASE, SW_KINDS,
                          _lambda_add, _lambda_double)
from .circuit.fp2 import ADD as F2ADD
from .circuit.fp2 import DIV as F2DIV
from .circuit.fp2 import FP2_BASE, FP2_KINDS
from .circuit.fp2 import MUL as F2MUL
from .circuit.fp2 import SUB as F2SUB
from .circuit.fp2 import fp2_div, fp2_mul
from .circuit.keccak import RATE_BYTES, TS_PER_BLOCK, W_WINDOW, keccak_f
from .circuit.sha256 import BLOCK_BYTES as SB
from .circuit.sha256 import BLOCK_WORDS as SW
from .circuit.sha256 import H0, sha_compress
from .circuit.sha256 import TS_PER_BLOCK as STS
from .circuit.sha256 import W_WINDOW as SWW
from .instructions import (BaseAlu256Opcode, BaseAluOpcode,
                           BranchEqual256Opcode, BranchEqualOpcode,
                           BranchLessThan256Opcode, BranchLessThanOpcode,
                           DivRemOpcode, FieldArithmeticOpcode,
                           FieldExtensionOpcode, FriOpcode, LessThan256Opcode,
                           LessThanOpcode, ModularPhantom, Mul256Opcode,
                           MulHOpcode, MulOpcode, NativeBranchEqOpcode,
                           NativeJalOpcode, NativeLoadStore4Opcode,
                           NativeLoadStoreOpcode, NativePhantom,
                           NativeRangeCheckOpcode, P, PairingPhantom,
                           Poseidon2Opcode, Rv32AuipcOpcode,
                           Rv32HintStoreOpcode, Rv32JalLuiOpcode,
                           Rv32JalrOpcode, Rv32KeccakOpcode,
                           Rv32LoadStoreOpcode, Rv32Phantom,
                           Rv32Sha256Opcode, Shift256Opcode, ShiftOpcode,
                           SystemOpcode, VerifyBatchOpcode, VmExe)
from .interpreter import ExecutionError, Streams, _imm16, _imm24, _s32
from .memory_tree import _host
from .native import PF_INSN_LIMIT, PF_MEM_ERROR, PF_SEGMENT_FULL
from ..field.babybear import ext_inv_int, ext_mul_int
from ..pairing.final_exp import hint_final_exp_bytes

M32 = 0xFFFFFFFF


@dataclass
class PreflightResult:
    records: dict  # chip name -> dict[column -> np array]
    touched: dict  # (as, wa) -> [b0..b3, last_ts] final states
    init_words: dict  # (as, wa) -> [b0..b3] initial data
    exec_counts: dict  # pc index -> count
    final_pc: int = 0
    final_ts: int = 0
    exit_code: int = 0
    instret: int = 0
    public_values: list = None  # 4*num_pv_words bytes
    suspended_state: dict = None  # set when max_insns hit (segment suspend)
    segment_full: bool = False  # suspend cause was a metered limit
    # persistent memory: the SparseMemoryTree after this segment's writes
    # (set by VirtualMachine's persistent tracegen)
    final_memory_tree: object = None
    # the host seconds of each HintFinalExp phantom, in execution order
    hint_s: list = field(default_factory=list)
    # the native handlers' host Poseidon2 permutations (PERM_POS2,
    # COMP_POS2, VERIFY_BATCH): how many, and their host seconds
    host_perms: int = 0
    host_perm_s: float = 0.0


@dataclass
class SegmentCtx:
    """Python-side extension-chip accounting for metered segmentation.

    Mirrors the reference's SegmentationCtx widths/interactions vectors
    (crates/vm/src/arch/execution_mode/metered/segment_ctx.rs:40-67): the
    C++ core owns the RV32IM chips' accounting; these dicts cover the
    chips whose records are produced by the Python dispatch loop."""
    widths: dict = field(default_factory=dict)   # chip -> trace width
    inters: dict = field(default_factory=dict)   # chip -> msgs per row


class PreflightMemory:
    """Word-granular memory with last-access timestamps."""

    def __init__(self, init_memory: dict, initial_words: dict | None = None):
        self.words: dict = {}
        self.init_words: dict = {}
        if initial_words is not None:
            # continuation segment: start from carried word state
            self._image = {k: list(v) for k, v in initial_words.items()}
            return
        # group byte image into words
        grouped = defaultdict(lambda: [0, 0, 0, 0])
        for (a_s, addr), byte in init_memory.items():
            grouped[(a_s, addr // 4)][addr % 4] = byte
        self._image = dict(grouped)

    def _get(self, key):
        if key not in self.words:
            data = list(self._image.get(key, [0, 0, 0, 0]))
            self.words[key] = data + [0]  # ts 0
            self.init_words[key] = list(data)
        return self.words[key]

    def read(self, a_s, wa, now_ts):
        w = self._get((a_s, wa))
        data = w[:4]
        prev_ts = w[4]
        w[4] = now_ts
        return data, prev_ts

    def write(self, a_s, wa, new_data, now_ts):
        w = self._get((a_s, wa))
        prev = w[:4]
        prev_ts = w[4]
        w[:4] = list(new_data)
        w[4] = now_ts
        return prev, prev_ts

    def peek(self, a_s, wa):
        """Current word value without a timestamped access (used to build
        read-modify-write window words for unaligned digest stores)."""
        return list(self._get((a_s, wa))[:4])

    def read_block(self, a_s, wa, n, ts0):
        """``read`` of the n words from wa at timestamps ts0, ts0 + 1, ...:
        (their 4n bytes, their previous timestamps)."""
        data, pts = [], []
        for k in range(n):
            d, p = self.read(a_s, wa + k, ts0 + k)
            data.extend(d)
            pts.append(p)
        return data, pts

    def write_block(self, a_s, wa, data, ts0):
        """``write`` of len(data) / 4 words from wa at timestamps ts0,
        ts0 + 1, ...: (the bytes they held, their previous timestamps)."""
        prev, pts = [], []
        for k in range(len(data) // 4):
            d, p = self.write(a_s, wa + k, data[4 * k:4 * k + 4], ts0 + k)
            prev.extend(d)
            pts.append(p)
        return prev, pts


def _u32_limbs(v):
    return [(v >> (8 * i)) & 0xFF for i in range(4)]


def _from_limbs(limbs):
    return limbs[0] | (limbs[1] << 8) | (limbs[2] << 16) | (limbs[3] << 24)


class PreflightInterpreter:
    def __init__(self, exe: VmExe, num_pv_words: int = 8, moduli=(),
                 curves=(), fp2=()):
        self.exe = exe
        self.num_pv_words = num_pv_words
        self.moduli = tuple(moduli)
        self.curves = tuple(curves)
        self.fp2 = tuple(fp2)

    def execute(self, inputs=None, max_insns: int | None = None,
                state: dict | None = None, nvm=None,
                seg_ctx: SegmentCtx | None = None) -> PreflightResult:
        """state (continuation segments): {"pc", "memory_words", "streams"}.

        When `max_insns` is reached the run SUSPENDS (reference exit code
        42 convention): exit_code stays None and the result carries the
        resumable state in `.suspended_state`.

        nvm (hybrid mode): a native.NativeVmHandle.  RV32IM instruction
        runs execute in C++ on the handle's memory/records; this loop only
        dispatches the opcodes the core yields on (extensions, phantom,
        hints, terminate).  Word memory lives in the handle (shared via
        the shim), so state dicts carry no memory_words.

        seg_ctx (metered segmentation): trace widths/interactions for the
        Python-side chips; combined with the handle's own accounting in the
        reference's should_segment check (segment_ctx.rs:135-217).  On a
        boundary the run suspends with `segment_full` set.
        """
        exe = self.exe
        if nvm is not None:
            mem = nvm.shim
            if state is not None:
                streams = state["streams"]
                pc = state["pc"]
            else:
                streams = Streams()
                if inputs:
                    streams.input_stream = [list(x) for x in inputs]
                pc = exe.pc_start
        elif state is not None:
            mem = PreflightMemory({}, initial_words=state["memory_words"])
            streams = state["streams"]
            pc = state["pc"]
        else:
            mem = PreflightMemory(exe.init_memory)
            streams = Streams()
            if inputs:
                streams.input_stream = [list(x) for x in inputs]
            pc = exe.pc_start
        recs: dict = defaultdict(lambda: defaultdict(list))
        exec_counts: dict = defaultdict(int)
        hint_s: list = []
        perm_stats = [0, 0.0]  # host permutations: count, seconds
        ts = B.INITIAL_TIMESTAMP
        pc_base, step = exe.program.pc_base, exe.program.step
        instret = 0
        exit_code = None

        def reg_read(idx, tick):
            data, pts = mem.read(1, idx, ts + tick)
            return data, pts

        def host_permute(st16):
            t_ = time.perf_counter()
            out_ = [int(x) for x in _host().permute(
                np.asarray(st16, dtype=np.uint64))]
            perm_stats[0] += 1
            perm_stats[1] += time.perf_counter() - t_
            return out_

        def py_stats():
            if seg_ctx is None:
                return 0, 0, 0
            cells = inters = maxh = 0
            for chip, cols in recs.items():
                n = len(next(iter(cols.values())))
                cells += n * seg_ctx.widths.get(chip, 0)
                inters += (n + 1) * seg_ctx.inters.get(chip, 0)
                maxh = max(maxh, n)
            return cells, inters, maxh

        suspended = False
        segment_full = False
        while exit_code is None:
            if max_insns is not None and instret >= max_insns:
                suspended = True  # segment boundary (reference exit code 42)
                break
            if nvm is not None:
                cells, inters, maxh = py_stats()
                r = nvm.run(pc, ts, instret, max_insns or 0, cells, inters,
                            maxh)
                pc, ts, instret = int(r.pc), int(r.ts), int(r.instret)
                if r.status == PF_INSN_LIMIT:
                    suspended = True
                    break
                if r.status == PF_SEGMENT_FULL:
                    suspended = segment_full = True
                    break
                if r.status == PF_MEM_ERROR:
                    raise ExecutionError("memory access out of bounds")
                # PF_YIELD: dispatch the instruction at pc below, then
                # re-enter the native core
            idx = (pc - pc_base) // step
            insn = exe.program.get(pc)
            if insn is None:
                raise ExecutionError(f"pc out of bounds {pc:#x}")
            op = insn.opcode
            if op == SystemOpcode.TERMINATE:
                # halting: the terminate pc is never fetched/executed as a
                # row; the connector receives the final (pc, ts) here.
                exit_code = insn.c
                break
            exec_counts[idx] += 1
            a, b, c, d, e, f, g = insn.operands()
            instret += 1

            if BaseAluOpcode.ADD <= op <= BaseAluOpcode.AND:
                r = recs["rv32_base_alu"]
                is_imm = int(e == 0)
                rs1, p1 = reg_read(b // 4, 0)
                if is_imm:
                    imm = _imm24(c)
                    rs2, p2 = _u32_limbs(imm), 0
                else:
                    rs2, p2 = reg_read(c // 4, 1)
                x, y = _from_limbs(rs1), _from_limbs(rs2)
                oi = op - BaseAluOpcode.ADD
                val = [(x + y) & M32, (x - y) & M32, x ^ y, x | y, x & y][oi]
                rd = _u32_limbs(val)
                prevw, pw = mem.write(1, a // 4, rd, ts + 2)
                _append(r, pc=pc, ts=ts, op_idx=oi, is_imm=is_imm,
                        a=a // 4, b=b // 4, c=(c if is_imm else c // 4),
                        rs1=rs1, rs2=rs2, rd=rd, p_ts1=p1, p_ts2=p2,
                        p_tsw=pw, prevw=prevw)
                pc, ts = pc + 4, ts + 3

            elif ShiftOpcode.SLL <= op <= ShiftOpcode.SRA:
                r = recs["rv32_shift"]
                is_imm = int(e == 0)
                rs1, p1 = reg_read(b // 4, 0)
                if is_imm:
                    rs2, p2 = [c & 31, 0, 0, 0], 0
                else:
                    rs2, p2 = reg_read(c // 4, 1)
                x = _from_limbs(rs1)
                s = rs2[0] & 31
                oi = op - ShiftOpcode.SLL
                if oi == 0:
                    val = (x << s) & M32
                elif oi == 1:
                    val = x >> s
                else:
                    val = (_s32(x) >> s) & M32
                rd = _u32_limbs(val)
                prevw, pw = mem.write(1, a // 4, rd, ts + 2)
                _append(r, pc=pc, ts=ts, op_idx=oi, is_imm=is_imm,
                        a=a // 4, b=b // 4, c=(c if is_imm else c // 4),
                        rs1=rs1, rs2=rs2, rd=rd, p_ts1=p1, p_ts2=p2,
                        p_tsw=pw, prevw=prevw)
                pc, ts = pc + 4, ts + 3

            elif (op == MulOpcode.MUL
                  or MulHOpcode.MULH <= op <= MulHOpcode.MULHU):
                r = recs["rv32_mul"]
                rs1, p1 = reg_read(b // 4, 0)
                rs2, p2 = reg_read(c // 4, 1)
                x, y = _from_limbs(rs1), _from_limbs(rs2)
                if op == MulOpcode.MUL:
                    oi, val = 0, (x * y) & M32
                elif op == MulHOpcode.MULH:
                    oi, val = 1, ((_s32(x) * _s32(y)) >> 32) & M32
                elif op == MulHOpcode.MULHSU:
                    oi, val = 2, ((_s32(x) * y) >> 32) & M32
                else:
                    oi, val = 3, ((x * y) >> 32) & M32
                rd = _u32_limbs(val)
                prevw, pw = mem.write(1, a // 4, rd, ts + 2)
                _append(r, pc=pc, ts=ts, op_idx=oi, a=a // 4, b=b // 4,
                        c=c // 4, rs1=rs1, rs2=rs2, rd=rd, p_ts1=p1,
                        p_ts2=p2, p_tsw=pw, prevw=prevw)
                pc, ts = pc + 4, ts + 3

            elif DivRemOpcode.DIV <= op <= DivRemOpcode.REMU:
                rdict = recs["rv32_div_rem"]
                rs1, p1 = reg_read(b // 4, 0)
                rs2, p2 = reg_read(c // 4, 1)
                x, y = _from_limbs(rs1), _from_limbs(rs2)
                oi = op - DivRemOpcode.DIV
                signed = oi in (0, 2)
                if y == 0:
                    qv, rv = M32, x
                elif signed and x == 0x80000000 and y == M32:
                    qv, rv = 0x80000000, 0
                elif signed:
                    sx_, sy_ = _s32(x), _s32(y)
                    qv = abs(sx_) // abs(sy_)
                    if (sx_ < 0) != (sy_ < 0):
                        qv = -qv
                    rv = (sx_ - qv * sy_) & M32
                    qv &= M32
                else:
                    qv, rv = x // y, x % y
                val = qv if oi in (0, 1) else rv
                rd = _u32_limbs(val)
                prevw, pw = mem.write(1, a // 4, rd, ts + 2)
                _append(rdict, pc=pc, ts=ts, op_idx=oi, a=a // 4, b=b // 4,
                        c=c // 4, rs1=rs1, rs2=rs2, q=_u32_limbs(qv),
                        r=_u32_limbs(rv), p_ts1=p1, p_ts2=p2, p_tsw=pw,
                        prevw=prevw)
                pc, ts = pc + 4, ts + 3

            elif op in (LessThanOpcode.SLT, LessThanOpcode.SLTU):
                r = recs["rv32_less_than"]
                is_imm = int(e == 0)
                rs1, p1 = reg_read(b // 4, 0)
                if is_imm:
                    rs2, p2 = _u32_limbs(_imm24(c)), 0
                else:
                    rs2, p2 = reg_read(c // 4, 1)
                x, y = _from_limbs(rs1), _from_limbs(rs2)
                if op == LessThanOpcode.SLT:
                    lt = int(_s32(x) < _s32(y))
                else:
                    lt = int(x < y)
                prevw, pw = mem.write(1, a // 4, [lt, 0, 0, 0], ts + 2)
                _append(r, pc=pc, ts=ts, op_idx=op - LessThanOpcode.SLT,
                        is_imm=is_imm, a=a // 4, b=b // 4,
                        c=(c if is_imm else c // 4), rs1=rs1, rs2=rs2,
                        p_ts1=p1, p_ts2=p2, p_tsw=pw, prevw=prevw)
                pc, ts = pc + 4, ts + 3

            elif op in (BranchEqualOpcode.BEQ, BranchEqualOpcode.BNE):
                r = recs["rv32_branch_eq"]
                rs1, p1 = reg_read(a // 4, 0)
                rs2, p2 = reg_read(b // 4, 1)
                eq = rs1 == rs2
                taken = eq if op == BranchEqualOpcode.BEQ else not eq
                off = c if c <= P // 2 else c - P
                to_pc = (pc + off) if taken else pc + 4
                _append(r, pc=pc, ts=ts, op_idx=op - BranchEqualOpcode.BEQ,
                        a=a // 4, b=b // 4, imm=c, rs1=rs1, rs2=rs2,
                        to_pc=to_pc, p_ts1=p1, p_ts2=p2)
                pc, ts = to_pc, ts + 2

            elif (BranchLessThanOpcode.BLT <= op
                  <= BranchLessThanOpcode.BGEU):
                r = recs["rv32_branch_lt"]
                rs1, p1 = reg_read(a // 4, 0)
                rs2, p2 = reg_read(b // 4, 1)
                x, y = _from_limbs(rs1), _from_limbs(rs2)
                oi = op - BranchLessThanOpcode.BLT
                signed = oi in (0, 2)
                lt = (_s32(x) < _s32(y)) if signed else (x < y)
                taken = lt if oi in (0, 1) else not lt
                off = c if c <= P // 2 else c - P
                to_pc = (pc + off) if taken else pc + 4
                _append(r, pc=pc, ts=ts, op_idx=oi, a=a // 4, b=b // 4,
                        imm=c, rs1=rs1, rs2=rs2, to_pc=to_pc, p_ts1=p1,
                        p_ts2=p2)
                pc, ts = to_pc, ts + 2

            elif op in (Rv32JalLuiOpcode.JAL, Rv32JalLuiOpcode.LUI):
                r = recs["rv32_jal_lui"]
                is_jal = op == Rv32JalLuiOpcode.JAL
                nw = int(f != 0)
                if is_jal:
                    rd_val = (pc + 4) & M32
                    off = c if c <= P // 2 else c - P
                    to_pc = (pc + off) & M32
                else:
                    rd_val = (c << 12) & M32
                    to_pc = pc + 4
                rd = _u32_limbs(rd_val) if nw else [0, 0, 0, 0]
                if nw:
                    prevw, pw = mem.write(1, a // 4, rd, ts)
                else:
                    prevw, pw = [0, 0, 0, 0], 0
                _append(r, pc=pc, ts=ts, op_idx=0 if is_jal else 1,
                        a=a // 4, imm=c, needs_write=nw, rd=rd, to_pc=to_pc,
                        p_tsw=pw, prevw=prevw)
                pc, ts = to_pc, ts + 1

            elif op == Rv32JalrOpcode.JALR:
                r = recs["rv32_jalr"]
                nw = int(f != 0)
                rs1, p1 = reg_read(b // 4, 0)
                target = (_from_limbs(rs1) + _imm16(c, g)) & M32
                lsb = target & 1
                to_pc = target & ~1
                rd_val = (pc + 4) & M32
                rd = _u32_limbs(rd_val) if nw else [0, 0, 0, 0]
                if nw:
                    prevw, pw = mem.write(1, a // 4, rd, ts + 1)
                else:
                    prevw, pw = [0, 0, 0, 0], 0
                _append(r, pc=pc, ts=ts, a=a // 4, b=b // 4, c=c, g=g,
                        needs_write=nw, rs1=rs1, rd=rd, to_pc=to_pc,
                        lsb=lsb, p_ts1=p1, p_tsw=pw, prevw=prevw)
                pc, ts = to_pc, ts + 2

            elif op == Rv32AuipcOpcode.AUIPC:
                r = recs["rv32_auipc"]
                rd_val = (pc + (c << 8)) & M32
                rd = _u32_limbs(rd_val)
                prevw, pw = mem.write(1, a // 4, rd, ts)
                _append(r, pc=pc, ts=ts, a=a // 4, imm=c, rd=rd, p_tsw=pw,
                        prevw=prevw)
                pc, ts = pc + 4, ts + 1

            elif (Rv32LoadStoreOpcode.LOADW <= op
                  <= Rv32LoadStoreOpcode.LOADH):
                r = recs["rv32_load_store"]
                oi = op - Rv32LoadStoreOpcode.LOADW
                is_load = oi < 3 or oi > 5
                nw = int(f != 0)
                rs1, p1 = reg_read(b // 4, 0)
                full = (_from_limbs(rs1) + _imm16(c, g)) & M32
                wa, shift = full >> 2, full & 3
                if is_load:
                    if e != 2:
                        raise ExecutionError("load from non-mem space")
                    data2, p2 = mem.read(2, wa, ts + 1)
                    if op == Rv32LoadStoreOpcode.LOADW:
                        new3 = list(data2)
                    elif op == Rv32LoadStoreOpcode.LOADBU:
                        new3 = [data2[shift], 0, 0, 0]
                    elif op == Rv32LoadStoreOpcode.LOADHU:
                        new3 = [data2[shift], data2[shift + 1], 0, 0]
                    elif op == Rv32LoadStoreOpcode.LOADB:
                        fill = 255 if data2[shift] >= 128 else 0
                        new3 = [data2[shift], fill, fill, fill]
                    else:  # LOADH
                        fill = 255 if data2[shift + 1] >= 128 else 0
                        new3 = [data2[shift], data2[shift + 1], fill, fill]
                    if nw:
                        prevw, pw = mem.write(1, a // 4, new3, ts + 2)
                    else:
                        prevw, pw = [0, 0, 0, 0], 0
                else:
                    if e not in (2, 3):
                        raise ExecutionError(f"store to space {e}")
                    data2, p2 = mem.read(1, a // 4, ts + 1)
                    prevw_cur = mem._get((e, wa))[:4]
                    if op == Rv32LoadStoreOpcode.STOREW:
                        new3 = list(data2)
                    elif op == Rv32LoadStoreOpcode.STOREH:
                        new3 = list(prevw_cur)
                        new3[shift] = data2[0]
                        new3[shift + 1] = data2[1]
                    else:  # STOREB
                        new3 = list(prevw_cur)
                        new3[shift] = data2[0]
                    prevw, pw = mem.write(e, wa, new3, ts + 2)
                    if e == 3 and wa >= self.num_pv_words:
                        raise ExecutionError("reveal index out of range")
                _append(r, pc=pc, ts=ts, op_idx=oi, a=a // 4, b=b // 4, c=c,
                        g=g, e_as=e, needs_write=nw, rs1=rs1, word_addr=wa,
                        s0=shift & 1, s1=shift >> 1, data2=data2, new3=new3,
                        p_ts1=p1, p_ts2=p2, p_tsw=pw, prevw=prevw)
                pc, ts = pc + 4, ts + 3

            elif op in (Rv32HintStoreOpcode.HINT_STOREW,
                        Rv32HintStoreOpcode.HINT_BUFFER):
                r = recs["rv32_hint_store"]
                is_buf = int(op == Rv32HintStoreOpcode.HINT_BUFFER)
                rs_ptr, p1 = reg_read(b // 4, 0)
                if is_buf:
                    rs_len, p2 = reg_read(a // 4, 1)
                    num_words = _from_limbs(rs_len)
                else:
                    rs_len, p2 = [0, 0, 0, 0], 0
                    num_words = 1
                mem_ptr = _from_limbs(rs_ptr)
                if mem_ptr % 4 != 0:
                    raise ExecutionError("unaligned hint pointer")
                if num_words == 0:
                    raise ExecutionError("hint buffer of zero words")
                hs = streams.hint_stream
                if len(hs) < 4 * num_words:
                    raise ExecutionError("hint stream underflow")
                for k in range(num_words):
                    data = hs[4 * k:4 * k + 4]
                    prevw, pw = mem.write(2, mem_ptr // 4 + k, data,
                                          ts + 2 + k)
                    _append(r, pc=pc, ts0=ts, is_start=int(k == 0),
                            is_buffer=is_buf, a=a // 4, b=b // 4,
                            rem=num_words - k, ptr=mem_ptr // 4 + k,
                            ts_w=ts + 2 + k, rs_ptr=rs_ptr, rs_len=rs_len,
                            data=data, p_ts1=p1, p_ts2=p2, p_tsw=pw,
                            prevw=prevw)
                del hs[:4 * num_words]
                pc, ts = pc + 4, ts + 2 + num_words

            elif ((BaseAlu256Opcode.ADD <= op <= LessThan256Opcode.SLTU)
                  or op == Mul256Opcode.MUL
                  or (BranchEqual256Opcode.BEQ <= op
                      <= BranchLessThan256Opcode.BGEU)):
                is_branch = (BranchEqual256Opcode.BEQ <= op
                             <= BranchLessThan256Opcode.BGEU)

                def ptr_of(limbs):
                    p = _from_limbs(limbs)
                    if p % 4 != 0 or p >= (1 << 29):
                        raise ExecutionError(
                            f"bad int256 pointer {p:#x} at pc {pc:#x}")
                    return p // 4

                if is_branch:
                    rs1p, p1 = reg_read(a // 4, 0)
                    rs2p, p2 = reg_read(b // 4, 1)
                    x, pts_x = mem.read_block(2, ptr_of(rs1p), 8, ts + 2)
                    y, pts_y = mem.read_block(2, ptr_of(rs2p), 8, ts + 10)
                    xi = sum(v_ << (8 * i) for i, v_ in enumerate(x))
                    yi = sum(v_ << (8 * i) for i, v_ in enumerate(y))
                    off = c if c <= P // 2 else c - P
                    if op <= BranchEqual256Opcode.BNE:
                        chip = "int256_beq"
                        oi = op - BranchEqual256Opcode.BEQ
                        taken = (xi == yi) if oi == 0 else (xi != yi)
                    else:
                        chip = "int256_blt"
                        oi = op - BranchLessThan256Opcode.BLT
                        if oi in (0, 2):  # signed
                            sxi = xi - (1 << 256) if x[31] >= 128 else xi
                            syi = yi - (1 << 256) if y[31] >= 128 else yi
                            lt = sxi < syi
                        else:
                            lt = xi < yi
                        taken = lt if oi in (0, 1) else not lt
                    to_pc = (pc + off) if taken else pc + 4
                    _append(recs[chip], pc=pc, ts=ts, op_idx=oi, a=a // 4,
                            b=b // 4, c=c, rs1p=rs1p, rs2p=rs2p, x=x, y=y,
                            pts_r1=p1, pts_r2=p2, pts_x=pts_x, pts_y=pts_y,
                            to_pc=to_pc)
                    pc, ts = to_pc, ts + 18
                else:
                    rs1p, p1 = reg_read(b // 4, 0)
                    rs2p, p2 = reg_read(c // 4, 1)
                    rdp, p3 = reg_read(a // 4, 2)
                    x, pts_x = mem.read_block(2, ptr_of(rs1p), 8, ts + 3)
                    y, pts_y = mem.read_block(2, ptr_of(rs2p), 8, ts + 11)
                    xi = sum(v_ << (8 * i) for i, v_ in enumerate(x))
                    yi = sum(v_ << (8 * i) for i, v_ in enumerate(y))
                    M = (1 << 256) - 1
                    if op <= BaseAlu256Opcode.AND:
                        chip = "int256_alu"
                        oi = op - BaseAlu256Opcode.ADD
                        zi = [(xi + yi) & M, (xi - yi) & M, xi ^ yi,
                              xi | yi, xi & yi][oi]
                    elif op <= Shift256Opcode.SRA:
                        chip = "int256_shift"
                        oi = op - Shift256Opcode.SLL
                        s = y[0]
                        if oi == 0:
                            zi = (xi << s) & M
                        elif oi == 1:
                            zi = xi >> s
                        else:
                            sxi = xi - (1 << 256) if x[31] >= 128 else xi
                            zi = (sxi >> s) & M
                    elif op <= LessThan256Opcode.SLTU:
                        chip = "int256_lt"
                        oi = op - LessThan256Opcode.SLT
                        if oi == 0:
                            sxi = xi - (1 << 256) if x[31] >= 128 else xi
                            syi = yi - (1 << 256) if y[31] >= 128 else yi
                            zi = int(sxi < syi)
                        else:
                            zi = int(xi < yi)
                    else:
                        chip = "int256_mul"
                        oi = 0
                        zi = (xi * yi) & M
                    z = [(zi >> (8 * i)) & 255 for i in range(32)]
                    prevz, pts_z = mem.write_block(2, ptr_of(rdp), z, ts + 19)
                    _append(recs[chip], pc=pc, ts=ts, op_idx=oi, a=a // 4,
                            b=b // 4, c=c // 4, rs1p=rs1p, rs2p=rs2p,
                            rdp=rdp, x=x, y=y, z=z, prevz=prevz,
                            pts_r1=p1, pts_r2=p2, pts_rd=p3, pts_x=pts_x,
                            pts_y=pts_y, pts_z=pts_z)
                    pc, ts = pc + 4, ts + 27

            elif 0x500 <= op < 0x500 + 8 * max(len(self.moduli), 1) \
                    and self.moduli:
                from .circuit.modular import (ADD, DIV, IS_EQ, MOD_KINDS,
                                              MODULAR_BASE, MUL, SUB)
                mod_idx = (op - MODULAR_BASE) // MOD_KINDS
                base = (op - MODULAR_BASE) % MOD_KINDS
                if mod_idx >= len(self.moduli):
                    raise ExecutionError(
                        f"modulus index {mod_idx} not configured")
                Nmod = self.moduli[mod_idx]

                def ptr_of(limbs):
                    p_ = _from_limbs(limbs)
                    if p_ % 4 != 0 or p_ >= (1 << 29):
                        raise ExecutionError(
                            f"bad modular pointer {p_:#x} at pc {pc:#x}")
                    return p_ // 4

                if base == IS_EQ:
                    rs1p, p1 = reg_read(b // 4, 0)
                    rs2p, p2 = reg_read(c // 4, 1)
                    x, pts_x = mem.read_block(2, ptr_of(rs1p), 8, ts + 2)
                    y, pts_y = mem.read_block(2, ptr_of(rs2p), 8, ts + 10)
                    xi = sum(v_ << (8 * i) for i, v_ in enumerate(x))
                    yi = sum(v_ << (8 * i) for i, v_ in enumerate(y))
                    if xi >= Nmod or yi >= Nmod:
                        raise ExecutionError("is_eq input not reduced")
                    res = int(xi == yi)
                    prevrd, prd = mem.write(1, a // 4, [res, 0, 0, 0],
                                            ts + 18)
                    _append(recs[f"modular_iseq_{mod_idx}"], pc=pc, ts=ts,
                            a=a // 4, b=b // 4, c=c // 4, rs1p=rs1p,
                            rs2p=rs2p, x=x, y=y, pts_r1=p1, pts_r2=p2,
                            pts_x=pts_x, pts_y=pts_y, pts_rd=prd,
                            prevrd=prevrd)
                    pc, ts = pc + 4, ts + 19
                elif base in (ADD, SUB, MUL, DIV):
                    rs1p, p1 = reg_read(b // 4, 0)
                    rs2p, p2 = reg_read(c // 4, 1)
                    rdp, p3 = reg_read(a // 4, 2)
                    x, pts_x = mem.read_block(2, ptr_of(rs1p), 8, ts + 3)
                    y, pts_y = mem.read_block(2, ptr_of(rs2p), 8, ts + 11)
                    xi = sum(v_ << (8 * i) for i, v_ in enumerate(x))
                    yi = sum(v_ << (8 * i) for i, v_ in enumerate(y))
                    if base == ADD:
                        chip, oi = f"modular_addsub_{mod_idx}", 0
                        zi = (xi + yi) % Nmod
                    elif base == SUB:
                        chip, oi = f"modular_addsub_{mod_idx}", 1
                        zi = (xi - yi) % Nmod
                    elif base == MUL:
                        chip, oi = f"modular_muldiv_{mod_idx}", 0
                        zi = (xi * yi) % Nmod
                    else:
                        chip, oi = f"modular_muldiv_{mod_idx}", 1
                        if yi % Nmod == 0:
                            raise ExecutionError("modular division by zero")
                        zi = (xi * pow(yi, -1, Nmod)) % Nmod
                    z = [(zi >> (8 * i)) & 255 for i in range(32)]
                    prevz, pts_z = mem.write_block(2, ptr_of(rdp), z, ts + 19)
                    _append(recs[chip], pc=pc, ts=ts, op_idx=oi, a=a // 4,
                            b=b // 4, c=c // 4, rs1p=rs1p, rs2p=rs2p,
                            rdp=rdp, x=x, y=y, z=z, prevz=prevz,
                            pts_r1=p1, pts_r2=p2, pts_rd=p3, pts_x=pts_x,
                            pts_y=pts_y, pts_z=pts_z)
                    pc, ts = pc + 4, ts + 27
                else:
                    raise ExecutionError(
                        f"modular opcode base {base} unsupported")

            elif 0x600 <= op < 0x600 + 4 * len(self.curves):
                curve_idx = (op - SW_BASE) // SW_KINDS
                base = (op - SW_BASE) % SW_KINDS
                pmod, acoef = self.curves[curve_idx]

                def ptr_of(limbs):
                    p_ = _from_limbs(limbs)
                    if p_ % 4 != 0 or p_ >= (1 << 29):
                        raise ExecutionError(
                            f"bad ec pointer {p_:#x} at pc {pc:#x}")
                    return p_ // 4

                def to_int(limbs):
                    return sum(v_ << (8 * i) for i, v_ in enumerate(limbs))

                if base == EC_ADD_NE:
                    rs1p, p1 = reg_read(b // 4, 0)
                    rs2p, p2 = reg_read(c // 4, 1)
                    rdp, p3 = reg_read(a // 4, 2)
                    xb, pts_x = mem.read_block(2, ptr_of(rs1p), 16, ts + 3)
                    yb, pts_y = mem.read_block(2, ptr_of(rs2p), 16, ts + 19)
                    x1, y1 = to_int(xb[:32]), to_int(xb[32:])
                    x2, y2 = to_int(yb[:32]), to_int(yb[32:])
                    if (x1 - x2) % pmod == 0:
                        raise ExecutionError("EC_ADD_NE with equal x")
                    lam = _lambda_add(pmod, x1, y1, x2, y2)
                    x3 = (lam * lam - x1 - x2) % pmod
                    y3 = (lam * (x1 - x3) - y1) % pmod
                    z = [(x3 >> (8 * i)) & 255 for i in range(32)] + \
                        [(y3 >> (8 * i)) & 255 for i in range(32)]
                    prevz, pts_z = mem.write_block(2, ptr_of(rdp), z, ts + 35)
                    _append(recs[f"sw_add_ne_{curve_idx}"], pc=pc, ts=ts,
                            a=a // 4, b=b // 4, c=c // 4, rs1p=rs1p,
                            rs2p=rs2p, rdp=rdp, x=xb, y=yb, z=z,
                            prevz=prevz, pts_r1=p1, pts_r2=p2, pts_rd=p3,
                            pts_x=pts_x, pts_y=pts_y, pts_z=pts_z)
                    pc, ts = pc + 4, ts + 51
                elif base == EC_DOUBLE:
                    rs1p, p1 = reg_read(b // 4, 0)
                    rdp, p3 = reg_read(a // 4, 1)
                    xb, pts_x = mem.read_block(2, ptr_of(rs1p), 16, ts + 2)
                    x1, y1 = to_int(xb[:32]), to_int(xb[32:])
                    if y1 % pmod == 0:
                        raise ExecutionError("EC_DOUBLE of 2-torsion point")
                    lam = _lambda_double(pmod, acoef, x1, y1)
                    x3 = (lam * lam - 2 * x1) % pmod
                    y3 = (lam * (x1 - x3) - y1) % pmod
                    z = [(x3 >> (8 * i)) & 255 for i in range(32)] + \
                        [(y3 >> (8 * i)) & 255 for i in range(32)]
                    prevz, pts_z = mem.write_block(2, ptr_of(rdp), z, ts + 18)
                    _append(recs[f"sw_double_{curve_idx}"], pc=pc, ts=ts,
                            a=a // 4, b=b // 4, rs1p=rs1p, rdp=rdp, x=xb,
                            z=z, prevz=prevz, pts_r1=p1, pts_rd=p3,
                            pts_x=pts_x, pts_z=pts_z)
                    pc, ts = pc + 4, ts + 34
                else:
                    raise ExecutionError(f"ec opcode base {base} is setup")

            elif FP2_BASE <= op < FP2_BASE + FP2_KINDS * len(self.fp2):
                fp2_idx = (op - FP2_BASE) // FP2_KINDS
                base = (op - FP2_BASE) % FP2_KINDS
                pmod = self.fp2[fp2_idx]

                def ptr_of(limbs):
                    p_ = _from_limbs(limbs)
                    if p_ % 4 != 0 or p_ >= (1 << 29):
                        raise ExecutionError(
                            f"bad fp2 pointer {p_:#x} at pc {pc:#x}")
                    return p_ // 4

                def to_int(limbs):
                    return int.from_bytes(bytes(limbs), "little")

                if base not in (F2ADD, F2SUB, F2MUL, F2DIV):
                    raise ExecutionError(f"fp2 opcode base {base} is setup")
                rs1p, p1 = reg_read(b // 4, 0)
                rs2p, p2 = reg_read(c // 4, 1)
                rdp, p3 = reg_read(a // 4, 2)
                # each operand's 16 words in one call (JAX's read_pair)
                xb, pts_x = mem.read_block(2, ptr_of(rs1p), 16, ts + 3)
                yb, pts_y = mem.read_block(2, ptr_of(rs2p), 16, ts + 19)
                a0, a1 = to_int(xb[:32]) % pmod, to_int(xb[32:]) % pmod
                b0, b1 = to_int(yb[:32]) % pmod, to_int(yb[32:]) % pmod
                if base == F2ADD:
                    chip, oi = f"fp2_addsub_{fp2_idx}", 0
                    z0, z1 = (a0 + b0) % pmod, (a1 + b1) % pmod
                elif base == F2SUB:
                    chip, oi = f"fp2_addsub_{fp2_idx}", 1
                    z0, z1 = (a0 - b0) % pmod, (a1 - b1) % pmod
                elif base == F2MUL:
                    chip, oi = f"fp2_muldiv_{fp2_idx}", 0
                    z0, z1 = fp2_mul(pmod, a0, a1, b0, b1)
                else:
                    chip, oi = f"fp2_muldiv_{fp2_idx}", 1
                    try:
                        z0, z1 = fp2_div(pmod, a0, a1, b0, b1)
                    except ZeroDivisionError:
                        raise ExecutionError("fp2 division by zero")
                z = list(z0.to_bytes(32, "little") + z1.to_bytes(32, "little"))
                prevz, pts_z = mem.write_block(2, ptr_of(rdp), z, ts + 35)
                _append(recs[chip], pc=pc, ts=ts, op_idx=oi, a=a // 4,
                        b=b // 4, c=c // 4, rs1p=rs1p, rs2p=rs2p, rdp=rdp,
                        x=xb, y=yb, z=z, prevz=prevz, pts_r1=p1, pts_r2=p2,
                        pts_rd=p3, pts_x=pts_x, pts_y=pts_y, pts_z=pts_z)
                pc, ts = pc + 4, ts + 51


            elif (FieldArithmeticOpcode.ADD <= op
                  <= FieldArithmeticOpcode.DIV):
                # native felt arithmetic (reference field_arithmetic/)
                r = recs["native_field_arithmetic"]
                oi = op - FieldArithmeticOpcode.ADD
                b_imm, c_imm = int(e == 0), int(f == 0)
                if b_imm:
                    bv, p1 = b, 0
                else:
                    w, p1 = mem.read(4, b, ts)
                    bv = w[0]
                if c_imm:
                    cv, p2 = c, 0
                else:
                    w, p2 = mem.read(4, c, ts + 1)
                    cv = w[0]
                if oi == 0:
                    res = (bv + cv) % P
                elif oi == 1:
                    res = (bv - cv) % P
                elif oi == 2:
                    res = (bv * cv) % P
                else:
                    if cv % P == 0:
                        raise ExecutionError(f"felt div by zero at {pc:#x}")
                    res = (bv * pow(cv, -1, P)) % P
                if d == 3 and a >= self.num_pv_words:
                    raise ExecutionError("native pv index out of range")
                prevw, pw = mem.write(d, a, [res, 0, 0, 0], ts + 2)
                _append(r, pc=pc, ts=ts, op_idx=oi, a=a, b=b, c=c,
                        dst_as=d, b_imm=b_imm, c_imm=c_imm, b_val=bv,
                        c_val=cv, result=res, p_tsb=p1, p_tsc=p2, p_tsw=pw,
                        prev_w=prevw[0])
                pc, ts = pc + 4, ts + 3

            elif (FieldExtensionOpcode.FE4ADD <= op
                  <= FieldExtensionOpcode.BBE4DIV):
                r = recs["native_field_extension"]
                oi = op - FieldExtensionOpcode.FE4ADD
                x, pts_x = [], []
                for i in range(4):
                    w, p_ = mem.read(4, b + i, ts + i)
                    x.append(w[0]), pts_x.append(p_)
                y, pts_y = [], []
                for i in range(4):
                    w, p_ = mem.read(4, c + i, ts + 4 + i)
                    y.append(w[0]), pts_y.append(p_)
                if oi == 0:
                    z = [(x[i] + y[i]) % P for i in range(4)]
                elif oi == 1:
                    z = [(x[i] - y[i]) % P for i in range(4)]
                elif oi == 2:
                    z = list(ext_mul_int(tuple(x), tuple(y)))
                else:
                    if all(v == 0 for v in y):
                        raise ExecutionError(f"ext div by zero at {pc:#x}")
                    z = list(ext_mul_int(tuple(x), ext_inv_int(tuple(y))))
                prev_z, pts_z = [], []
                for i in range(4):
                    pw_, pz = mem.write(4, a + i, [z[i], 0, 0, 0],
                                        ts + 8 + i)
                    prev_z.append(pw_[0]), pts_z.append(pz)
                _append(r, pc=pc, ts=ts, op_idx=oi, a=a, b=b, c=c, x=x,
                        y=y, z=z, pts_x=pts_x, pts_y=pts_y, pts_z=pts_z,
                        prev_z=prev_z)
                pc, ts = pc + 4, ts + 12

            elif op in (NativeBranchEqOpcode.BEQ, NativeBranchEqOpcode.BNE):
                r = recs["native_branch_eq"]
                a_imm, b_imm = int(d == 0), int(e == 0)
                if a_imm:
                    xv, p1 = a, 0
                else:
                    w, p1 = mem.read(4, a, ts)
                    xv = w[0]
                if b_imm:
                    yv, p2 = b, 0
                else:
                    w, p2 = mem.read(4, b, ts + 1)
                    yv = w[0]
                eq = (xv - yv) % P == 0
                taken = eq if op == NativeBranchEqOpcode.BEQ else not eq
                off = c if c <= P // 2 else c - P
                to_pc = (pc + off) if taken else pc + 4
                _append(r, pc=pc, ts=ts,
                        op_idx=op - NativeBranchEqOpcode.BEQ, a=a, b=b,
                        imm=c, a_imm=a_imm, b_imm=b_imm, x_val=xv, y_val=yv,
                        to_pc=to_pc, p_ts1=p1, p_ts2=p2)
                pc, ts = to_pc, ts + 2

            elif (NativeLoadStoreOpcode.LOADW <= op
                  <= NativeLoadStoreOpcode.HINT_STOREW) or (
                      NativeLoadStore4Opcode.LOADW4 <= op
                      <= NativeLoadStore4Opcode.HINT_STOREW4):
                is4 = op >= NativeLoadStore4Opcode.LOADW4
                N = 4 if is4 else 1
                r = recs["native_loadstore4" if is4 else "native_loadstore"]
                base = (NativeLoadStore4Opcode.LOADW4 if is4
                        else NativeLoadStoreOpcode.LOADW)
                oi = op - base  # 0 load, 1 store, 2 hint
                has_ptr = int(f == 4)
                if has_ptr:
                    w, pp = mem.read(4, c, ts)
                    ptr_val = w[0]
                else:
                    ptr_val, pp = c, 0
                ptr = (ptr_val + b) % P
                if ptr >= (1 << 27):
                    raise ExecutionError(
                        f"native pointer {ptr:#x} out of range at {pc:#x}")
                data, pts_r = [], []
                if oi == 0:
                    for i in range(N):
                        w, p_ = mem.read(4, ptr + i, ts + 1 + i)
                        data.append(w[0]), pts_r.append(p_)
                elif oi == 1:
                    for i in range(N):
                        w, p_ = mem.read(4, a + i, ts + 1 + i)
                        data.append(w[0]), pts_r.append(p_)
                else:
                    hs = streams.hint_stream
                    if len(hs) < N:
                        raise ExecutionError("hint stream underflow")
                    data = [int(v) % P for v in hs[:N]]
                    del hs[:N]
                    pts_r = [0] * N
                w_base = a if oi == 0 else ptr
                prev_w, pts_w = [], []
                for i in range(N):
                    pw_, pz = mem.write(4, w_base + i, [data[i], 0, 0, 0],
                                        ts + 1 + N + i)
                    prev_w.append(pw_[0]), pts_w.append(pz)
                _append(r, pc=pc, ts=ts, op_idx=oi, a=a, b=b, c=c,
                        has_ptr=has_ptr, ptr_val=ptr_val, data=data,
                        p_tsp=pp, pts_r=pts_r, pts_w=pts_w, prev_w=prev_w)
                pc, ts = pc + 4, ts + 1 + 2 * N

            elif op in (NativeJalOpcode.JAL,
                        NativeRangeCheckOpcode.RANGE_CHECK):
                r = recs["native_jal_rangecheck"]
                if op == NativeJalOpcode.JAL:
                    prevw, pw = mem.write(4, a, [(pc + 4) % P, 0, 0, 0], ts)
                    off = b if b <= P // 2 else b - P
                    to_pc = pc + off
                    _append(r, pc=pc, ts=ts, op_idx=0, a=a, b=b, c=0, y=0,
                            prev_w=prevw[0], p_tsw=pw)
                else:
                    cur = mem._get((4, a))[:4]
                    x = cur[0]
                    prevw, pw = mem.write(4, a, list(cur), ts)
                    x_lo, x_hi = x & 0x7FFF, x >> 15
                    if x_lo >= (1 << b) or x_hi >= (1 << c):
                        raise ExecutionError(
                            f"RANGE_CHECK failed: {x:#x} !< 2^16*{c}+{b} "
                            f"bits at pc {pc:#x}")
                    to_pc = pc + 4
                    _append(r, pc=pc, ts=ts, op_idx=1, a=a, b=b, c=c,
                            y=x_hi, prev_w=prevw[0], p_tsw=pw)
                pc, ts = to_pc, ts + 1

            elif op == FriOpcode.FRI_REDUCED_OPENING:
                # result = sum_t alpha^t (b[t] - a[t]); len rows in
                # descending t (vm/circuit/native.py FriReducedOpeningAir)
                r = recs["fri_reduced_opening"]
                a_ptr, b_ptr, length = a, b, c
                alpha_ptr, result_ptr = d, e
                if length < 1:
                    raise ExecutionError(
                        f"FRI_REDUCED_OPENING length 0 at pc {pc:#x}")
                alpha, pts_alpha = [], []
                for k in range(4):
                    w, p_ = mem.read(4, alpha_ptr + k, ts + 5 * length + k)
                    alpha.append(w[0]), pts_alpha.append(p_)
                acc = (0, 0, 0, 0)
                for row, t_ in enumerate(range(length - 1, -1, -1)):
                    ts_row = ts + 5 * row
                    w, pa = mem.read(4, a_ptr + t_, ts_row)
                    av = w[0]
                    bv, pts_b = [], []
                    for k in range(4):
                        w, p_ = mem.read(4, b_ptr + 4 * t_ + k,
                                         ts_row + 1 + k)
                        bv.append(w[0]), pts_b.append(p_)
                    diff = ((bv[0] - av) % P, bv[1], bv[2], bv[3])
                    if row == 0:
                        acc = diff
                    else:
                        prod = ext_mul_int(acc, tuple(alpha))
                        acc = tuple((prod[k] + diff[k]) % P
                                    for k in range(4))
                    is_end = int(t_ == 0)
                    prev_res, pts_res = [0] * 4, [0] * 4
                    if is_end:
                        for k in range(4):
                            pw_, pz = mem.write(
                                4, result_ptr + k, [acc[k], 0, 0, 0],
                                ts + 5 * length + 4 + k)
                            prev_res[k], pts_res[k] = pw_[0], pz
                    _append(r, pc=pc, ts=ts, is_start=int(row == 0),
                            is_end=is_end, a_ptr=a_ptr, b_ptr=b_ptr,
                            length=length, alpha_ptr=alpha_ptr,
                            result_ptr=result_ptr, t=t_, alpha=list(alpha),
                            a_val=av, b_val=list(bv), acc=list(acc),
                            pts_a=pa, pts_b=pts_b,
                            pts_alpha=pts_alpha if is_end else [0] * 4,
                            pts_res=pts_res, prev_res=prev_res)
                pc, ts = pc + 4, ts + 5 * length + 8

            elif op == VerifyBatchOpcode.VERIFY_BATCH:
                # whole Merkle batch opening as one instruction
                # (vm/circuit/native.py VerifyBatchAir docstring spec)
                r_top = recs["verify_batch"]
                r_ins = recs["verify_batch_inside"]
                desc_ptr, sib_ptr, bits_ptr, commit_ptr, depth = a, b, c, d, e
                ts0 = ts
                bit_base = ts0 + 3 * (depth + 1)
                sib_base = bit_base + depth
                comm_base = bit_base + 9 * depth
                ts_acc = comm_base + 8
                node = [0] * 8
                zero8 = [0] * 8

                def fr(addr, tick):
                    w, p_ = mem.read(4, addr, tick)
                    return w[0], p_

                for s_ in range(depth + 1):
                    has_seg, pd0 = fr(desc_ptr + 3 * s_, ts0 + 3 * s_)
                    segp, pd1 = fr(desc_ptr + 3 * s_ + 1, ts0 + 3 * s_ + 1)
                    segl, pd2 = fr(desc_ptr + 3 * s_ + 2, ts0 + 3 * s_ + 2)
                    if s_ == 0 and not has_seg:
                        raise ExecutionError(
                            f"VERIFY_BATCH level 0 empty at pc {pc:#x}")
                    digest, n_rows, ts_add = zero8, 0, 0
                    if has_seg:
                        if segl < 1:
                            raise ExecutionError(
                                f"VERIFY_BATCH empty segment at pc {pc:#x}")
                        state = [0] * 16
                        n_rows = (segl + 7) // 8
                        rem = segl
                        for j in range(n_rows):
                            cnt = min(8, rem)
                            act = [int(i < cnt) for i in range(8)]
                            absorbed, pts_m = [], []
                            state_in = list(state)
                            for i in range(8):
                                if act[i]:
                                    v_, p_ = fr(segp + 8 * j + i,
                                                ts_acc + 8 * j + i)
                                    absorbed.append(v_), pts_m.append(p_)
                                else:
                                    absorbed.append(state_in[i])
                                    pts_m.append(0)
                            state = host_permute(absorbed + state_in[8:])
                            _append(r_ins, ts_seg=ts_acc, seg_ptr=segp,
                                    seg_len=segl, j=j, rem=rem,
                                    is_first=int(j == 0),
                                    is_last=int(j == n_rows - 1),
                                    act=act, absorbed=absorbed,
                                    state_in=state_in, state_out=state,
                                    pts_m=pts_m)
                            rem -= cnt
                        digest = state[:8]
                        ts_add = 8 * n_rows
                    node_in = list(node)
                    out_hi = zero8
                    if s_ == 0:
                        node = list(digest)
                    elif has_seg:
                        out = host_permute(node_in + list(digest))
                        node, out_hi = out[:8], out[8:]
                    is_end = int(s_ == depth)
                    comm, pts_comm = zero8, [0] * 8
                    if is_end:
                        comm, pts_comm = [], []
                        for k in range(8):
                            v_, p_ = fr(commit_ptr + k, comm_base + k)
                            comm.append(v_), pts_comm.append(p_)
                        if comm != node:
                            raise ExecutionError(
                                f"VERIFY_BATCH commitment mismatch at pc "
                                f"{pc:#x}")
                    _append(r_top, pc=pc, ts=ts0, depth=depth, f_op=f,
                            desc_ptr=desc_ptr, sib_ptr=sib_ptr,
                            bits_ptr=bits_ptr, commit_ptr=commit_ptr,
                            s=s_, is_lvl=1, is_sib=0,
                            is_start=int(s_ == 0), is_end=is_end,
                            ts_acc=ts_acc, ts_add=ts_add, has_seg=has_seg,
                            seg_ptr=segp, seg_len=segl, n_rows=n_rows,
                            bit=0, node_in=node_in, node=list(node),
                            digest=list(digest), out_hi=list(out_hi),
                            sib=zero8, in_l=zero8, in_r=zero8, comm=comm,
                            pts_d=[pd0, pd1, pd2], pts_bit=0,
                            pts_sib=[0] * 8, pts_comm=pts_comm)
                    ts_acc += ts_add
                    if s_ == depth:
                        break
                    # sibling compress row
                    bitv, pbit = fr(bits_ptr + s_, bit_base + s_)
                    if bitv not in (0, 1):
                        raise ExecutionError(
                            f"VERIFY_BATCH non-boolean index bit at pc "
                            f"{pc:#x}")
                    sib, pts_sib = [], []
                    for k in range(8):
                        v_, p_ = fr(sib_ptr + 8 * s_ + k,
                                    sib_base + 8 * s_ + k)
                        sib.append(v_), pts_sib.append(p_)
                    node_in = list(node)
                    in_l = sib if bitv else node_in
                    in_r = node_in if bitv else sib
                    out = host_permute(list(in_l) + list(in_r))
                    node, out_hi = out[:8], out[8:]
                    _append(r_top, pc=pc, ts=ts0, depth=depth, f_op=f,
                            desc_ptr=desc_ptr, sib_ptr=sib_ptr,
                            bits_ptr=bits_ptr, commit_ptr=commit_ptr,
                            s=s_, is_lvl=0, is_sib=1, is_start=0,
                            is_end=0, ts_acc=ts_acc, ts_add=0, has_seg=0,
                            seg_ptr=0, seg_len=0, n_rows=0, bit=bitv,
                            node_in=node_in, node=list(node),
                            digest=zero8, out_hi=list(out_hi),
                            sib=list(sib), in_l=list(in_l),
                            in_r=list(in_r), comm=zero8,
                            pts_d=[0, 0, 0], pts_bit=pbit,
                            pts_sib=pts_sib, pts_comm=[0] * 8)
                pc, ts = pc + 4, ts_acc

            elif op in (Poseidon2Opcode.PERM_POS2, Poseidon2Opcode.COMP_POS2):
                r = recs["native_poseidon2"]
                is_comp = int(op == Poseidon2Opcode.COMP_POS2)
                inp, pts_r = [], []
                for i in range(16):
                    addr = (b + i) if (i < 8 or not is_comp) else (c + i - 8)
                    w, p_ = mem.read(4, addr, ts + i)
                    inp.append(w[0]), pts_r.append(p_)
                out = host_permute(inp)
                n_w = 8 if is_comp else 16
                prev_w, pts_w = [0] * 16, [0] * 16
                for i in range(n_w):
                    pw_, pz = mem.write(4, a + i, [out[i], 0, 0, 0],
                                        ts + 16 + i)
                    prev_w[i], pts_w[i] = pw_[0], pz
                _append(r, pc=pc, ts=ts, op_idx=is_comp, a=a, b=b, c=c,
                        inp=inp, out=out, pts_r=pts_r, pts_w=pts_w,
                        prev_w=prev_w)
                pc, ts = pc + 4, ts + 32

            elif op == Rv32KeccakOpcode.KECCAK256:
                r = recs["keccak_sponge"]
                rf = recs["keccakf"]
                a_idx, b_idx, c_idx = a // 4, b // 4, c // 4
                dstp, p_rd = reg_read(a_idx, 0)
                srcp, p_rs = reg_read(b_idx, 1)
                lenp, p_rl = reg_read(c_idx, 2)
                dst = _from_limbs(dstp)
                src = _from_limbs(srcp)
                ln = _from_limbs(lenp)
                if src + ln >= (1 << 29) or dst + 32 >= (1 << 29):
                    raise ExecutionError(
                        f"keccak256 range out of bounds at pc {pc:#x}")
                off = src % 4  # sources may be byte-aligned (word window)
                nblocks = ln // RATE_BYTES + 1
                lanes = [0] * 25
                for bi in range(nblocks):
                    ts_b = ts + TS_PER_BLOCK * bi
                    is_first = int(bi == 0)
                    is_last = int(bi == nblocks - 1)
                    rem = ln - RATE_BYTES * bi
                    real = min(rem, RATE_BYTES)
                    pad_start = real if is_last else RATE_BYTES
                    src_cur = src + RATE_BYTES * bi
                    win_bytes = [0] * (4 * W_WINDOW)
                    pts_w = [0] * W_WINDOW
                    nw = (off + real + 3) // 4 if real else 0
                    for w in range(nw):
                        data_w, pw = mem.read(2, src_cur // 4 + w,
                                              ts_b + 3 + w)
                        win_bytes[4 * w:4 * w + 4] = data_w
                        pts_w[w] = pw
                    mem_bytes = [win_bytes[off + j] if j < real else 0
                                 for j in range(RATE_BYTES)]
                    block = bytearray(mem_bytes[:real])
                    block += bytearray(RATE_BYTES - real)
                    if is_last:
                        block[real] ^= 0x01
                        block[RATE_BYTES - 1] ^= 0x80
                    state_in = list(lanes)
                    for i in range(RATE_BYTES // 8):
                        lanes[i] ^= int.from_bytes(
                            block[8 * i:8 * i + 8], "little")
                    absorbed = list(lanes)
                    lanes = keccak_f(lanes)
                    prevw = [[0] * 4 for _ in range(9)]
                    pts_wr = [0] * 9
                    wrb = [0] * 36
                    if is_last:
                        digest = b"".join(lanes[i].to_bytes(8, "little")
                                          for i in range(4))
                        doff = dst % 4
                        n_wr = 8 + (1 if doff else 0)
                        for w in range(n_wr):
                            word = mem.peek(2, dst // 4 + w)
                            for k in range(4):
                                i = 4 * w + k - doff
                                if 0 <= i < 32:
                                    word[k] = digest[i]
                            pv_, pz = mem.write(2, dst // 4 + w, word,
                                                ts_b + 3 + W_WINDOW + w)
                            prevw[w], pts_wr[w] = pv_, pz
                            wrb[4 * w:4 * w + 4] = word
                    _append(r, pc=pc, ts=ts_b, is_first=is_first,
                            is_last=is_last, a_idx=a_idx, b_idx=b_idx,
                            c_idx=c_idx, dstp=dstp, srcp=srcp, lenp=lenp,
                            pts_regs=[p_rd, p_rs, p_rl]
                            if is_first else [0, 0, 0],
                            src_cur=src_cur, rem=rem, mem_bytes=mem_bytes,
                            win_bytes=win_bytes,
                            pad_start=pad_start, pts_w=pts_w,
                            # copy: the next block's in-place absorb
                            # (`lanes[i] ^= ...`) must not mutate this
                            # row's recorded output through the reference
                            state_in=state_in, state_out=list(lanes),
                            prevw=prevw, pts_wr=pts_wr, wrb=wrb)
                    _append(rf, state_in=absorbed)
                pc, ts = pc + 4, ts + TS_PER_BLOCK * nblocks

            elif op == Rv32Sha256Opcode.SHA256:
                r = recs["sha256_sponge"]
                rf = recs["sha256"]
                a_idx, b_idx, c_idx = a // 4, b // 4, c // 4
                dstp, p_rd = reg_read(a_idx, 0)
                srcp, p_rs = reg_read(b_idx, 1)
                lenp, p_rl = reg_read(c_idx, 2)
                dst = _from_limbs(dstp)
                src = _from_limbs(srcp)
                ln = _from_limbs(lenp)
                if src + ln >= (1 << 29) or dst + 32 >= (1 << 29):
                    raise ExecutionError(
                        f"sha256 range out of bounds at pc {pc:#x}")
                s_off = src % 4  # sources may be byte-aligned (word window)
                nblocks = (ln + 9 + SB - 1) // SB
                state = list(H0)
                pad80_done = False
                for bi in range(nblocks):
                    ts_b = ts + STS * bi
                    is_first = int(bi == 0)
                    is_last = int(bi == nblocks - 1)
                    rem = max(ln - SB * bi, 0)
                    real = min(rem, SB)
                    is_c = int(not is_last and 56 <= rem <= 63)
                    p80 = int(pad80_done and is_last)
                    src_cur = src + SB * bi
                    win_bytes = [0] * (4 * SWW)
                    pts_w = [0] * SWW
                    nw = (s_off + real + 3) // 4 if real else 0
                    for w in range(nw):
                        data_w, pw = mem.read(2, src_cur // 4 + w,
                                              ts_b + 3 + w)
                        win_bytes[4 * w:4 * w + 4] = data_w
                        pts_w[w] = pw
                    mem_bytes = [win_bytes[s_off + j] if j < real else 0
                                 for j in range(SB)]
                    block = bytearray(mem_bytes[:real])
                    block += bytearray(SB - real)
                    if real < SB and not pad80_done:
                        block[real] = 0x80
                        pad80_done = True
                    if is_last:
                        block[SB - 8:] = (8 * ln).to_bytes(8, "big")
                    words = [int.from_bytes(block[4 * i:4 * i + 4], "big")
                             for i in range(SW)]
                    state_in = list(state)
                    state, _, _ = sha_compress(state, words)
                    prevw = [[0] * 4 for _ in range(9)]
                    pts_wr = [0] * 9
                    wrb = [0] * 36
                    if is_last:
                        digest = b"".join(v_.to_bytes(4, "big")
                                          for v_ in state)
                        d_off = dst % 4
                        n_wr = 8 + (1 if d_off else 0)
                        for w in range(n_wr):
                            word = mem.peek(2, dst // 4 + w)
                            for k in range(4):
                                i = 4 * w + k - d_off
                                if 0 <= i < 32:
                                    word[k] = digest[i]
                            pv_, pz = mem.write(2, dst // 4 + w, word,
                                                ts_b + 3 + SWW + w)
                            prevw[w], pts_wr[w] = pv_, pz
                            wrb[4 * w:4 * w + 4] = word
                    _append(r, pc=pc, ts=ts_b, is_first=is_first,
                            is_last=is_last, is_c=is_c, pad80prev=p80,
                            a_idx=a_idx, b_idx=b_idx, c_idx=c_idx,
                            dstp=dstp, srcp=srcp, lenp=lenp,
                            pts_regs=[p_rd, p_rs, p_rl]
                            if is_first else [0, 0, 0],
                            src_cur=src_cur, rem=rem, total_len=ln,
                            mem_bytes=mem_bytes, win_bytes=win_bytes,
                            block_bytes=list(block), pad_start=real,
                            pts_w=pts_w, state_in=state_in,
                            state_out=list(state), prevw=prevw,
                            pts_wr=pts_wr, wrb=wrb)
                    _append(rf, state=state_in, words=words)
                pc, ts = pc + 4, ts + STS * nblocks


            elif op == SystemOpcode.PHANTOM:
                r = recs["phantom"]
                disc = c & 0xFFFF
                if disc == Rv32Phantom.HINT_INPUT:
                    if not streams.input_stream:
                        raise ExecutionError("EndOfInputStream")
                    hint = list(streams.input_stream.pop(0))
                    streams.hint_stream.clear()
                    streams.hint_stream.extend(
                        len(hint).to_bytes(4, "little"))
                    pad = (-len(hint)) % 4
                    streams.hint_stream.extend(hint + [0] * pad)
                elif disc == PairingPhantom.HINT_FINAL_EXP:
                    def _peek(ptr, ln):
                        return bytes(mem._get((2, (ptr + k) // 4))
                                     [(ptr + k) % 4] for k in range(ln))

                    def _reg(reg_off):
                        return int.from_bytes(
                            bytes(mem._get((1, reg_off // 4))[:4]), "little")

                    t0 = time.perf_counter()
                    hint = hint_final_exp_bytes(c >> 16, _peek, _reg(a),
                                                _reg(b))
                    hint_s.append(time.perf_counter() - t0)
                    streams.hint_stream.clear()
                    streams.hint_stream.extend(hint)
                elif disc == ModularPhantom.HINT_NON_QR:
                    from .modhints import non_qr_hint_bytes
                    mod = self.moduli[c >> 16]
                    streams.hint_stream.clear()
                    streams.hint_stream.extend(non_qr_hint_bytes(mod))
                elif disc == ModularPhantom.HINT_SQRT:
                    from .modhints import num_limbs, sqrt_hint_bytes
                    mod = self.moduli[c >> 16]
                    ptr = int.from_bytes(
                        bytes(mem._get((1, a // 4))[:4]), "little")
                    nl = num_limbs(mod)
                    xv = int.from_bytes(
                        bytes(mem._get((2, (ptr + k) // 4))[(ptr + k) % 4]
                              for k in range(nl)), "little")
                    streams.hint_stream.clear()
                    streams.hint_stream.extend(sqrt_hint_bytes(xv, mod))
                elif disc == NativePhantom.HINT_INPUT:
                    # native hints are felts: [len] + felts (reference
                    # NativeHintInputSubEx, extension/mod.rs:358-388)
                    if not streams.input_stream:
                        raise ExecutionError("EndOfInputStream")
                    hint = list(streams.input_stream.pop(0))
                    streams.hint_stream.clear()
                    streams.hint_stream.append(len(hint))
                    streams.hint_stream.extend(int(v) % P for v in hint)
                elif disc == NativePhantom.HINT_FELT:
                    if not streams.input_stream:
                        raise ExecutionError("EndOfInputStream")
                    hint = list(streams.input_stream.pop(0))
                    streams.hint_stream.clear()
                    streams.hint_stream.extend(int(v) % P for v in hint)
                elif disc == NativePhantom.HINT_BITS:
                    val = mem._get((4, a))[0]  # peek: no bus access
                    streams.hint_stream.clear()
                    for _i in range(b):
                        streams.hint_stream.append(val & 1)
                        val >>= 1
                elif disc == NativePhantom.PRINT:
                    w = mem._get(((c >> 16) or 4, a))
                    print(f"[native print] {w[0]}")
                _append(r, pc=pc, ts=ts, a=a, b=b, c=c)
                pc, ts = pc + 4, ts + 1

            else:
                raise ExecutionError(
                    f"opcode {op:#x} has no circuit support yet")

        # finalize
        out = {}
        for chip, cols in recs.items():
            out[chip] = {k: np.asarray(v, dtype=np.uint64)
                         for k, v in cols.items()}
        if nvm is not None:
            # RV32IM records, touched-word set and per-pc execution counts
            # live in the C++ handle; Python holds the extension chips only
            out.update(nvm.drain_records())
            touched, init_words = nvm.drain_touched()
            counts = dict(exec_counts)
            for i in np.nonzero(nvm.exec_counts)[0]:
                counts[int(i)] = counts.get(int(i), 0) \
                    + int(nvm.exec_counts[i])
        else:
            touched, init_words = dict(mem.words), dict(mem.init_words)
            counts = dict(exec_counts)
        pvs = [0] * (4 * self.num_pv_words)
        for i in range(self.num_pv_words):
            w = touched.get((3, i))
            if w:
                pvs[4 * i:4 * i + 4] = w[:4]
        result = PreflightResult(
            records=out, touched=touched, init_words=init_words,
            exec_counts=counts, final_pc=pc, final_ts=ts,
            exit_code=exit_code, instret=instret, public_values=pvs,
            segment_full=segment_full, hint_s=hint_s,
            host_perms=perm_stats[0], host_perm_s=perm_stats[1])
        if suspended:
            if nvm is not None:
                # memory stays in the handle across segments; the state
                # dict carries only control flow + streams
                result.suspended_state = {"pc": pc, "streams": streams}
            else:
                carried = {k: list(v) for k, v in mem._image.items()}
                for (a_s, wa), w in mem.words.items():
                    carried[(a_s, wa)] = list(w[:4])
                result.suspended_state = {"pc": pc, "memory_words": carried,
                                          "streams": streams}
        return result


def _append(__rec, **kwargs):
    for k, v in kwargs.items():
        __rec[k].append(v)
