"""Preflight (E3) execution: the record-generating interpreter, RV32IM.

Copy of openvm_tpu/vm/preflight.py:45-510 (records, memory, the RV32IM
dispatch loop), :1365-1476 (phantom, terminate, finalize) and the
continuation half: ``PreflightResult.suspended_state`` and ``segment_full``,
``SegmentCtx`` (:46-70), ``PreflightMemory(initial_words=...)`` (:72-86),
the resume and ``py_stats`` logic of ``execute`` (:133-200), its
``max_insns`` suspend and metered boundary, and the suspended-state dicts
(:1440-1476).  With a
``native.NativeVmHandle`` the C++ core (csrc/host/preflight.cpp) runs the
RV32IM instruction runs and this loop dispatches what it yields on.  The
extension opcodes (int256, modular, ecc, fp2, native, keccak, sha256 and
their phantoms) raise NotImplementedError: their chips are a later slice of
the port.

Timestamp discipline mirrors the AIRs exactly: each instruction starts at
`ts` and performs its accesses at fixed ticks (slot k at ts+k), advancing
`ts` by the chip's fixed access count whether or not gated accesses happen.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

from .circuit import buses as B
from .instructions import (BaseAluOpcode, BranchEqualOpcode,
                           BranchLessThanOpcode, DivRemOpcode,
                           LessThanOpcode, MulHOpcode, MulOpcode, P,
                           Rv32AuipcOpcode, Rv32HintStoreOpcode,
                           Rv32JalLuiOpcode, Rv32JalrOpcode,
                           Rv32LoadStoreOpcode, Rv32Phantom, ShiftOpcode,
                           SystemOpcode, VmExe)
from .interpreter import ExecutionError, Streams, _imm16, _imm24, _s32
from .native import PF_INSN_LIMIT, PF_MEM_ERROR, PF_SEGMENT_FULL

M32 = 0xFFFFFFFF


def _is_extension(op: int) -> bool:
    """Native (0x100-0x1ff) and keccak, sha256, int256, modular, ecc, fp2
    opcodes (0x300 and above; instructions.py): a later slice of the port."""
    return 0x100 <= op < 0x200 or op >= 0x300


# NativePhantom (0x10-0x14), PairingPhantom (0x30), ModularPhantom (0x50,
# 0x51): extension phantoms (instructions.py).
_EXTENSION_PHANTOMS = frozenset(range(0x10, 0x15)) | {0x30, 0x50, 0x51}


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


def _u32_limbs(v):
    return [(v >> (8 * i)) & 0xFF for i in range(4)]


def _from_limbs(limbs):
    return limbs[0] | (limbs[1] << 8) | (limbs[2] << 16) | (limbs[3] << 24)


class PreflightInterpreter:
    def __init__(self, exe: VmExe, num_pv_words: int = 8):
        self.exe = exe
        self.num_pv_words = num_pv_words

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
        ts = B.INITIAL_TIMESTAMP
        pc_base, step = exe.program.pc_base, exe.program.step
        instret = 0
        exit_code = None

        def reg_read(idx, tick):
            data, pts = mem.read(1, idx, ts + tick)
            return data, pts

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
                elif disc in _EXTENSION_PHANTOMS:
                    raise NotImplementedError(
                        f"phantom {disc:#x} belongs to an extension the port "
                        "does not have yet")
                _append(r, pc=pc, ts=ts, a=a, b=b, c=c)
                pc, ts = pc + 4, ts + 1

            elif _is_extension(op):
                raise NotImplementedError(
                    f"opcode {op:#x} at pc {pc:#x} belongs to an extension "
                    "the port does not have yet")

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
            segment_full=segment_full)
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
