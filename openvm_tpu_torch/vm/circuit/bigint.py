"""Int256 (bigint) extension: 256-bit ALU/compare/mul/branch/shift AIRs.

Copy of openvm_tpu/vm/circuit/bigint.py (the whole module: the heap adapter
:46-180, the six AIRs :203-695 and INT256_AIRS).

TPU-native re-design of the reference bigint extension
(reference extensions/bigint/circuit/src/{base_alu,less_than,mult,
branch_eq,branch_lt,shift}.rs, SURVEY.md section 2.8): each chip is one
row per instruction operating on 32-limb (256-bit) values held in memory
(address space 2) behind register-held pointers — the reference's
"vec-heap adapter" (extensions/rv32-adapters/src/vec_heap.rs) realized as
word-granular memory-bus traffic.

Access schedule per row (ALU-type): registers rs1/rs2/rd at ticks 0..2,
the two 8-word operand blocks at ticks 3..10 and 11..18, the 8-word
result block written at ticks 19..26 (ts advances by 27).  Branches read
two registers + two blocks (ts + 18).

Pointer discipline: a pointer register's top limb is range-checked < 32
(pointer < 2^29, the VM address-space bound, reference
MemoryConfig.pointer_max_bits), then decomposed as 4*(wa_lo + 2^15*wa_hi)
which both enforces 4-byte alignment and yields the word address for the
memory bus.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..instructions import (BaseAlu256Opcode, BranchEqual256Opcode,
                            BranchLessThan256Opcode, LessThan256Opcode,
                            Mul256Opcode, Shift256Opcode)
from . import buses as B
from .buses import Cols
from .rv32im import _m, _marr, _pad_pow2, _ts_diff

P = 2013265921
N = 32  # limbs per 256-bit value
W = 8   # memory words per value
M256 = (1 << 256) - 1


# ---------------------------------------------------------------------------
# shared heap-adapter columns / constraints / trace fill
# ---------------------------------------------------------------------------


def _adapter_cols(c: Cols, writes: bool, nl: int = N):
    wn = nl // 4
    c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
    c.alloc("a"), c.alloc("b"), c.alloc("cc")
    for tag in ("r1", "r2") + (("rd",) if writes else ()):
        c.alloc(f"{tag}p", 4)
        c.alloc(f"pts_{tag}"), c.alloc(f"dlo_{tag}"), c.alloc(f"dhi_{tag}")
        c.alloc(f"wa_{tag}_lo"), c.alloc(f"wa_{tag}_hi")
    c.alloc("x", nl), c.alloc("y", nl)
    for tag in ("x", "y") + (("z",) if writes else ()):
        c.alloc(f"pts_{tag}", wn)
        c.alloc(f"dlo_{tag}", wn), c.alloc(f"dhi_{tag}", wn)
    if writes:
        c.alloc("z", nl), c.alloc("prevz", nl)


def _ptr_word_addr(b, c: Cols, v, tag):
    """Decompose pointer register -> word address; enforce bound+align."""
    limbs = _marr(b, c, f"{tag}p", 4)
    lo = _m(b, c, f"wa_{tag}_lo")
    hi = _m(b, c, f"wa_{tag}_hi")
    ptr = (limbs[0] + 256 * limbs[1] + 65536 * limbs[2]
           + (1 << 24) * limbs[3])
    B.range_check(b, limbs[3], 5, v)  # pointer < 2^29
    b.assert_zero(v * (ptr - 4 * (lo + (1 << 15) * hi)))
    B.range_check(b, lo, 15, v)
    B.range_check(b, hi, 12, v)
    return lo + (1 << 15) * hi


def _adapter_eval(b, c: Cols, v, pc, ts, opcode, writes: bool,
                  z_override=None, first_block_tick: int = 3, nl: int = N):
    """Register + block accesses; returns (x, y, z) col expr lists.

    With writes=True the caller's result limbs (z cols, or z_override
    expressions) are written back to [rd_ptr].
    """
    wn = nl // 4
    oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
    if writes:
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, 4 * oc, 1, 2, 0, 0], v)
    else:
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, oc, 1, 2, 0, 0], v)

    # register reads
    regs = (("r1", ob if writes else oa, 0),
            ("r2", oc if writes else ob, 1)) + (
        (("rd", oa, 2),) if writes else ())
    for tag, operand, tick in regs:
        B.mem_read(b, B.AS_REGISTER, operand, _marr(b, c, f"{tag}p", 4),
                   _m(b, c, f"pts_{tag}"), ts + tick,
                   _m(b, c, f"dlo_{tag}"), _m(b, c, f"dhi_{tag}"), v)

    wa1 = _ptr_word_addr(b, c, v, "r1")
    wa2 = _ptr_word_addr(b, c, v, "r2")
    wad = _ptr_word_addr(b, c, v, "rd") if writes else None

    x = _marr(b, c, "x", nl)
    y = _marr(b, c, "y", nl)
    t0 = first_block_tick
    for k in range(wn):
        B.mem_read(b, B.AS_MEMORY, wa1 + k, x[4 * k:4 * k + 4],
                   b.main(c.index["pts_x"] + k), ts + t0 + k,
                   b.main(c.index["dlo_x"] + k),
                   b.main(c.index["dhi_x"] + k), v)
        B.mem_read(b, B.AS_MEMORY, wa2 + k, y[4 * k:4 * k + 4],
                   b.main(c.index["pts_y"] + k), ts + t0 + wn + k,
                   b.main(c.index["dlo_y"] + k),
                   b.main(c.index["dhi_y"] + k), v)
    z = None
    if writes:
        z = z_override if z_override is not None else _marr(b, c, "z", nl)
        prevz = _marr(b, c, "prevz", nl)
        for k in range(wn):
            B.mem_write(b, B.AS_MEMORY, wad + k, z[4 * k:4 * k + 4],
                        prevz[4 * k:4 * k + 4],
                        b.main(c.index["pts_z"] + k), ts + t0 + 2 * wn + k,
                        b.main(c.index["dlo_z"] + k),
                        b.main(c.index["dhi_z"] + k), v)
    return x, y, z


def _adapter_fill(t, n, c: Cols, rec, writes: bool,
                  first_block_tick: int = 3, nl: int = N):
    """Vectorized fill of all adapter columns from preflight records."""
    wn = nl // 4
    ix = c.index
    t[:n, ix["is_valid"]] = 1
    for nm in ("pc", "ts", "a", "b"):
        t[:n, ix[nm]] = rec[nm]
    t[:n, ix["cc"]] = rec["c"]
    ts = rec["ts"]
    regs = (("r1", "rs1p", 0), ("r2", "rs2p", 1)) + (
        (("rd", "rdp", 2),) if writes else ())
    for tag, fld, tick in regs:
        limbs = rec[fld]
        t[:n, ix[f"{tag}p"]:ix[f"{tag}p"] + 4] = limbs
        pts = rec[f"pts_{tag}"]
        t[:n, ix[f"pts_{tag}"]] = pts
        lo, hi = _ts_diff(pts, ts + tick)
        t[:n, ix[f"dlo_{tag}"]] = lo
        t[:n, ix[f"dhi_{tag}"]] = hi
        ptr = (limbs[:, 0] + 256 * limbs[:, 1] + 65536 * limbs[:, 2]
               + (1 << 24) * limbs[:, 3])
        t[:n, ix[f"wa_{tag}_lo"]] = (ptr >> 2) & 0x7FFF
        t[:n, ix[f"wa_{tag}_hi"]] = ptr >> 17
    t[:n, ix["x"]:ix["x"] + nl] = rec["x"]
    t[:n, ix["y"]:ix["y"] + nl] = rec["y"]
    t0 = first_block_tick
    blocks = (("x", t0), ("y", t0 + wn)) + (
        (("z", t0 + 2 * wn),) if writes else ())
    for tag, base in blocks:
        pts = rec[f"pts_{tag}"]
        t[:n, ix[f"pts_{tag}"]:ix[f"pts_{tag}"] + wn] = pts
        for k in range(wn):
            lo, hi = _ts_diff(pts[:, k], ts + base + k)
            t[:n, ix[f"dlo_{tag}"] + k] = lo
            t[:n, ix[f"dhi_{tag}"] + k] = hi
    if writes:
        t[:n, ix["z"]:ix["z"] + nl] = rec["z"]
        t[:n, ix["prevz"]:ix["prevz"] + nl] = rec["prevz"]


def _flags(b, c: Cols, v, nf):
    f = _marr(b, c, "f", nf)
    for fi in f:
        b.assert_bool(fi)
    b.assert_eq(sum(f[1:], f[0]), v)
    return f


def _fill_flags(t, n, c: Cols, rec, nf):
    fcols = np.zeros((n, nf), dtype=np.uint64)
    fcols[np.arange(n), rec["op_idx"]] = 1
    t[:n, c.index["f"]:c.index["f"] + nf] = fcols


def _limbs_to_int(a):  # (n, N) uint64 -> python-int array
    out = np.zeros(len(a), dtype=object)
    for i in range(N - 1, -1, -1):
        out = out * 256 + a[:, i].astype(object)
    return out


def _int_to_limbs(vals, n):
    out = np.zeros((n, N), dtype=np.uint64)
    for i in range(N):
        out[:, i] = np.asarray([int(v >> (8 * i)) & 255 for v in vals],
                               dtype=np.uint64)
    return out


# ---------------------------------------------------------------------------
# BaseAlu256: ADD/SUB/XOR/OR/AND
# ---------------------------------------------------------------------------


class BaseAlu256Air(Air):
    name = "int256_alu"
    OPS = [BaseAlu256Opcode.ADD, BaseAlu256Opcode.SUB, BaseAlu256Opcode.XOR,
           BaseAlu256Opcode.OR, BaseAlu256Opcode.AND]
    TS_DELTA = 27

    def __init__(self):
        c = self.c = Cols()
        _adapter_cols(c, writes=True)
        c.alloc("f", 5)
        c.alloc("carry", N)
        c.alloc("xorv", N)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 5)
        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True)

        carry = _marr(b, c, "carry", N)
        xorv = _marr(b, c, "xorv", N)
        for i in range(N):
            b.assert_bool(carry[i])
            prev_c = carry[i - 1] if i else 0
            b.assert_zero(f[0] * (x[i] + y[i] + prev_c - z[i]
                                  - carry[i] * 256))
            b.assert_zero(f[1] * (x[i] - y[i] - prev_c - z[i]
                                  + carry[i] * 256))
        f_bw = f[2] + f[3] + f[4]
        for i in range(N):
            B.xor_lookup(b, x[i], y[i], xorv[i], f_bw)
            b.assert_zero(f[2] * (z[i] - xorv[i]))
            b.assert_zero(f[3] * (2 * z[i] - (x[i] + y[i] + xorv[i])))
            b.assert_zero(f[4] * (2 * z[i] - (x[i] + y[i] - xorv[i])))

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True)
        _fill_flags(t, n, c, rec, 5)
        x, y = rec["x"], rec["y"]
        t[:n, c.index["xorv"]:c.index["xorv"] + N] = (
            x.astype(np.uint32) ^ y.astype(np.uint32))
        carry = np.zeros((n, N), dtype=np.uint64)
        is_add = rec["op_idx"] == 0
        is_sub = rec["op_idx"] == 1
        cacc = np.zeros(n, dtype=np.uint64)
        for i in range(N):
            cadd = (x[:, i] + y[:, i] + cacc) >> 8
            csub = ((x[:, i] - y[:, i] - cacc) >> 63) & 1
            cacc = np.where(is_add, cadd, np.where(is_sub, csub, 0))
            carry[:, i] = cacc
        t[:n, c.index["carry"]:c.index["carry"] + N] = carry
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# LessThan256: SLT/SLTU (borrow-chain comparison)
# ---------------------------------------------------------------------------


def _borrow_lt_cols(c: Cols):
    c.alloc("d", N)      # difference bytes
    c.alloc("bor", N)    # borrow bits; bor[N-1] = lt
    c.alloc("sign1"), c.alloc("sign2"), c.alloc("rem1"), c.alloc("rem2")


def _borrow_lt_eval(b, c: Cols, v, signed, x, y):
    """x < y (unsigned, or signed when `signed`=1) via 256-bit borrow chain.

    Per limb:  kx_i - ky_i - bor_{i-1} + 256*bor_i - d_i = 0, d_i a byte.
    Signed flips the top limb into biased form kx = x+128-256*sign.
    Returns the lt column (bor[N-1]).
    """
    d = _marr(b, c, "d", N)
    bor = _marr(b, c, "bor", N)
    s1, s2 = _m(b, c, "sign1"), _m(b, c, "sign2")
    r1, r2 = _m(b, c, "rem1"), _m(b, c, "rem2")
    b.assert_bool(s1)
    b.assert_bool(s2)
    b.assert_zero(signed * (x[N - 1] - 128 * s1 - r1))
    b.assert_zero(signed * (y[N - 1] - 128 * s2 - r2))
    b.assert_zero((v - signed) * s1)
    b.assert_zero((v - signed) * s2)
    B.range_check(b, r1, 7, signed)
    B.range_check(b, r2, 7, signed)
    kx = list(x)
    ky = list(y)
    kx[N - 1] = x[N - 1] + signed * 128 - 256 * s1
    ky[N - 1] = y[N - 1] + signed * 128 - 256 * s2
    for i in range(N):
        b.assert_bool(bor[i])
        prev = bor[i - 1] if i else 0
        b.assert_zero(v * (kx[i] - ky[i] - prev + 256 * bor[i] - d[i]))
    for i in range(0, N, 2):
        B.byte_pair_check(b, d[i], d[i + 1], v)
    return bor[N - 1]


def _borrow_lt_fill(t, n, c: Cols, x, y, signed_mask):
    s1 = (x[:, N - 1] >> 7) & signed_mask
    s2 = (y[:, N - 1] >> 7) & signed_mask
    t[:n, c.index["sign1"]] = s1
    t[:n, c.index["sign2"]] = s2
    t[:n, c.index["rem1"]] = np.where(signed_mask, x[:, N - 1] - 128 * s1, 0)
    t[:n, c.index["rem2"]] = np.where(signed_mask, y[:, N - 1] - 128 * s2, 0)
    kx = x.astype(np.int64).copy()
    ky = y.astype(np.int64).copy()
    kx[:, N - 1] += signed_mask.astype(np.int64) * 128 - 256 * s1.astype(np.int64)
    ky[:, N - 1] += signed_mask.astype(np.int64) * 128 - 256 * s2.astype(np.int64)
    bor = np.zeros(n, dtype=np.int64)
    for i in range(N):
        diff = kx[:, i] - ky[:, i] - bor
        bor = (diff < 0).astype(np.int64)
        t[:n, c.index["d"] + i] = (diff + 256 * bor).astype(np.uint64)
        t[:n, c.index["bor"] + i] = bor.astype(np.uint64)
    return bor.astype(np.uint64)


class LessThan256Air(Air):
    name = "int256_lt"
    OPS = [LessThan256Opcode.SLT, LessThan256Opcode.SLTU]
    TS_DELTA = 27

    def __init__(self):
        c = self.c = Cols()
        _adapter_cols(c, writes=True)
        c.alloc("f", 2)
        _borrow_lt_cols(c)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 2)
        opcode = f[0] * self.OPS[0] + f[1] * self.OPS[1]
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True)
        lt = _borrow_lt_eval(b, c, v, f[0], x, y)
        b.assert_zero(z[0] - lt)
        for i in range(1, N):
            b.assert_zero(z[i])

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True)
        _fill_flags(t, n, c, rec, 2)
        _borrow_lt_fill(t, n, c, rec["x"], rec["y"],
                        (rec["op_idx"] == 0).astype(np.uint64))
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# Mul256: low 256 bits of x*y (32-limb schoolbook with range-checked carries)
# ---------------------------------------------------------------------------


class Mul256Air(Air):
    name = "int256_mul"
    TS_DELTA = 27

    def __init__(self):
        c = self.c = Cols()
        _adapter_cols(c, writes=True)
        c.alloc("carry", N)  # carry_i < 2^15
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, Mul256Opcode.MUL,
                                writes=True)
        carry = _marr(b, c, "carry", N)
        for i in range(N):
            conv = sum((x[j] * y[i - j] for j in range(1, i + 1)),
                       x[0] * y[i])
            prev_c = carry[i - 1] if i else 0
            b.assert_zero(v * (conv + prev_c - z[i] - 256 * carry[i]))
            B.range_check(b, carry[i], 15, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True)
        x = rec["x"].astype(np.uint64)
        y = rec["y"].astype(np.uint64)
        z = rec["z"]
        cacc = np.zeros(n, dtype=np.uint64)
        for i in range(N):
            conv = cacc.copy()
            for j in range(i + 1):
                conv += x[:, j] * y[:, i - j]
            cacc = (conv - z[:, i]) >> 8
            t[:n, c.index["carry"] + i] = cacc
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# BranchEqual256: BEQ/BNE over 256-bit operands
# ---------------------------------------------------------------------------


class BranchEq256Air(Air):
    name = "int256_beq"
    OPS = [BranchEqual256Opcode.BEQ, BranchEqual256Opcode.BNE]
    TS_DELTA = 18

    def __init__(self):
        c = self.c = Cols()
        _adapter_cols(c, writes=False)
        c.alloc("f", 2)
        c.alloc("cmp")       # 1 iff x == y
        c.alloc("inv", N)    # witness: sum (x_i-y_i)*inv_i = 1 - cmp
        c.alloc("taken"), c.alloc("to_pc")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 2)
        opcode = f[0] * self.OPS[0] + f[1] * self.OPS[1]
        B.exec_receive(b, pc, ts, v)
        x, y, _ = _adapter_eval(b, c, v, pc, ts, opcode, writes=False,
                                first_block_tick=2)
        cmp = _m(b, c, "cmp")
        inv = _marr(b, c, "inv", N)
        taken, to_pc = _m(b, c, "taken"), _m(b, c, "to_pc")
        imm = _m(b, c, "cc")
        b.assert_bool(cmp)
        for i in range(N):
            b.assert_zero(cmp * (x[i] - y[i]))
        acc = sum(((x[i] - y[i]) * inv[i] for i in range(1, N)),
                  (x[0] - y[0]) * inv[0])
        b.assert_zero(v * (acc - (1 - cmp)))
        b.assert_zero(taken - (f[0] * cmp + f[1] * (v - cmp)))
        b.assert_zero(v * (to_pc - (pc + 4 + taken * (imm - 4))))
        B.exec_send(b, to_pc, ts + self.TS_DELTA, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=False, first_block_tick=2)
        _fill_flags(t, n, c, rec, 2)
        x, y = rec["x"].astype(np.int64), rec["y"].astype(np.int64)
        eq = (x == y).all(axis=1)
        t[:n, c.index["cmp"]] = eq
        # inv: 1/(x_i - y_i) mod P at the first differing limb
        diff = x - y
        for r in range(n):
            if not eq[r]:
                i = int(np.argmax(diff[r] != 0))
                t[r, c.index["inv"] + i] = pow(int(diff[r, i]) % P, P - 2, P)
        taken = np.where(rec["op_idx"] == 0, eq, ~eq)
        t[:n, c.index["taken"]] = taken
        t[:n, c.index["to_pc"]] = rec["to_pc"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# BranchLessThan256: BLT/BLTU/BGE/BGEU
# ---------------------------------------------------------------------------


class BranchLt256Air(Air):
    name = "int256_blt"
    OPS = [BranchLessThan256Opcode.BLT, BranchLessThan256Opcode.BLTU,
           BranchLessThan256Opcode.BGE, BranchLessThan256Opcode.BGEU]
    TS_DELTA = 18

    def __init__(self):
        c = self.c = Cols()
        _adapter_cols(c, writes=False)
        c.alloc("f", 4)
        _borrow_lt_cols(c)
        c.alloc("taken"), c.alloc("to_pc")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 4)
        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.exec_receive(b, pc, ts, v)
        x, y, _ = _adapter_eval(b, c, v, pc, ts, opcode, writes=False,
                                first_block_tick=2)
        signed = f[0] + f[2]
        lt = _borrow_lt_eval(b, c, v, signed, x, y)
        taken, to_pc = _m(b, c, "taken"), _m(b, c, "to_pc")
        imm = _m(b, c, "cc")
        b.assert_zero(taken - ((f[0] + f[1]) * lt
                               + (f[2] + f[3]) * (v - lt)))
        b.assert_zero(v * (to_pc - (pc + 4 + taken * (imm - 4))))
        B.exec_send(b, to_pc, ts + self.TS_DELTA, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=False, first_block_tick=2)
        _fill_flags(t, n, c, rec, 4)
        signed_mask = np.isin(rec["op_idx"], (0, 2)).astype(np.uint64)
        lt = _borrow_lt_fill(t, n, c, rec["x"], rec["y"], signed_mask)
        taken = np.where(np.isin(rec["op_idx"], (0, 1)), lt, 1 - lt)
        t[:n, c.index["taken"]] = taken
        t[:n, c.index["to_pc"]] = rec["to_pc"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# Shift256: SLL/SRL/SRA by y[0] bits (0..255)
# ---------------------------------------------------------------------------


class Shift256Air(Air):
    """Byte-decomposed 256-bit shifter (generalizes rv32 ShiftAir).

    s = y[0] (the full low byte; reference shift semantics use
    shift mod 256).  s = sr + 8*sb with sr = bits t0..t2, sb = bits
    t3..t7; sbf[32] is the one-hot byte-shift selector (bools + sum=v +
    index binding, keeping constraint degree <= 3).  Per byte j:
      SLL:     x_j * 2^sr = 256*A_j + B_j
      SRL/SRA: x_j = A_j * 2^sr + B_j
    then z_i combines (A, B) of the source bytes selected by sbf.
    """

    name = "int256_shift"
    OPS = [Shift256Opcode.SLL, Shift256Opcode.SRL, Shift256Opcode.SRA]
    TS_DELTA = 27

    def __init__(self):
        c = self.c = Cols()
        _adapter_cols(c, writes=True)
        c.alloc("f", 3)
        c.alloc("t", 8)
        c.alloc("p01"), c.alloc("pow2sr"), c.alloc("pow2comp")
        c.alloc("A", N), c.alloc("B", N), c.alloc("RC", N)
        c.alloc("sbf", N)
        c.alloc("sign"), c.alloc("signrem")
        c.alloc("fq"), c.alloc("fr"), c.alloc("frc")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 3)
        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True)

        t = _marr(b, c, "t", 8)
        for ti in t:
            b.assert_bool(ti)
        sr = t[0] + 2 * t[1] + 4 * t[2]
        sb = t[3] + 2 * t[4] + 4 * t[5] + 8 * t[6] + 16 * t[7]
        b.assert_zero(v * (y[0] - sr - 8 * sb))

        p01 = _m(b, c, "p01")
        pow2sr = _m(b, c, "pow2sr")
        pow2comp = _m(b, c, "pow2comp")
        b.assert_zero(v * (p01 - (1 + t[0]) * (1 + 3 * t[1])))
        b.assert_zero(v * (pow2sr - p01 * (1 + 15 * t[2])))
        b.assert_zero(v * (pow2sr * pow2comp - 256))

        sbf = _marr(b, c, "sbf", N)
        for s in sbf:
            b.assert_bool(s)
        b.assert_eq(sum(sbf[1:], sbf[0]), v)
        b.assert_zero(sum((k * sbf[k] for k in range(1, N)), 0 * v) - sb)

        sign, signrem = _m(b, c, "sign"), _m(b, c, "signrem")
        b.assert_bool(sign)
        b.assert_zero(f[2] * (x[N - 1] - 128 * sign - signrem))
        b.assert_zero((v - f[2]) * sign)
        B.range_check(b, signrem, 7, f[2])
        fq, fr, frc = _m(b, c, "fq"), _m(b, c, "fr"), _m(b, c, "frc")
        b.assert_zero(fq - f[2] * sign * (pow2comp - 1))
        b.assert_zero(fr - f[2] * sign * (pow2sr - 1))
        b.assert_zero(frc - fr * pow2comp)

        A = _marr(b, c, "A", N)
        Bc = _marr(b, c, "B", N)
        RC = _marr(b, c, "RC", N)
        is_right = f[1] + f[2]
        for j in range(N):
            b.assert_zero(RC[j] - Bc[j] * pow2comp)
            b.assert_zero(f[0] * (x[j] * pow2sr - 256 * A[j] - Bc[j]))
            b.assert_zero(is_right * (x[j] - A[j] * pow2sr - Bc[j]))
            B.range_check(b, A[j], sr, f[0])
            B.range_check(b, Bc[j], 8, f[0])
            B.range_check(b, A[j], 8 - sr, is_right)
            B.range_check(b, Bc[j], sr, is_right)

        for i in range(N):
            left = 0 * v
            right = 0 * v
            for k in range(N):
                src = i - k
                lterm = (Bc[src] if src >= 0 else 0 * v)
                if src - 1 >= 0:
                    lterm = lterm + A[src - 1]
                left = left + sbf[k] * lterm
                rsrc = i + k
                q_t = A[rsrc] if rsrc < N else fq
                rc_t = RC[rsrc + 1] if rsrc + 1 < N else frc
                right = right + sbf[k] * (q_t + rc_t)
            b.assert_zero(f[0] * (z[i] - left))
            b.assert_zero(is_right * (z[i] - right))

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        ix = c.index
        _adapter_fill(t, n, c, rec, writes=True)
        _fill_flags(t, n, c, rec, 3)
        x = rec["x"]
        s = rec["y"][:, 0]
        for i in range(8):
            t[:n, ix["t"] + i] = (s >> i) & 1
        sr = s & 7
        sb = s >> 3
        p2sr = (np.uint64(1) << sr).astype(np.uint64)
        t[:n, ix["p01"]] = (1 + ((s >> 0) & 1)) * (1 + 3 * ((s >> 1) & 1))
        t[:n, ix["pow2sr"]] = p2sr
        t[:n, ix["pow2comp"]] = 256 // p2sr
        sbfc = np.zeros((n, N), dtype=np.uint64)
        sbfc[np.arange(n), sb] = 1
        t[:n, ix["sbf"]:ix["sbf"] + N] = sbfc
        is_sll = rec["op_idx"] == 0
        is_sra = rec["op_idx"] == 2
        sign = ((x[:, N - 1] >> 7) & 1) * is_sra
        t[:n, ix["sign"]] = sign
        t[:n, ix["signrem"]] = np.where(is_sra, x[:, N - 1] - 128 * sign, 0)
        fq = sign * (256 // p2sr - 1)
        fr = sign * (p2sr - 1)
        t[:n, ix["fq"]] = fq
        t[:n, ix["fr"]] = fr
        t[:n, ix["frc"]] = fr * (256 // p2sr)
        A = np.zeros((n, N), dtype=np.uint64)
        Bv = np.zeros((n, N), dtype=np.uint64)
        for j in range(N):
            shifted = x[:, j] * p2sr
            A[:, j] = np.where(is_sll, shifted >> 8, x[:, j] >> sr)
            Bv[:, j] = np.where(is_sll, shifted & 255,
                                x[:, j] & (p2sr - 1))
        t[:n, ix["A"]:ix["A"] + N] = A
        t[:n, ix["B"]:ix["B"] + N] = Bv
        t[:n, ix["RC"]:ix["RC"] + N] = Bv * (256 // p2sr)[:, None]
        return _pad_pow2(t)


INT256_AIRS = {
    "int256_alu": BaseAlu256Air, "int256_lt": LessThan256Air,
    "int256_mul": Mul256Air, "int256_beq": BranchEq256Air,
    "int256_blt": BranchLt256Air, "int256_shift": Shift256Air,
}
