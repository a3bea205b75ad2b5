"""RV32IM executor AIRs + vectorized tracegen.

Copy of openvm_tpu/vm/circuit/rv32im.py (the whole module: every
RV32IM executor chip, not only the eight a fibonacci guest uses), with one
repair: ``HintStoreAir.trace`` sets ``is_buffer`` on a HINT_BUFFER's start
row only, as its constraints ask (ROADMAP.md, F4).

Each chip mirrors a reference chip family (reference extensions/rv32im/circuit
/src/{base_alu,branch_eq,branch_lt,less_than,jal_lui,jalr,auipc,loadstore}/,
SURVEY.md section 2.4) with a re-designed uniform layout: per-row the chip
receives (pc, ts) on the execution bus, sends the fetched instruction on the
program bus, performs its word-granular memory accesses (buses.py helpers),
and sends (to_pc, to_ts).

Records are column-oriented numpy dicts appended by the preflight
interpreter; `trace(records)` computes all derived witness columns
vectorized (carries, comparison markers, byte selects, timestamp diffs).
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..instructions import (BaseAluOpcode, BranchEqualOpcode,
                            BranchLessThanOpcode, DivRemOpcode,
                            LessThanOpcode, MulHOpcode, MulOpcode,
                            Rv32AuipcOpcode, Rv32JalLuiOpcode, Rv32JalrOpcode,
                            Rv32LoadStoreOpcode, ShiftOpcode)
from . import buses as B
from .buses import Cols, limbs_to_u32

P = 2013265921
M32 = 0xFFFFFFFF


def _pad_pow2(rows: np.ndarray, min_h: int = 1) -> np.ndarray:
    n = max(len(rows), min_h)
    h = 1 << (n - 1).bit_length() if n > 1 else 1
    if h == len(rows):
        return rows
    pad = np.zeros((h - len(rows), rows.shape[1]), dtype=np.uint64)
    return np.concatenate([rows, pad], axis=0)


def _ts_diff(prev, now):
    d = now - prev - 1
    return d & 0x7FFF, d >> 15


def _m(b, c: Cols, name, offset=0):
    i = c.index[name]
    return b.main(i, offset)


def _marr(b, c: Cols, name, n, offset=0):
    i = c.index[name]
    return [b.main(i + k, offset) for k in range(n)]


# ---------------------------------------------------------------------------
# BaseAlu: ADD/SUB/XOR/OR/AND (register or immediate rhs)
# ---------------------------------------------------------------------------


class BaseAluAir(Air):
    name = "rv32_base_alu"

    OPS = [BaseAluOpcode.ADD, BaseAluOpcode.SUB, BaseAluOpcode.XOR,
           BaseAluOpcode.OR, BaseAluOpcode.AND]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 5)  # add, sub, xor, or, and
        c.alloc("is_imm")
        c.alloc("a"), c.alloc("b"), c.alloc("cc")  # rd, rs1, rs2-or-imm
        c.alloc("rs1", 4), c.alloc("rs2", 4), c.alloc("rd", 4)
        c.alloc("xorv", 4), c.alloc("carry", 4)
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 5)
        is_imm = _m(b, c, "is_imm")
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        rs1 = _marr(b, c, "rs1", 4)
        rs2 = _marr(b, c, "rs2", 4)
        rd = _marr(b, c, "rd", 4)
        xorv = _marr(b, c, "xorv", 4)
        carry = _marr(b, c, "carry", 4)

        b.assert_bool(v)
        for fi in f:
            b.assert_bool(fi)
        fsum = f[0] + f[1] + f[2] + f[3] + f[4]
        b.assert_eq(fsum, v)
        b.assert_bool(is_imm)
        b.assert_zero(is_imm * (1 - v))

        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        c_field = is_imm * oc + (1 - is_imm) * (4 * oc)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, c_field, 1, 1 - is_imm, 0, 0],
                v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        # immediate decode: rs2 = sign-extended u24 limbs
        b.assert_zero(is_imm * (oc - (rs2[0] + rs2[1] * 256
                                      + rs2[2] * 65536)))
        b.assert_zero(is_imm * rs2[2] * (rs2[2] - 255))
        b.assert_zero(is_imm * (rs2[3] - rs2[2]))

        B.mem_read(b, B.AS_REGISTER, ob, rs1, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, oc, rs2, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v * (1 - is_imm))
        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts + 2,
                    _m(b, c, "dlow"), _m(b, c, "dhiw"), v)

        # add/sub with shared carry columns
        for i in range(4):
            b.assert_bool(carry[i])
            prev_c = carry[i - 1] if i else 0
            b.assert_zero(f[0] * (rs1[i] + rs2[i] + prev_c - rd[i]
                                  - carry[i] * 256))
            b.assert_zero(f[1] * (rs1[i] - rs2[i] - prev_c - rd[i]
                                  + carry[i] * 256))
        # bitwise via xor lookups
        f_bw = f[2] + f[3] + f[4]
        for i in range(4):
            B.xor_lookup(b, rs1[i], rs2[i], xorv[i], f_bw)
            b.assert_zero(f[2] * (rd[i] - xorv[i]))
            b.assert_zero(f[3] * (2 * rd[i] - (rs1[i] + rs2[i] + xorv[i])))
            b.assert_zero(f[4] * (2 * rd[i] - (rs1[i] + rs2[i] - xorv[i])))

    # record fields: pc, ts, op_idx, is_imm, a, b, c, rs1, rs2, rd,
    #                p_ts1, p_ts2, p_tsw, prevw
    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c

        def put(name, val):
            t[:n, c.index[name]] = val

        def putarr(name, val):
            i = c.index[name]
            t[:n, i:i + val.shape[1]] = val

        put("is_valid", 1)
        put("pc", rec["pc"]), put("ts", rec["ts"])
        fcols = np.zeros((n, 5), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        putarr("f", fcols)
        put("is_imm", rec["is_imm"])
        put("a", rec["a"]), put("b", rec["b"]), put("cc", rec["c"])
        putarr("rs1", rec["rs1"]), putarr("rs2", rec["rs2"])
        putarr("rd", rec["rd"])
        putarr("xorv", rec["rs1"].astype(np.uint32)
               ^ rec["rs2"].astype(np.uint32))
        # carries for add/sub
        x, y, z = rec["rs1"], rec["rs2"], rec["rd"]
        carry = np.zeros((n, 4), dtype=np.uint64)
        is_add = rec["op_idx"] == 0
        is_sub = rec["op_idx"] == 1
        cacc = np.zeros(n, dtype=np.uint64)
        for i in range(4):
            tot = x[:, i] + y[:, i] + cacc
            cadd = tot >> 8
            tot_s = x[:, i] - y[:, i] - cacc
            csub = (tot_s >> 63) & 1  # borrow if negative
            cacc = np.where(is_add, cadd, np.where(is_sub, csub, 0))
            carry[:, i] = cacc
        putarr("carry", carry)
        for nm, pts, now_off in (("p_ts1", rec["p_ts1"], 0),
                                 ("p_ts2", rec["p_ts2"], 1),
                                 ("p_tsw", rec["p_tsw"], 2)):
            put(nm, pts)
            lo, hi = _ts_diff(pts, rec["ts"] + now_off)
            put("dlo" + nm[-1].replace("_", ""), lo)
            put("dhi" + nm[-1].replace("_", ""), hi)
        putarr("prevw", rec["prevw"])
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# LessThan: SLT/SLTU (writes rd = lt)
# ---------------------------------------------------------------------------


def _lt_core_cols(c: Cols):
    c.alloc("marker", 4)
    c.alloc("lt")
    c.alloc("sign1"), c.alloc("sign2"), c.alloc("rem1"), c.alloc("rem2")
    c.alloc("diffv"), c.alloc("absdiff")


def _lt_core_eval(b, c, signed, rs1, rs2, v):
    """Shared unsigned/signed limb comparison; returns lt expr (the col)."""
    marker = _marr(b, c, "marker", 4)
    lt = _m(b, c, "lt")
    s1, s2 = _m(b, c, "sign1"), _m(b, c, "sign2")
    r1, r2 = _m(b, c, "rem1"), _m(b, c, "rem2")
    diffv, absdiff = _m(b, c, "diffv"), _m(b, c, "absdiff")

    for mi in marker:
        b.assert_bool(mi)
    msum = marker[0] + marker[1] + marker[2] + marker[3]
    b.assert_zero(msum * (msum - 1))
    b.assert_bool(lt)
    b.assert_bool(s1)
    b.assert_bool(s2)
    # sign decomposition of top limbs (only when signed)
    b.assert_zero(signed * (rs1[3] - 128 * s1 - r1))
    b.assert_zero(signed * (rs2[3] - 128 * s2 - r2))
    b.assert_zero((v - signed) * s1)
    b.assert_zero((v - signed) * s2)
    B.range_check(b, r1, 7, signed)
    B.range_check(b, r2, 7, signed)

    # comparison keys: top limb gets +128-256*sign when signed
    kx = list(rs1)
    ky = list(rs2)
    kx[3] = rs1[3] + signed * 128 - 256 * s1
    ky[3] = rs2[3] + signed * 128 - 256 * s2

    # limbs above the marker are equal
    for i in range(4):
        for j in range(i + 1, 4):
            b.assert_zero(marker[i] * (kx[j] - ky[j]))
    b.assert_zero(diffv - (marker[0] * (ky[0] - kx[0])
                           + marker[1] * (ky[1] - kx[1])
                           + marker[2] * (ky[2] - kx[2])
                           + marker[3] * (ky[3] - kx[3])))
    b.assert_zero((1 - msum) * lt)
    b.assert_zero(absdiff - (2 * lt - 1) * diffv)
    B.range_check(b, absdiff - 1 + (1 - msum), 8, v)
    return lt


def _lt_core_trace(t, n, c: Cols, x, y, signed_mask):
    """Fill comparison witness columns; returns lt bool array."""
    s1 = (x[:, 3] >> 7) & signed_mask
    s2 = (y[:, 3] >> 7) & signed_mask
    r1 = np.where(signed_mask, x[:, 3] - 128 * s1, x[:, 3])
    r2 = np.where(signed_mask, y[:, 3] - 128 * s2, y[:, 3])
    kx = x.astype(np.int64).copy()
    ky = y.astype(np.int64).copy()
    kx[:, 3] = np.where(signed_mask, kx[:, 3] + 128 - 256 * s1.astype(np.int64), kx[:, 3])
    ky[:, 3] = np.where(signed_mask, ky[:, 3] + 128 - 256 * s2.astype(np.int64), ky[:, 3])
    marker = np.zeros((n, 4), dtype=np.uint64)
    diffv = np.zeros(n, dtype=np.int64)
    lt = np.zeros(n, dtype=np.uint64)
    neq = np.zeros(n, dtype=bool)
    for i in range(3, -1, -1):
        d = ky[:, i] - kx[:, i]
        hit = (~neq) & (d != 0)
        marker[hit, i] = 1
        diffv[hit] = d[hit]
        lt[hit] = (d[hit] > 0).astype(np.uint64)
        neq |= d != 0
    absd = np.abs(diffv).astype(np.uint64)
    t[:n, c.index["marker"]:c.index["marker"] + 4] = marker
    t[:n, c.index["lt"]] = lt
    t[:n, c.index["sign1"]] = s1
    t[:n, c.index["sign2"]] = s2
    t[:n, c.index["rem1"]] = r1
    t[:n, c.index["rem2"]] = r2
    t[:n, c.index["diffv"]] = diffv % P
    t[:n, c.index["absdiff"]] = absd
    return lt


class LessThanAir(Air):
    name = "rv32_less_than"
    OPS = [LessThanOpcode.SLT, LessThanOpcode.SLTU]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 2)  # slt, sltu
        c.alloc("is_imm")
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("rs1", 4), c.alloc("rs2", 4)
        _lt_core_cols(c)
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 2)
        is_imm = _m(b, c, "is_imm")
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        rs1 = _marr(b, c, "rs1", 4)
        rs2 = _marr(b, c, "rs2", 4)

        b.assert_bool(v)
        b.assert_bool(f[0])
        b.assert_bool(f[1])
        b.assert_eq(f[0] + f[1], v)
        b.assert_bool(is_imm)

        opcode = f[0] * self.OPS[0] + f[1] * self.OPS[1]
        c_field = is_imm * oc + (1 - is_imm) * (4 * oc)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, c_field, 1, 1 - is_imm, 0, 0],
                v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        b.assert_zero(is_imm * (oc - (rs2[0] + rs2[1] * 256
                                      + rs2[2] * 65536)))
        b.assert_zero(is_imm * rs2[2] * (rs2[2] - 255))
        b.assert_zero(is_imm * (rs2[3] - rs2[2]))

        B.mem_read(b, B.AS_REGISTER, ob, rs1, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, oc, rs2, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v * (1 - is_imm))

        lt = _lt_core_eval(b, c, f[0], rs1, rs2, v)
        B.mem_write(b, B.AS_REGISTER, oa, [lt, 0, 0, 0],
                    _marr(b, c, "prevw", 4), _m(b, c, "p_tsw"), ts + 2,
                    _m(b, c, "dlow"), _m(b, c, "dhiw"), v, check_bytes=False)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        t[:n, c.index["ts"]] = rec["ts"]
        fcols = np.zeros((n, 2), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 2] = fcols
        t[:n, c.index["is_imm"]] = rec["is_imm"]
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["cc"]] = rec["c"]
        t[:n, c.index["rs1"]:c.index["rs1"] + 4] = rec["rs1"]
        t[:n, c.index["rs2"]:c.index["rs2"] + 4] = rec["rs2"]
        _lt_core_trace(t, n, c, rec["rs1"], rec["rs2"],
                       (rec["op_idx"] == 0).astype(np.uint64))
        for nm, pts, off in (("1", rec["p_ts1"], 0), ("2", rec["p_ts2"], 1),
                             ("w", rec["p_tsw"], 2)):
            t[:n, c.index["p_ts" + nm]] = pts
            lo, hi = _ts_diff(pts, rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo
            t[:n, c.index["dhi" + nm]] = hi
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# BranchEqual: BEQ/BNE
# ---------------------------------------------------------------------------


class BranchEqAir(Air):
    name = "rv32_branch_eq"
    OPS = [BranchEqualOpcode.BEQ, BranchEqualOpcode.BNE]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 2)  # beq, bne
        c.alloc("a"), c.alloc("b"), c.alloc("imm")
        c.alloc("rs1", 4), c.alloc("rs2", 4)
        c.alloc("cmp"), c.alloc("inv", 4), c.alloc("to_pc"), c.alloc("taken")
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 2)
        oa, ob, imm = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "imm")
        rs1 = _marr(b, c, "rs1", 4)
        rs2 = _marr(b, c, "rs2", 4)
        cmp = _m(b, c, "cmp")
        inv = _marr(b, c, "inv", 4)
        to_pc = _m(b, c, "to_pc")

        b.assert_bool(v)
        b.assert_bool(f[0])
        b.assert_bool(f[1])
        b.assert_eq(f[0] + f[1], v)
        b.assert_bool(cmp)
        for i in range(4):
            b.assert_zero(cmp * (rs1[i] - rs2[i]))
        eqsum = sum((inv[i] * (rs1[i] - rs2[i]) for i in range(4)), 0 * v)
        b.assert_zero(v * (eqsum - (1 - cmp)))

        opcode = f[0] * self.OPS[0] + f[1] * self.OPS[1]
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, imm, 1, 1, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        taken = _m(b, c, "taken")
        b.assert_zero(taken - (f[0] * cmp + f[1] * (1 - cmp)))
        b.assert_zero(v * (to_pc - (pc + taken * imm + (1 - taken) * 4)))
        B.exec_send(b, to_pc, ts + 2, v)

        B.mem_read(b, B.AS_REGISTER, oa, rs1, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, ob, rs2, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        t[:n, c.index["ts"]] = rec["ts"]
        fcols = np.zeros((n, 2), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 2] = fcols
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["imm"]] = rec["imm"]
        x, y = rec["rs1"], rec["rs2"]
        t[:n, c.index["rs1"]:c.index["rs1"] + 4] = x
        t[:n, c.index["rs2"]:c.index["rs2"] + 4] = y
        eq = (x == y).all(axis=1)
        t[:n, c.index["cmp"]] = eq
        # inverse marker: first differing limb gets inverse of diff
        inv = np.zeros((n, 4), dtype=np.uint64)
        done = eq.copy()
        for i in range(4):
            d = (x[:, i].astype(np.int64) - y[:, i].astype(np.int64)) % P
            hit = (~done) & (d != 0)
            idxs = np.nonzero(hit)[0]
            for j in idxs:
                inv[j, i] = pow(int(d[j]), -1, P)
            done |= hit
        t[:n, c.index["inv"]:c.index["inv"] + 4] = inv
        t[:n, c.index["to_pc"]] = rec["to_pc"]
        t[:n, c.index["taken"]] = np.where(rec["op_idx"] == 0, eq, ~eq)
        for nm, pts, off in (("1", rec["p_ts1"], 0), ("2", rec["p_ts2"], 1)):
            t[:n, c.index["p_ts" + nm]] = pts
            lo, hi = _ts_diff(pts, rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo
            t[:n, c.index["dhi" + nm]] = hi
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# BranchLessThan: BLT/BLTU/BGE/BGEU
# ---------------------------------------------------------------------------


class BranchLtAir(Air):
    name = "rv32_branch_lt"
    OPS = [BranchLessThanOpcode.BLT, BranchLessThanOpcode.BLTU,
           BranchLessThanOpcode.BGE, BranchLessThanOpcode.BGEU]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 4)  # blt, bltu, bge, bgeu
        c.alloc("a"), c.alloc("b"), c.alloc("imm")
        c.alloc("rs1", 4), c.alloc("rs2", 4)
        _lt_core_cols(c)
        c.alloc("to_pc"), c.alloc("taken")
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 4)
        oa, ob, imm = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "imm")
        rs1 = _marr(b, c, "rs1", 4)
        rs2 = _marr(b, c, "rs2", 4)
        to_pc = _m(b, c, "to_pc")

        b.assert_bool(v)
        for fi in f:
            b.assert_bool(fi)
        b.assert_eq(f[0] + f[1] + f[2] + f[3], v)

        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, imm, 1, 1, 0, 0], v)
        B.exec_receive(b, pc, ts, v)

        signed = f[0] + f[2]
        lt = _lt_core_eval(b, c, signed, rs1, rs2, v)
        taken = _m(b, c, "taken")
        b.assert_zero(taken - ((f[0] + f[1]) * lt
                               + (f[2] + f[3]) * (1 - lt)))
        b.assert_zero(v * (to_pc - (pc + taken * imm + (1 - taken) * 4)))
        B.exec_send(b, to_pc, ts + 2, v)

        B.mem_read(b, B.AS_REGISTER, oa, rs1, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, ob, rs2, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        t[:n, c.index["ts"]] = rec["ts"]
        fcols = np.zeros((n, 4), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 4] = fcols
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["imm"]] = rec["imm"]
        t[:n, c.index["rs1"]:c.index["rs1"] + 4] = rec["rs1"]
        t[:n, c.index["rs2"]:c.index["rs2"] + 4] = rec["rs2"]
        signed = ((rec["op_idx"] == 0) | (rec["op_idx"] == 2)).astype(
            np.uint64)
        lt = _lt_core_trace(t, n, c, rec["rs1"], rec["rs2"], signed)
        t[:n, c.index["to_pc"]] = rec["to_pc"]
        t[:n, c.index["taken"]] = np.where(rec["op_idx"] < 2, lt, 1 - lt)
        for nm, pts, off in (("1", rec["p_ts1"], 0), ("2", rec["p_ts2"], 1)):
            t[:n, c.index["p_ts" + nm]] = pts
            lo, hi = _ts_diff(pts, rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo
            t[:n, c.index["dhi" + nm]] = hi
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# JalLui: JAL/LUI
# ---------------------------------------------------------------------------


class JalLuiAir(Air):
    name = "rv32_jal_lui"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 2)  # jal, lui
        c.alloc("a"), c.alloc("imm"), c.alloc("needs_write")
        c.alloc("rd", 4), c.alloc("to_pc")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 2)
        oa, imm = _m(b, c, "a"), _m(b, c, "imm")
        nw = _m(b, c, "needs_write")
        rd = _marr(b, c, "rd", 4)
        to_pc = _m(b, c, "to_pc")

        b.assert_bool(v)
        b.assert_bool(f[0])
        b.assert_bool(f[1])
        b.assert_eq(f[0] + f[1], v)
        b.assert_bool(nw)
        b.assert_zero(f[1] * (1 - nw))  # LUI always writes

        opcode = f[0] * Rv32JalLuiOpcode.JAL + f[1] * Rv32JalLuiOpcode.LUI
        B.fetch(b, pc, opcode, [4 * oa, 0, imm, 1, 0, nw, 0], v)
        B.exec_receive(b, pc, ts, v)
        b.assert_zero(f[0] * (to_pc - (pc + imm)))
        b.assert_zero(f[1] * (to_pc - (pc + 4)))
        B.exec_send(b, to_pc, ts + 1, v)

        rd_val = limbs_to_u32(rd)
        b.assert_zero(f[0] * nw * (rd_val - (pc + 4)))
        B.range_check(b, rd[3], 6, f[0] * nw)  # pc+4 < 2^30
        b.assert_zero(f[1] * (rd_val - imm * 4096))
        b.assert_zero(f[1] * rd[0])

        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), nw)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        t[:n, c.index["ts"]] = rec["ts"]
        fcols = np.zeros((n, 2), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 2] = fcols
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["imm"]] = rec["imm"]
        t[:n, c.index["needs_write"]] = rec["needs_write"]
        t[:n, c.index["rd"]:c.index["rd"] + 4] = rec["rd"]
        t[:n, c.index["to_pc"]] = rec["to_pc"]
        t[:n, c.index["p_tsw"]] = rec["p_tsw"]
        lo, hi = _ts_diff(rec["p_tsw"], rec["ts"])
        nw = rec["needs_write"].astype(bool)
        t[:n, c.index["dlow"]] = np.where(nw, lo, 0)
        t[:n, c.index["dhiw"]] = np.where(nw, hi, 0)
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# Jalr
# ---------------------------------------------------------------------------


class JalrAir(Air):
    name = "rv32_jalr"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("a"), c.alloc("b"), c.alloc("cc"), c.alloc("g")
        c.alloc("needs_write")
        c.alloc("rs1", 4), c.alloc("rd", 4)
        c.alloc("to_pc"), c.alloc("lsb"), c.alloc("wrap")
        c.alloc("tp_lo"), c.alloc("tp_hi")
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        oa, ob = _m(b, c, "a"), _m(b, c, "b")
        oc, og = _m(b, c, "cc"), _m(b, c, "g")
        nw = _m(b, c, "needs_write")
        rs1 = _marr(b, c, "rs1", 4)
        rd = _marr(b, c, "rd", 4)
        to_pc = _m(b, c, "to_pc")
        lsb = _m(b, c, "lsb")
        wrap = _m(b, c, "wrap")

        b.assert_bool(v)
        b.assert_bool(nw)
        b.assert_bool(og)
        b.assert_bool(lsb)
        b.assert_zero(wrap * (wrap - 1) * (wrap + 1))
        b.assert_zero(nw * (1 - v))

        B.fetch(b, pc, Rv32JalrOpcode.JALR, [4 * oa, 4 * ob, oc, 1, 0, nw,
                                             og], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, to_pc, ts + 2, v)

        # to_pc + lsb + wrap*2^32 = rs1_val + (c - g*2^16)
        imm_v = oc - og * 65536
        b.assert_zero(v * (to_pc + lsb + wrap * (1 << 32)
                           - limbs_to_u32(rs1) - imm_v))
        B.range_check(b, _m(b, c, "tp_lo"), 15, v)
        B.range_check(b, _m(b, c, "tp_hi"), 15, v)
        b.assert_zero(v * (to_pc - _m(b, c, "tp_lo")
                           - _m(b, c, "tp_hi") * (1 << 15)))

        rd_val = limbs_to_u32(rd)
        b.assert_zero(nw * (rd_val - (pc + 4)))
        B.range_check(b, rd[3], 6, nw)

        B.mem_read(b, B.AS_REGISTER, ob, rs1, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts + 1, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), nw)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "b", "g", "needs_write", "to_pc",
                   "lsb", "p_ts1", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["cc"]] = rec["c"]
        t[:n, c.index["rs1"]:c.index["rs1"] + 4] = rec["rs1"]
        t[:n, c.index["rd"]:c.index["rd"] + 4] = rec["rd"]
        # wrap: to_pc + lsb + wrap*2^32 == rs1_val + c - g*2^16 (ints)
        rs1v = (rec["rs1"] * (1 << (8 * np.arange(4, dtype=np.uint64)))
                ).sum(axis=1)
        target = rs1v.astype(np.int64) + rec["c"].astype(np.int64) \
            - rec["g"].astype(np.int64) * 65536
        wrap = (target - rec["to_pc"].astype(np.int64)
                - rec["lsb"].astype(np.int64)) // (1 << 32)
        t[:n, c.index["wrap"]] = wrap % P
        t[:n, c.index["tp_lo"]] = rec["to_pc"] & 0x7FFF
        t[:n, c.index["tp_hi"]] = rec["to_pc"] >> 15
        lo, hi = _ts_diff(rec["p_ts1"], rec["ts"])
        t[:n, c.index["dlo1"]] = lo
        t[:n, c.index["dhi1"]] = hi
        nw = rec["needs_write"].astype(bool)
        lo, hi = _ts_diff(rec["p_tsw"], rec["ts"] + 1)
        t[:n, c.index["dlow"]] = np.where(nw, lo, 0)
        t[:n, c.index["dhiw"]] = np.where(nw, hi, 0)
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# Auipc
# ---------------------------------------------------------------------------


class AuipcAir(Air):
    """rd = pc + (imm << 8) wrapping mod 2^32, computed limb-wise with
    boolean carries (reference Rv32AuipcCoreAir,
    extensions/rv32im/circuit/src/auipc/core.rs:81-135): a single
    field-element identity both fails on u32 wraparound (real linker
    immediates) and aliases mod P.  rd[0] = pc byte 0 since imm<<8 has a
    zero low byte; pc's top byte is derived from the decomposition and
    range-checked to 6 bits (pc < 2^30)."""
    name = "rv32_auipc"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("a"), c.alloc("imm")
        c.alloc("rd", 4)
        c.alloc("il", 3), c.alloc("pl", 2)
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        oa, imm = _m(b, c, "a"), _m(b, c, "imm")
        rd = _marr(b, c, "rd", 4)
        il = _marr(b, c, "il", 3)
        pl = _marr(b, c, "pl", 2)

        b.assert_bool(v)
        B.fetch(b, pc, Rv32AuipcOpcode.AUIPC, [4 * oa, 0, imm, 1, 0, 0, 0],
                v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 1, v)

        # bind the witness limbs: imm (24-bit operand) and pc bytes 1..2;
        # pc byte 3 is derived, byte 0 is rd[0]
        b.assert_zero(v * (imm - il[0] - il[1] * 256 - il[2] * 65536))
        inv24 = pow(1 << 24, -1, P)
        pmsl = (pc - rd[0] - pl[0] * 256 - pl[1] * 65536) * inv24
        # limb-wise addition rd = pc + imm*256 with boolean carries; the
        # final carry is dropped (wrap mod 2^32)
        inv8 = pow(256, -1, P)
        c1 = (pl[0] + il[0] - rd[1]) * inv8
        c2 = (pl[1] + il[1] + c1 - rd[2]) * inv8
        c3 = (pmsl + il[2] + c2 - rd[3]) * inv8
        for cy in (c1, c2, c3):
            b.assert_zero(v * cy * (cy - 1))

        B.byte_pair_check(b, il[0], il[1], v)
        B.byte_pair_check(b, il[2], pl[0], v)
        B.byte_pair_check(b, pl[1], rd[0], v)
        B.byte_pair_check(b, rd[1], rd[2], v)
        B.byte_pair_check(b, rd[3], 0, v)
        B.range_check(b, pmsl, 6, v)

        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "imm", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["rd"]:c.index["rd"] + 4] = rec["rd"]
        imm = np.asarray(rec["imm"], dtype=np.uint64)
        pc_ = np.asarray(rec["pc"], dtype=np.uint64)
        for k in range(3):
            t[:n, c.index["il"] + k] = (imm >> (8 * k)) & 0xFF
        t[:n, c.index["pl"] + 0] = (pc_ >> 8) & 0xFF
        t[:n, c.index["pl"] + 1] = (pc_ >> 16) & 0xFF
        lo, hi = _ts_diff(rec["p_tsw"], rec["ts"])
        t[:n, c.index["dlow"]] = lo
        t[:n, c.index["dhiw"]] = hi
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# LoadStore: LOADW/LOADBU/LOADHU/STOREW/STOREH/STOREB (addr spaces 2 and 3)
# ---------------------------------------------------------------------------


class LoadStoreAir(Air):
    name = "rv32_load_store"
    OPS = [Rv32LoadStoreOpcode.LOADW, Rv32LoadStoreOpcode.LOADBU,
           Rv32LoadStoreOpcode.LOADHU, Rv32LoadStoreOpcode.STOREW,
           Rv32LoadStoreOpcode.STOREH, Rv32LoadStoreOpcode.STOREB,
           Rv32LoadStoreOpcode.LOADB, Rv32LoadStoreOpcode.LOADH]
    NUM_PV_WORDS_BITS = 3  # log2 of PublicValuesAir.num_words

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 8)  # lw, lbu, lhu, sw, sh, sb, lb, lh
        c.alloc("a"), c.alloc("b"), c.alloc("cc"), c.alloc("g")
        c.alloc("e_as"), c.alloc("needs_write")
        c.alloc("rs1", 4)
        c.alloc("word_addr"), c.alloc("s0"), c.alloc("s1"), c.alloc("wrap")
        c.alloc("wa_lo"), c.alloc("wa_hi")
        c.alloc("sel", 4)
        c.alloc("pbs"), c.alloc("pbr"), c.alloc("phs"), c.alloc("phr")
        c.alloc("data2", 4)  # loads: mem word; stores: reg value
        c.alloc("new3", 4)  # written word (loads: rd; stores: merged mem)
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 8)
        oa, ob = _m(b, c, "a"), _m(b, c, "b")
        oc, og = _m(b, c, "cc"), _m(b, c, "g")
        e_as = _m(b, c, "e_as")
        nw = _m(b, c, "needs_write")
        rs1 = _marr(b, c, "rs1", 4)
        wa = _m(b, c, "word_addr")
        s0, s1 = _m(b, c, "s0"), _m(b, c, "s1")
        wrap = _m(b, c, "wrap")
        sel = _marr(b, c, "sel", 4)
        d2 = _marr(b, c, "data2", 4)
        new3 = _marr(b, c, "new3", 4)
        prevw = _marr(b, c, "prevw", 4)

        b.assert_bool(v)
        for fi in f:
            b.assert_bool(fi)
        b.assert_eq(sum(f[1:], f[0]), v)
        b.assert_bool(nw)
        b.assert_bool(og)
        b.assert_bool(s0)
        b.assert_bool(s1)
        b.assert_zero(wrap * (wrap - 1) * (wrap + 1))
        is_load = f[0] + f[1] + f[2] + f[6] + f[7]
        is_store = f[3] + f[4] + f[5]
        # stores always write (transpiler sets f=1); e_as in {2,3}
        b.assert_zero(is_store * (1 - nw))
        b.assert_zero(v * (e_as - 2) * (e_as - 3))
        is_pv = e_as - 2
        b.assert_zero(is_load * is_pv)  # loads only from AS 2

        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, oc, 1, e_as, nw, og], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        # address decomposition: 4*wa + s0 + 2*s1 + wrap*2^32 = rs1 + imm
        imm_v = oc - og * 65536
        b.assert_zero(v * (4 * wa + s0 + 2 * s1 + wrap * (1 << 32)
                           - limbs_to_u32(rs1) - imm_v))
        b.assert_zero(v * (wa - _m(b, c, "wa_lo")
                           - _m(b, c, "wa_hi") * (1 << 15)))
        B.range_check(b, _m(b, c, "wa_lo"), 15, v)
        B.range_check(b, _m(b, c, "wa_hi"), 12, v)
        B.range_check(b, wa, self.NUM_PV_WORDS_BITS, v * is_pv)

        # alignment
        b.assert_zero((f[0] + f[3]) * s0)
        b.assert_zero((f[0] + f[3]) * s1)
        b.assert_zero((f[2] + f[4] + f[7]) * s0)

        # byte select flags (gated: padding rows have all-zero sel)
        b.assert_zero(v * (sel[0] - (1 - s0) * (1 - s1)))
        b.assert_zero(v * (sel[1] - s0 * (1 - s1)))
        b.assert_zero(v * (sel[2] - (1 - s0) * s1))
        b.assert_zero(v * (sel[3] - s0 * s1))

        # slot 1: read rs1
        B.mem_read(b, B.AS_REGISTER, ob, rs1, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        # slot 2: loads read mem word; stores read the source register
        as2 = is_load * 2 + is_store * 1
        addr2 = is_load * wa + is_store * oa
        B.mem_read(b, as2, addr2, d2, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v)
        # slot 3: loads write rd (gated); stores write the mem word
        as3 = is_load * 1 + is_store * e_as
        addr3 = is_load * oa + is_store * wa
        B.mem_write(b, as3, addr3, new3, prevw, _m(b, c, "p_tsw"), ts + 2,
                    _m(b, c, "dlow"), _m(b, c, "dhiw"), nw)

        # load semantics
        for i in range(4):
            b.assert_zero(f[0] * (new3[i] - d2[i]))
        picked = (sel[0] * d2[0] + sel[1] * d2[1] + sel[2] * d2[2]
                  + sel[3] * d2[3])
        b.assert_zero(f[1] * (new3[0] - picked))
        for i in (1, 2, 3):
            b.assert_zero(f[1] * new3[i])
        half = (1 - s1) * (d2[0] + 256 * d2[1]) + s1 * (d2[2] + 256 * d2[3])
        b.assert_zero(f[2] * (new3[0] + 256 * new3[1] - half))
        b.assert_zero(f[2] * new3[2])
        b.assert_zero(f[2] * new3[3])
        # sign-extending loads: LOADB picks a byte, LOADH a halfword; the
        # sign bit of the picked value fills the upper limbs with 0xFF
        pbs, pbr = _m(b, c, "pbs"), _m(b, c, "pbr")
        phs, phr = _m(b, c, "phs"), _m(b, c, "phr")
        b.assert_bool(pbs)
        b.assert_bool(phs)
        b.assert_zero(f[6] * (new3[0] - picked))
        b.assert_zero(f[6] * (new3[0] - 128 * pbs - pbr))
        B.range_check(b, pbr, 7, f[6])
        for i in (1, 2, 3):
            b.assert_zero(f[6] * (new3[i] - 255 * pbs))
        b.assert_zero(f[7] * (new3[0] + 256 * new3[1] - half))
        b.assert_zero(f[7] * (new3[1] - 128 * phs - phr))
        B.range_check(b, phr, 7, f[7])
        b.assert_zero(f[7] * (new3[2] - 255 * phs))
        b.assert_zero(f[7] * (new3[3] - 255 * phs))

        # store semantics (d2 = register value, prevw = previous mem word)
        for i in range(4):
            b.assert_zero(f[3] * (new3[i] - d2[i]))
            b.assert_zero(f[5] * (new3[i] - sel[i] * d2[0]
                                  - (1 - sel[i]) * prevw[i]))
        b.assert_zero(f[4] * (new3[0] - (1 - s1) * d2[0] - s1 * prevw[0]))
        b.assert_zero(f[4] * (new3[1] - (1 - s1) * d2[1] - s1 * prevw[1]))
        b.assert_zero(f[4] * (new3[2] - s1 * d2[0] - (1 - s1) * prevw[2]))
        b.assert_zero(f[4] * (new3[3] - s1 * d2[1] - (1 - s1) * prevw[3]))

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "b", "g", "e_as", "needs_write",
                   "word_addr", "s0", "s1", "p_ts1", "p_ts2", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["cc"]] = rec["c"]
        fcols = np.zeros((n, 8), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 8] = fcols
        new3 = rec["new3"]
        is_lb = rec["op_idx"] == 6
        is_lh = rec["op_idx"] == 7
        pbs = np.where(is_lb, new3[:, 0] >> 7, 0)
        t[:n, c.index["pbs"]] = pbs
        t[:n, c.index["pbr"]] = np.where(is_lb, new3[:, 0] - 128 * pbs, 0)
        phs = np.where(is_lh, new3[:, 1] >> 7, 0)
        t[:n, c.index["phs"]] = phs
        t[:n, c.index["phr"]] = np.where(is_lh, new3[:, 1] - 128 * phs, 0)
        t[:n, c.index["rs1"]:c.index["rs1"] + 4] = rec["rs1"]
        rs1v = (rec["rs1"] * (1 << (8 * np.arange(4, dtype=np.uint64)))
                ).sum(axis=1)
        target = rs1v.astype(np.int64) + rec["c"].astype(np.int64) \
            - rec["g"].astype(np.int64) * 65536
        full = 4 * rec["word_addr"].astype(np.int64) \
            + rec["s0"].astype(np.int64) + 2 * rec["s1"].astype(np.int64)
        wrap = (target - full) // (1 << 32)
        t[:n, c.index["wrap"]] = wrap % P
        t[:n, c.index["wa_lo"]] = rec["word_addr"] & 0x7FFF
        t[:n, c.index["wa_hi"]] = rec["word_addr"] >> 15
        s0, s1 = rec["s0"], rec["s1"]
        selc = np.stack([(1 - s0) * (1 - s1), s0 * (1 - s1), (1 - s0) * s1,
                         s0 * s1], axis=1)
        t[:n, c.index["sel"]:c.index["sel"] + 4] = selc
        t[:n, c.index["data2"]:c.index["data2"] + 4] = rec["data2"]
        t[:n, c.index["new3"]:c.index["new3"] + 4] = rec["new3"]
        for nm, off in (("1", 0), ("2", 1)):
            lo, hi = _ts_diff(rec["p_ts" + nm], rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo
            t[:n, c.index["dhi" + nm]] = hi
        nwm = rec["needs_write"].astype(bool)
        lo, hi = _ts_diff(rec["p_tsw"], rec["ts"] + 2)
        t[:n, c.index["dlow"]] = np.where(nwm, lo, 0)
        t[:n, c.index["dhiw"]] = np.where(nwm, hi, 0)
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# Shift: SLL/SRL/SRA
# ---------------------------------------------------------------------------


class ShiftAir(Air):
    """Byte-decomposed shifter.

    s = rs2[0] mod 32 with bit decomposition t0..t4; sr = s mod 8 (sub-byte),
    sb = s div 8 (byte shift, one-hot sbflag).  Per byte j the witness holds
    the split (A_j, B_j):
      SLL:      x_j * 2^sr = 256*A_j + B_j   (A_j < 2^sr, B_j byte)
      SRL/SRA:  x_j = A_j * 2^sr + B_j       (B_j < 2^sr, A_j < 2^(8-sr))
    Variable-width bounds ride the (value, bits) range bus with bits as a
    degree-1 expression — a TPU-native generalization of the reference's
    ShiftCoreAir bit gymnastics (extensions/rv32im/circuit/src/shift/).
    """

    name = "rv32_shift"
    OPS = [ShiftOpcode.SLL, ShiftOpcode.SRL, ShiftOpcode.SRA]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 3)  # sll, srl, sra
        c.alloc("is_imm")
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("rs1", 4), c.alloc("rs2", 4), c.alloc("rd", 4)
        c.alloc("t", 5)       # shift-amount bits
        c.alloc("srem")       # rs2[0] = s + 32*srem
        c.alloc("p01"), c.alloc("pow2sr"), c.alloc("pow2comp")
        c.alloc("A", 4), c.alloc("B", 4), c.alloc("RC", 4)
        c.alloc("sbf", 4)     # one-hot byte-shift
        c.alloc("sign"), c.alloc("signrem")
        c.alloc("fq"), c.alloc("fr"), c.alloc("frc")  # SRA fill bytes
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 3)
        is_imm = _m(b, c, "is_imm")
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        x = _marr(b, c, "rs1", 4)
        rs2 = _marr(b, c, "rs2", 4)
        rd = _marr(b, c, "rd", 4)
        t = _marr(b, c, "t", 5)
        srem = _m(b, c, "srem")
        pow2sr = _m(b, c, "pow2sr")
        pow2comp = _m(b, c, "pow2comp")
        A = _marr(b, c, "A", 4)
        Bc = _marr(b, c, "B", 4)
        sbf = _marr(b, c, "sbf", 4)
        sign, signrem = _m(b, c, "sign"), _m(b, c, "signrem")
        fq, fr = _m(b, c, "fq"), _m(b, c, "fr")

        b.assert_bool(v)
        for fi in f:
            b.assert_bool(fi)
        b.assert_eq(f[0] + f[1] + f[2], v)
        b.assert_bool(is_imm)
        for ti in t:
            b.assert_bool(ti)

        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        c_field = is_imm * oc + (1 - is_imm) * (4 * oc)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, c_field, 1, 1 - is_imm, 0, 0],
                v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        # imm: rs2 = [shamt, 0, 0, 0]
        b.assert_zero(is_imm * (rs2[0] - oc))
        for i in (1, 2, 3):
            b.assert_zero(is_imm * rs2[i])

        s = t[0] + 2 * t[1] + 4 * t[2] + 8 * t[3] + 16 * t[4]
        sr = t[0] + 2 * t[1] + 4 * t[2]
        b.assert_zero(v * (rs2[0] - s - 32 * srem))
        B.range_check(b, srem, 3, v)
        p01 = _m(b, c, "p01")
        b.assert_zero(v * (p01 - (1 + t[0]) * (1 + 3 * t[1])))
        b.assert_zero(v * (pow2sr - p01 * (1 + 15 * t[2])))
        b.assert_zero(v * (pow2sr * pow2comp - 256))

        # byte-shift one-hot
        b.assert_zero(v * (sbf[0] - (1 - t[3]) * (1 - t[4])))
        b.assert_zero(v * (sbf[1] - t[3] * (1 - t[4])))
        b.assert_zero(v * (sbf[2] - (1 - t[3]) * t[4]))
        b.assert_zero(v * (sbf[3] - t[3] * t[4]))

        # sign of x (for SRA)
        b.assert_bool(sign)
        b.assert_zero(f[2] * (x[3] - 128 * sign - signrem))
        b.assert_zero((v - f[2]) * sign)
        B.range_check(b, signrem, 7, f[2])
        # fill bytes: fq = sra_sign*(2^(8-sr)-1), fr = sra_sign*(2^sr-1)
        b.assert_zero(fq - f[2] * sign * (pow2comp - 1))
        b.assert_zero(fr - f[2] * sign * (pow2sr - 1))
        frc = _m(b, c, "frc")
        b.assert_zero(frc - fr * pow2comp)
        RC = _marr(b, c, "RC", 4)
        for j in range(4):
            b.assert_zero(RC[j] - Bc[j] * pow2comp)

        is_right = f[1] + f[2]
        for j in range(4):
            b.assert_zero(f[0] * (x[j] * pow2sr - 256 * A[j] - Bc[j]))
            b.assert_zero(is_right * (x[j] - A[j] * pow2sr - Bc[j]))
            # SLL: A_j < 2^sr, B_j byte; right: A_j < 2^(8-sr), B_j < 2^sr
            B.range_check(b, A[j], sr, f[0])
            B.range_check(b, Bc[j], 8, f[0])
            B.range_check(b, A[j], 8 - sr, is_right)
            B.range_check(b, Bc[j], sr, is_right)

        # result bytes
        for i in range(4):
            left = 0 * v
            for bsh in range(4):
                src = i - bsh
                term = (Bc[src] if src >= 0 else 0 * v)
                if src - 1 >= 0:
                    term = term + A[src - 1]
                left = left + sbf[bsh] * term
            b.assert_zero(f[0] * (rd[i] - left))

            right = 0 * v
            for bsh in range(4):
                src = i + bsh
                q_t = A[src] if src < 4 else fq
                rc_t = RC[src + 1] if src + 1 < 4 else frc
                right = right + sbf[bsh] * (q_t + rc_t)
            b.assert_zero(is_right * (rd[i] - right))

        B.mem_read(b, B.AS_REGISTER, ob, x, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, oc, rs2, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v * (1 - is_imm))
        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts + 2, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "b", "p_ts1", "p_ts2", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["cc"]] = rec["c"]
        t[:n, c.index["is_imm"]] = rec["is_imm"]
        fcols = np.zeros((n, 3), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 3] = fcols
        x = rec["rs1"]
        rs2 = rec["rs2"]
        t[:n, c.index["rs1"]:c.index["rs1"] + 4] = x
        t[:n, c.index["rs2"]:c.index["rs2"] + 4] = rs2
        t[:n, c.index["rd"]:c.index["rd"] + 4] = rec["rd"]
        s = rs2[:, 0] & 31
        for i in range(5):
            t[:n, c.index["t"] + i] = (s >> i) & 1
        t[:n, c.index["srem"]] = rs2[:, 0] >> 5
        sr = s & 7
        sb = s >> 3
        p2sr = (1 << sr).astype(np.uint64)
        t[:n, c.index["pow2sr"]] = p2sr
        t[:n, c.index["pow2comp"]] = (256 // p2sr)
        sbfc = np.zeros((n, 4), dtype=np.uint64)
        sbfc[np.arange(n), sb] = 1
        t[:n, c.index["sbf"]:c.index["sbf"] + 4] = sbfc
        is_sll = rec["op_idx"] == 0
        is_sra = rec["op_idx"] == 2
        sign = np.where(is_sra, (x[:, 3] >> 7), 0)
        t[:n, c.index["sign"]] = sign
        t[:n, c.index["signrem"]] = np.where(is_sra, x[:, 3] - 128 * sign, 0)
        p2comp = 256 // p2sr
        t[:n, c.index["p01"]] = 1 << (s & 3)
        t[:n, c.index["fq"]] = sign * (p2comp - 1)
        t[:n, c.index["fr"]] = sign * (p2sr - 1)
        t[:n, c.index["frc"]] = sign * (p2sr - 1) * p2comp
        A = np.zeros((n, 4), dtype=np.uint64)
        Bv = np.zeros((n, 4), dtype=np.uint64)
        for j in range(4):
            shifted = x[:, j] * p2sr
            A[:, j] = np.where(is_sll, shifted >> 8, x[:, j] // p2sr)
            Bv[:, j] = np.where(is_sll, shifted & 0xFF, x[:, j] % p2sr)
        t[:n, c.index["A"]:c.index["A"] + 4] = A
        t[:n, c.index["B"]:c.index["B"] + 4] = Bv
        t[:n, c.index["RC"]:c.index["RC"] + 4] = Bv * p2comp[:, None]
        for nm, off in (("1", 0), ("2", 1)):
            lo, hi = _ts_diff(rec["p_ts" + nm], rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo
            t[:n, c.index["dhi" + nm]] = hi
        lo, hi = _ts_diff(rec["p_tsw"], rec["ts"] + 2)
        t[:n, c.index["dlow"]] = lo
        t[:n, c.index["dhiw"]] = hi
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# Mul: MUL/MULH/MULHSU/MULHU (shared 64-bit limb product)
# ---------------------------------------------------------------------------


class MulAir(Air):
    """Full 8-limb product of sign-extended operands; MUL writes the low
    half, MULH* the high half.  (Reference: extensions/rv32im/circuit/src/
    {mul,mulh}/ merged into one chip — the 64-bit limb identity covers all
    four opcodes.)"""

    name = "rv32_mul"
    OPS = [MulOpcode.MUL, MulHOpcode.MULH, MulHOpcode.MULHSU,
           MulHOpcode.MULHU]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 4)  # mul, mulh, mulhsu, mulhu
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("x", 4), c.alloc("y", 4)
        c.alloc("lo", 4), c.alloc("hi", 4)
        c.alloc("sx"), c.alloc("xrem"), c.alloc("sy"), c.alloc("yrem")
        c.alloc("xe"), c.alloc("ye")  # sign-extension limbs (255*sign)
        c.alloc("carry", 8)
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 4)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        x = _marr(b, c, "x", 4)
        y = _marr(b, c, "y", 4)
        lo = _marr(b, c, "lo", 4)
        hi = _marr(b, c, "hi", 4)
        sx, xrem = _m(b, c, "sx"), _m(b, c, "xrem")
        sy, yrem = _m(b, c, "sy"), _m(b, c, "yrem")
        xe, ye = _m(b, c, "xe"), _m(b, c, "ye")
        carry = _marr(b, c, "carry", 8)

        b.assert_bool(v)
        for fi in f:
            b.assert_bool(fi)
        b.assert_eq(f[0] + f[1] + f[2] + f[3], v)

        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, 4 * oc, 1, 0, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        # sign extraction (x signed for MUL/MULH/MULHSU; y for MUL/MULH)
        b.assert_bool(sx)
        b.assert_bool(sy)
        x_signed = f[0] + f[1] + f[2]
        y_signed = f[0] + f[1]
        b.assert_zero(x_signed * (x[3] - 128 * sx - xrem))
        b.assert_zero((v - x_signed) * sx)
        B.range_check(b, xrem, 7, x_signed)
        b.assert_zero(y_signed * (y[3] - 128 * sy - yrem))
        b.assert_zero((v - y_signed) * sy)
        B.range_check(b, yrem, 7, y_signed)
        b.assert_zero(xe - 255 * sx)
        b.assert_zero(ye - 255 * sy)

        xhat = x + [xe] * 4
        yhat = y + [ye] * 4
        # product limbs: p_k = lo[k] (k<4) | hi[k-4]; mod 2^64
        for k in range(8):
            acc = 0 * v
            for i in range(k + 1):
                j = k - i
                if i < 8 and j < 8:
                    acc = acc + xhat[i] * yhat[j]
            if k > 0:
                acc = acc + carry[k - 1]
            p_k = lo[k] if k < 4 else hi[k - 4]
            b.assert_zero(acc - p_k - 256 * carry[k])
            # ONE tuple lookup bounds the product limb (< 256) AND its
            # carry (< 2048; worst case ~1019 at k=3, where the diagonal
            # count i+1=4 of 255*255 partials plus the incoming carry
            # peaks) together — reference mulh/core.rs:117-140 via the
            # RangeTupleChecker periphery (reference sizes [256, 2048])
            B.range_tuple_check(b, p_k, carry[k], v)

        B.mem_read(b, B.AS_REGISTER, ob, x, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, oc, y, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v)
        rd = [f[0] * lo[k] + (1 - f[0]) * hi[k] for k in range(4)]
        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts + 2, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), v, check_bytes=False)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "b", "p_ts1", "p_ts2", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["cc"]] = rec["c"]
        fcols = np.zeros((n, 4), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 4] = fcols
        x, y = rec["rs1"], rec["rs2"]
        t[:n, c.index["x"]:c.index["x"] + 4] = x
        t[:n, c.index["y"]:c.index["y"] + 4] = y
        oi = rec["op_idx"]
        x_signed = oi < 3
        y_signed = oi < 2
        sx = np.where(x_signed, x[:, 3] >> 7, 0)
        sy = np.where(y_signed, y[:, 3] >> 7, 0)
        t[:n, c.index["sx"]] = sx
        t[:n, c.index["xrem"]] = np.where(x_signed, x[:, 3] - 128 * sx, 0)
        t[:n, c.index["sy"]] = sy
        t[:n, c.index["yrem"]] = np.where(y_signed, y[:, 3] - 128 * sy, 0)
        t[:n, c.index["xe"]] = 255 * sx
        t[:n, c.index["ye"]] = 255 * sy
        # carries + product limbs
        xh = np.concatenate([x, np.tile((255 * sx)[:, None], 4)], axis=1)
        yh = np.concatenate([y, np.tile((255 * sy)[:, None], 4)], axis=1)
        carryv = np.zeros(n, dtype=np.uint64)
        for k in range(8):
            acc = carryv.copy()
            for i in range(k + 1):
                j = k - i
                if i < 8 and j < 8:
                    acc += xh[:, i] * yh[:, j]
            p_k = acc & 0xFF
            carryv = acc >> 8
            col = c.index["lo"] + k if k < 4 else c.index["hi"] + k - 4
            t[:n, col] = p_k
            t[:n, c.index["carry"] + k] = carryv
        for nm, off in (("1", 0), ("2", 1)):
            lo_, hi_ = _ts_diff(rec["p_ts" + nm], rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo_
            t[:n, c.index["dhi" + nm]] = hi_
        lo_, hi_ = _ts_diff(rec["p_tsw"], rec["ts"] + 2)
        t[:n, c.index["dlow"]] = lo_
        t[:n, c.index["dhiw"]] = hi_
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# DivRem: DIV/DIVU/REM/REMU
# ---------------------------------------------------------------------------


class DivRemAir(Air):
    """Witnessed quotient/remainder with the 64-bit identity
    q*y + r = x over sign-extended limbs, |r| < |y| via an absolute-value
    comparison, plus the RISC-V special cases (y = 0; signed overflow
    INT_MIN / -1).  (Reference: extensions/rv32im/circuit/src/divrem/.)"""

    name = "rv32_div_rem"
    OPS = [DivRemOpcode.DIV, DivRemOpcode.DIVU, DivRemOpcode.REM,
           DivRemOpcode.REMU]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 4)  # div, divu, rem, remu
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("x", 4), c.alloc("y", 4), c.alloc("q", 4), c.alloc("r", 4)
        c.alloc("carry", 8)
        c.alloc("sx"), c.alloc("xrem"), c.alloc("sy"), c.alloc("yrem")
        c.alloc("sq"), c.alloc("qrem"), c.alloc("sr"), c.alloc("rrem")
        c.alloc("xe"), c.alloc("ye"), c.alloc("qe"), c.alloc("re")
        c.alloc("y_zero"), c.alloc("yinv", 4)
        c.alloc("r_nz"), c.alloc("rinv", 4)
        c.alloc("overflow")
        c.alloc("neg_r", 4), c.alloc("nrc", 4)  # -r limbs + inc carries
        c.alloc("neg_y", 4), c.alloc("nyc", 4)
        c.alloc("abs_r", 4), c.alloc("abs_y", 4)
        c.alloc("marker", 4), c.alloc("diffv")
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 4)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        x = _marr(b, c, "x", 4)
        y = _marr(b, c, "y", 4)
        q = _marr(b, c, "q", 4)
        r = _marr(b, c, "r", 4)
        carry = _marr(b, c, "carry", 8)
        sx, xrem = _m(b, c, "sx"), _m(b, c, "xrem")
        sy, yrem = _m(b, c, "sy"), _m(b, c, "yrem")
        sq, qrem = _m(b, c, "sq"), _m(b, c, "qrem")
        sr, rrem = _m(b, c, "sr"), _m(b, c, "rrem")
        xe, ye = _m(b, c, "xe"), _m(b, c, "ye")
        qe, re = _m(b, c, "qe"), _m(b, c, "re")
        y_zero = _m(b, c, "y_zero")
        yinv = _marr(b, c, "yinv", 4)
        r_nz = _m(b, c, "r_nz")
        rinv = _marr(b, c, "rinv", 4)
        ov = _m(b, c, "overflow")
        neg_r = _marr(b, c, "neg_r", 4)
        nrc = _marr(b, c, "nrc", 4)
        neg_y = _marr(b, c, "neg_y", 4)
        nyc = _marr(b, c, "nyc", 4)
        abs_r = _marr(b, c, "abs_r", 4)
        abs_y = _marr(b, c, "abs_y", 4)
        marker = _marr(b, c, "marker", 4)
        diffv = _m(b, c, "diffv")

        b.assert_bool(v)
        for fi in f:
            b.assert_bool(fi)
        b.assert_eq(f[0] + f[1] + f[2] + f[3], v)
        signed = f[0] + f[2]

        opcode = sum((fi * op for fi, op in zip(f, self.OPS)), 0 * v)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, 4 * oc, 1, 0, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        # sign extractions (signed ops only; unsigned forces sign = 0)
        for s_col, remc, limbs in ((sx, xrem, x), (sy, yrem, y),
                                   (sq, qrem, q), (sr, rrem, r)):
            b.assert_bool(s_col)
            b.assert_zero(signed * (limbs[3] - 128 * s_col - remc))
            b.assert_zero((v - signed) * s_col)
            B.range_check(b, remc, 7, signed)
        for e_col, s_col in ((xe, sx), (ye, sy), (qe, sq), (re, sr)):
            b.assert_zero(e_col - 255 * s_col)

        # q limbs are bytes (r checked via write or byte pairs below)
        B.byte_pair_check(b, q[0], q[1], v)
        B.byte_pair_check(b, q[2], q[3], v)
        B.byte_pair_check(b, r[0], r[1], v)
        B.byte_pair_check(b, r[2], r[3], v)

        # y == 0 flag
        b.assert_bool(y_zero)
        for k in range(4):
            b.assert_zero(y_zero * y[k])
        ysum = sum((y[k] * yinv[k] for k in range(4)), 0 * v)
        b.assert_zero(v * (ysum - (1 - y_zero)))
        # y == 0: q = 0xFFFFFFFF, r = x
        for k in range(4):
            b.assert_zero(y_zero * (q[k] - 255))
            b.assert_zero(y_zero * (r[k] - x[k]))

        # overflow: signed && x == INT_MIN && y == -1 -> q = x, r = 0
        b.assert_bool(ov)
        b.assert_zero(ov * (1 - signed))
        b.assert_zero(ov * x[0])
        b.assert_zero(ov * x[1])
        b.assert_zero(ov * x[2])
        b.assert_zero(ov * (x[3] - 128))
        for k in range(4):
            b.assert_zero(ov * (y[k] - 255))
            b.assert_zero(ov * (q[k] - x[k]))
            b.assert_zero(ov * r[k])

        # 64-bit identity q*y + r = x (sign-extended), gated off for the
        # special cases (y_zero and overflow are mutually exclusive with it)
        gate_id = v - ov - y_zero
        qh = q + [qe] * 4
        yh = y + [ye] * 4
        rh = r + [re] * 4
        xh = x + [xe] * 4
        for k in range(8):
            acc = rh[k]
            for i in range(k + 1):
                j = k - i
                if i < 8 and j < 8:
                    acc = acc + qh[i] * yh[j]
            if k > 0:
                acc = acc + carry[k - 1]
            b.assert_zero(gate_id * (acc - xh[k] - 256 * carry[k]))
            B.range_check(b, carry[k], 14, gate_id)

        # r != 0 flag; sign(r) = sign(x) when r != 0 (signed)
        b.assert_bool(r_nz)
        for k in range(4):
            b.assert_zero((1 - r_nz) * r[k])
        rsum = sum((r[k] * rinv[k] for k in range(4)), 0 * v)
        b.assert_zero(v * (rsum - r_nz))
        b.assert_zero(r_nz * signed * (sr - sx))
        # and sign(q): q = 0 or sign(q) agrees with sx^sy (signed, no ov)
        # (implied by |r| < |y| + identity; not separately constrained)

        # absolute values: neg = ~limbs + 1
        for negc, inc, limbs, s_col, absc in (
                (neg_r, nrc, r, sr, abs_r), (neg_y, nyc, y, sy, abs_y)):
            for k in range(4):
                b.assert_bool(inc[k])
                prev = inc[k - 1] if k else 1
                b.assert_zero(gate_id * (255 - limbs[k] + prev - negc[k]
                                         - 256 * inc[k]))
                b.assert_zero(absc[k] - s_col * negc[k]
                              - (1 - s_col) * limbs[k])

        # |r| < |y|: highest differing limb marker
        for mi in marker:
            b.assert_bool(mi)
        msum = marker[0] + marker[1] + marker[2] + marker[3]
        b.assert_zero(gate_id * (msum - 1))
        for i in range(4):
            for j in range(i + 1, 4):
                b.assert_zero(marker[i] * (abs_r[j] - abs_y[j]))
        b.assert_zero(diffv - (marker[0] * (abs_y[0] - abs_r[0])
                               + marker[1] * (abs_y[1] - abs_r[1])
                               + marker[2] * (abs_y[2] - abs_r[2])
                               + marker[3] * (abs_y[3] - abs_r[3])))
        B.range_check(b, diffv - 1 + (1 - msum), 8, gate_id)

        B.mem_read(b, B.AS_REGISTER, ob, x, _m(b, c, "p_ts1"), ts,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), v)
        B.mem_read(b, B.AS_REGISTER, oc, y, _m(b, c, "p_ts2"), ts + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), v)
        is_div = f[0] + f[1]
        rd = [is_div * q[k] + (1 - is_div) * r[k] for k in range(4)]
        B.mem_write(b, B.AS_REGISTER, oa, rd, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts + 2, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), v, check_bytes=False)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "b", "p_ts1", "p_ts2", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["cc"]] = rec["c"]
        fcols = np.zeros((n, 4), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 4] = fcols
        x, y, q, r = rec["rs1"], rec["rs2"], rec["q"], rec["r"]
        for nm, arr in (("x", x), ("y", y), ("q", q), ("r", r)):
            t[:n, c.index[nm]:c.index[nm] + 4] = arr
        signed = (rec["op_idx"] % 2 == 0)
        for nm, arr in (("sx", x), ("sy", y), ("sq", q), ("sr", r)):
            s = np.where(signed, arr[:, 3] >> 7, 0)
            t[:n, c.index[nm]] = s
            t[:n, c.index[nm[1] + "rem"]] = np.where(signed,
                                                     arr[:, 3] - 128 * s, 0)
            t[:n, c.index[nm[1] + "e"]] = 255 * s
        y_zero = (y == 0).all(axis=1)
        t[:n, c.index["y_zero"]] = y_zero
        r_nz = ~(r == 0).all(axis=1)
        t[:n, c.index["r_nz"]] = r_nz
        for arr, invnm, gate in ((y, "yinv", ~y_zero), (r, "rinv", r_nz)):
            invc = np.zeros((n, 4), dtype=np.uint64)
            done = ~gate
            for k in range(4):
                hit = (~done) & (arr[:, k] != 0)
                for j in np.nonzero(hit)[0]:
                    invc[j, k] = pow(int(arr[j, k]), -1, P)
                done |= hit
            t[:n, c.index[invnm]:c.index[invnm] + 4] = invc
        x_is_min = (x[:, 0] == 0) & (x[:, 1] == 0) & (x[:, 2] == 0) \
            & (x[:, 3] == 128)
        y_is_m1 = (y == 255).all(axis=1)
        ov = signed & x_is_min & y_is_m1
        t[:n, c.index["overflow"]] = ov
        gate_id = (~ov) & (~y_zero)
        # identity carries
        sq_ = t[:n, c.index["sq"]]
        sy_ = t[:n, c.index["sy"]]
        sr_ = t[:n, c.index["sr"]]
        sx_ = t[:n, c.index["sx"]]
        qh = np.concatenate([q, np.tile((255 * sq_)[:, None], 4)], axis=1)
        yh = np.concatenate([y, np.tile((255 * sy_)[:, None], 4)], axis=1)
        rh = np.concatenate([r, np.tile((255 * sr_)[:, None], 4)], axis=1)
        xh = np.concatenate([x, np.tile((255 * sx_)[:, None], 4)], axis=1)
        carryv = np.zeros(n, dtype=np.uint64)
        for k in range(8):
            acc = rh[:, k] + carryv
            for i in range(k + 1):
                j = k - i
                if i < 8 and j < 8:
                    acc += qh[:, i] * yh[:, j]
            # acc - xh[k] = 256 * carry on gate rows
            diff = np.where(gate_id, acc - xh[:, k], 0)
            carryv = diff >> 8
            t[:n, c.index["carry"] + k] = carryv
        # negation + abs
        for limbs, s_, negnm, incnm, absnm in (
                (r, sr_, "neg_r", "nrc", "abs_r"),
                (y, sy_, "neg_y", "nyc", "abs_y")):
            inc_prev = np.ones(n, dtype=np.uint64)
            negv = np.zeros((n, 4), dtype=np.uint64)
            for k in range(4):
                tot = 255 - limbs[:, k] + inc_prev
                negv[:, k] = tot & 0xFF
                inc_prev = tot >> 8
                t[:n, c.index[incnm] + k] = inc_prev
            t[:n, c.index[negnm]:c.index[negnm] + 4] = negv
            absv = np.where(s_[:, None].astype(bool), negv, limbs)
            t[:n, c.index[absnm]:c.index[absnm] + 4] = absv
        abs_r_ = t[:n, c.index["abs_r"]:c.index["abs_r"] + 4]
        abs_y_ = t[:n, c.index["abs_y"]:c.index["abs_y"] + 4]
        markerc = np.zeros((n, 4), dtype=np.uint64)
        diffvc = np.zeros(n, dtype=np.uint64)
        neq = ~gate_id  # only fill markers on gated rows
        for i in range(3, -1, -1):
            d = abs_y_[:, i].astype(np.int64) - abs_r_[:, i].astype(np.int64)
            hit = (~neq) & (d != 0)
            markerc[hit, i] = 1
            diffvc[hit] = d[hit]
            neq |= (d != 0)
        t[:n, c.index["marker"]:c.index["marker"] + 4] = markerc
        t[:n, c.index["diffv"]] = diffvc % P
        for nm, off in (("1", 0), ("2", 1)):
            lo_, hi_ = _ts_diff(rec["p_ts" + nm], rec["ts"] + off)
            t[:n, c.index["dlo" + nm]] = lo_
            t[:n, c.index["dhi" + nm]] = hi_
        lo_, hi_ = _ts_diff(rec["p_tsw"], rec["ts"] + 2)
        t[:n, c.index["dlow"]] = lo_
        t[:n, c.index["dhiw"]] = hi_
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)


# ---------------------------------------------------------------------------
# HintStore: HINT_STOREW / HINT_BUFFER (multi-row: one row per word written)
# ---------------------------------------------------------------------------


class HintStoreAir(Air):
    """Nondeterministic hint writes (reference extensions/rv32im/circuit/src/
    hintstore/): the start row receives (pc, ts), fetches, reads the pointer
    register (and the word-count register for HINT_BUFFER) and sends
    (pc+4, ts+2+rem); each row writes one hint word, chained by
    (rem, ptr, ts_w) continuation constraints."""

    name = "rv32_hint_store"

    def __init__(self):
        from ..instructions import Rv32HintStoreOpcode
        self.OP_BASE = Rv32HintStoreOpcode.HINT_STOREW
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_start"), c.alloc("is_buffer")
        c.alloc("is_cont"), c.alloc("cont")
        c.alloc("pc"), c.alloc("ts0")
        c.alloc("a"), c.alloc("b")
        c.alloc("rem"), c.alloc("rio"), c.alloc("reminv")
        c.alloc("ptr"), c.alloc("ts_w")
        c.alloc("rs_ptr", 4), c.alloc("rs_len", 4)
        c.alloc("data", 4)
        c.alloc("p_ts1"), c.alloc("dlo1"), c.alloc("dhi1")
        c.alloc("p_ts2"), c.alloc("dlo2"), c.alloc("dhi2")
        c.alloc("p_tsw"), c.alloc("dlow"), c.alloc("dhiw")
        c.alloc("prevw", 4)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        st = _m(b, c, "is_start")
        buf = _m(b, c, "is_buffer")
        is_cont = _m(b, c, "is_cont")
        cont = _m(b, c, "cont")
        pc, ts0 = _m(b, c, "pc"), _m(b, c, "ts0")
        oa, ob = _m(b, c, "a"), _m(b, c, "b")
        rem = _m(b, c, "rem")
        rio, reminv = _m(b, c, "rio"), _m(b, c, "reminv")
        ptr, ts_w = _m(b, c, "ptr"), _m(b, c, "ts_w")
        rs_ptr = _marr(b, c, "rs_ptr", 4)
        rs_len = _marr(b, c, "rs_len", 4)
        data = _marr(b, c, "data", 4)

        b.assert_bool(v)
        b.assert_bool(st)
        b.assert_bool(buf)
        b.assert_zero(st * (1 - v))
        b.assert_zero(buf * (1 - st))
        b.assert_zero(is_cont - v * (1 - st))
        b.assert_bool(rio)
        b.assert_zero(rio * (rem - 1))
        b.assert_zero(v * ((rem - 1) * reminv - (1 - rio)))
        b.assert_zero(cont - v * (1 - rio))

        opcode = self.OP_BASE + buf
        B.fetch(b, pc, opcode, [4 * oa * buf, 4 * ob, 0, 1, 2, 0, 0], st)
        B.exec_receive(b, pc, ts0, st)
        B.exec_send(b, pc + 4, ts0 + 2 + rem, st)

        # start row: read pointer register; buffer also reads length reg
        B.mem_read(b, B.AS_REGISTER, ob, rs_ptr, _m(b, c, "p_ts1"), ts0,
                   _m(b, c, "dlo1"), _m(b, c, "dhi1"), st)
        B.mem_read(b, B.AS_REGISTER, oa, rs_len, _m(b, c, "p_ts2"), ts0 + 1,
                   _m(b, c, "dlo2"), _m(b, c, "dhi2"), buf)
        b.assert_zero(st * (4 * ptr - limbs_to_u32(rs_ptr)))
        b.assert_zero(st * buf * (rem - limbs_to_u32(rs_len)))
        b.assert_zero(st * (1 - buf) * (rem - 1))
        b.assert_zero(st * (ts_w - ts0 - 2))

        # every valid row writes its hint word
        B.mem_write(b, B.AS_MEMORY, ptr, data, _marr(b, c, "prevw", 4),
                    _m(b, c, "p_tsw"), ts_w, _m(b, c, "dlow"),
                    _m(b, c, "dhiw"), v)

        # continuation chaining
        trans = b.is_transition()
        nxt = lambda name: _m(b, c, name, offset=1)
        b.assert_zero(trans * cont * (1 - nxt("is_valid")))
        b.assert_zero(trans * cont * nxt("is_start"))
        b.assert_zero(trans * cont * (nxt("rem") - rem + 1))
        b.assert_zero(trans * cont * (nxt("ptr") - ptr - 1))
        b.assert_zero(trans * cont * (nxt("ts_w") - ts_w - 1))
        b.assert_zero(b.is_last_row() * cont)
        # a non-start valid row must be a continuation of the previous row
        b.assert_zero(trans * nxt("is_cont") * (1 - cont))
        b.assert_zero(b.is_first_row() * is_cont)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        t[:n, c.index["is_valid"]] = 1
        for nm in ("is_start", "pc", "ts0", "a", "b", "rem",
                   "ptr", "ts_w", "p_ts1", "p_ts2", "p_tsw"):
            t[:n, c.index[nm]] = rec[nm]
        st = rec["is_start"].astype(bool)
        # the records mark every row of a HINT_BUFFER; the constraints
        # (buf * (1 - st) = 0, one length read) want its start row only.
        # openvm_tpu/vm/circuit/rv32im.py:1749 copies the records' flag, so
        # a multi-word HINT_BUFFER fails its constraints there (F4).
        bufm = rec["is_buffer"].astype(bool) & st
        t[:n, c.index["is_buffer"]] = bufm
        t[:n, c.index["is_cont"]] = (~st).astype(np.uint64)
        rem = rec["rem"]
        rio = (rem == 1).astype(np.uint64)
        t[:n, c.index["rio"]] = rio
        reminv = np.zeros(n, dtype=np.uint64)
        for j in np.nonzero(rem != 1)[0]:
            reminv[j] = pow(int(rem[j]) - 1, -1, P)
        t[:n, c.index["reminv"]] = reminv
        t[:n, c.index["cont"]] = 1 - rio
        t[:n, c.index["rs_ptr"]:c.index["rs_ptr"] + 4] = rec["rs_ptr"]
        t[:n, c.index["rs_len"]:c.index["rs_len"] + 4] = rec["rs_len"]
        t[:n, c.index["data"]:c.index["data"] + 4] = rec["data"]
        stm = st
        lo, hi = _ts_diff(rec["p_ts1"], rec["ts0"])
        t[:n, c.index["dlo1"]] = np.where(stm, lo, 0)
        t[:n, c.index["dhi1"]] = np.where(stm, hi, 0)
        lo, hi = _ts_diff(rec["p_ts2"], rec["ts0"] + 1)
        t[:n, c.index["dlo2"]] = np.where(bufm, lo, 0)
        t[:n, c.index["dhi2"]] = np.where(bufm, hi, 0)
        lo, hi = _ts_diff(rec["p_tsw"], rec["ts_w"])
        t[:n, c.index["dlow"]] = lo
        t[:n, c.index["dhiw"]] = hi
        t[:n, c.index["prevw"]:c.index["prevw"] + 4] = rec["prevw"]
        return _pad_pow2(t)
