"""Native extension chips: felt/ext-felt arithmetic over address space 4.

Copy of openvm_tpu/vm/circuit/native.py:39-1315 (the whole module: the
felt_read/felt_write and aux helpers :44-92, the ten executor AIRs of
``NATIVE_AIRS`` :1302-1313 -- NativeFieldArithmeticAir :94,
NativeFieldExtensionAir :194, NativeBranchEqAir :302,
NativeLoadStoreAir(1)/(4) :397, NativeJalRangeCheckAir :500,
NativePoseidon2Air :579, FriReducedOpeningAir :680, VerifyBatchAir :863
with ``VERIFY_BATCH_BUS`` :860, VerifyBatchInsideAir :1129 -- and
NativePublicValuesAir :1251); record layouts and AIR order unchanged.

TPU-native redesign of the reference native extension circuit
(reference extensions/native/circuit/src/extension/mod.rs:89-167 chip set,
field_arithmetic/, field_extension/, branch_eq/, loadstore/, poseidon2/).
The native VM executes the recursion programs (STARK verifier / leaf
aggregation); its memory cells are single BabyBear felts in address space 4,
carried on the shared word-granular memory bus as [felt, 0, 0, 0] words.

Departures from the reference (deliberate, TPU-first):
  * no record-arena/adapter traits — column-dict tracegen like rv32im.py;
  * poseidon2 permutations are NOT inlined per-chip: the adapter chip sends
    (input16 || output16) requests to the shared system Poseidon2Air on
    POSEIDON2_BUS (reference crates/vm/src/system/poseidon2 does the same
    for merkle+native senders);
  * the recursion eDSL emits fully static (straight-line) programs, so
    LOADW/STOREW keep the reference's pointer-cell indirection
    (extensions/native/circuit/src/loadstore/execution.rs:245-269) but the
    pointer read is gated and can be skipped for static addresses.

Address space discipline: every AS-4 (and AS-3 felt PV) word is written as
[felt, 0, 0, 0]; initial words are all-zero (native exes carry no init
image), so reads only witness d0 and pin d1..d3 = 0.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from .buses import Cols
from . import buses as B
from .poseidon2_chip import POSEIDON2_BUS
from .rv32im import _m, _marr, _pad_pow2
from ..instructions import (FieldArithmeticOpcode, FieldExtensionOpcode,
                            NativeBranchEqOpcode, NativeLoadStoreOpcode,
                            NativeLoadStore4Opcode, Poseidon2Opcode)

P = 2013265921
AS_NATIVE = 4
EXT_W = 11  # quartic extension x^4 = 11 (field/babybear.py convention)


def felt_read(b, aspace, addr, felt, prev_ts, now_ts, dlo, dhi, count):
    """Read one felt cell: data word [felt, 0, 0, 0]."""
    B.mem_read(b, aspace, addr, [felt, 0, 0, 0], prev_ts, now_ts, dlo, dhi,
               count)


def felt_write(b, aspace, addr, felt, prev_d0, prev_ts, now_ts, dlo, dhi,
               count):
    B.mem_write(b, aspace, addr, [felt, 0, 0, 0], [prev_d0, 0, 0, 0],
                prev_ts, now_ts, dlo, dhi, count, check_bytes=False)


def _read_aux(c: Cols, name: str):
    c.alloc(f"pts_{name}"), c.alloc(f"dlo_{name}"), c.alloc(f"dhi_{name}")


def _write_aux(c: Cols, name: str):
    c.alloc(f"prev_{name}")
    c.alloc(f"pts_{name}"), c.alloc(f"dlo_{name}"), c.alloc(f"dhi_{name}")


def _aux(b, c: Cols, name: str):
    return (_m(b, c, f"pts_{name}"), _m(b, c, f"dlo_{name}"),
            _m(b, c, f"dhi_{name}"))


def _fill_diff(t, c: Cols, n, name, now, prev, count=None):
    """Fill the ts-diff decomposition columns for access `name`."""
    d = (now - prev - 1) % P
    if count is not None:
        d = np.where(count != 0, d, 0)
    t[:n, c.index[f"dlo_{name}"]] = d & 0x7FFF
    t[:n, c.index[f"dhi_{name}"]] = d >> 15


def _ext_mul_exprs(x, y):
    """z = x*y in F[w]/(w^4-11): z_k = conv_k + 11*conv_{k+4}."""
    out = []
    for k in range(4):
        acc = 0
        for i in range(4):
            for j in range(4):
                if i + j == k:
                    acc = acc + x[i] * y[j]
                elif i + j == k + 4:
                    acc = acc + EXT_W * (x[i] * y[j])
        out.append(acc)
    return out


class NativeFieldArithmeticAir(Air):
    """ADD/SUB/MUL/DIV on felts (reference field_arithmetic/core.rs).

    Operands: a = dst addr, b/c = src addr or immediate value,
    d = dst address space (3 = felt public values, 4 = native),
    e/f = src address spaces (0 = immediate, else 4).
    """

    name = "native_field_arithmetic"
    OPS = [FieldArithmeticOpcode.ADD, FieldArithmeticOpcode.SUB,
           FieldArithmeticOpcode.MUL, FieldArithmeticOpcode.DIV]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 4)
        c.alloc("a"), c.alloc("b"), c.alloc("cc"), c.alloc("dst_as")
        c.alloc("b_imm"), c.alloc("c_imm")
        c.alloc("b_val"), c.alloc("c_val"), c.alloc("result")
        c.alloc("inv_c")
        _read_aux(c, "b"), _read_aux(c, "c"), _write_aux(c, "w")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 4)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        dst_as = _m(b, c, "dst_as")
        b_imm, c_imm = _m(b, c, "b_imm"), _m(b, c, "c_imm")
        bv, cv, res = _m(b, c, "b_val"), _m(b, c, "c_val"), _m(b, c, "result")
        inv_c = _m(b, c, "inv_c")

        b.assert_bool(v)
        for k in range(4):
            b.assert_bool(f[k])
        b.assert_eq(f[0] + f[1] + f[2] + f[3], v)
        b.assert_bool(b_imm)
        b.assert_bool(c_imm)
        b.assert_zero(v * (dst_as - 3) * (dst_as - 4))
        # immediate sources take the operand value directly
        b.assert_zero(b_imm * (bv - ob))
        b.assert_zero(c_imm * (cv - oc))
        # op semantics
        b.assert_zero(f[0] * (res - (bv + cv)) + f[1] * (res - (bv - cv)))
        b.assert_zero(f[2] * (res - bv * cv))
        b.assert_zero(f[3] * (res * cv - bv))
        b.assert_zero(f[3] * (cv * inv_c - 1))

        opcode = self.OPS[0] + f[1] + 2 * f[2] + 3 * f[3]
        B.fetch(b, pc, opcode,
                [oa, ob, oc, dst_as, (1 - b_imm) * 4, (1 - c_imm) * 4, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 3, v)

        pb, dlob, dhib = _aux(b, c, "b")
        felt_read(b, AS_NATIVE, ob, bv, pb, ts, dlob, dhib, v * (1 - b_imm))
        pcx, dloc, dhic = _aux(b, c, "c")
        felt_read(b, AS_NATIVE, oc, cv, pcx, ts + 1, dloc, dhic,
                  v * (1 - c_imm))
        pw, dlow, dhiw = _aux(b, c, "w")
        felt_write(b, dst_as, oa, res, _m(b, c, "prev_w"), pw, ts + 2,
                   dlow, dhiw, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        ts = np.asarray(rec["ts"])
        t[:n, c.index["ts"]] = ts
        fcols = np.zeros((n, 4), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 4] = fcols
        for k in ("a", "b", "dst_as", "b_imm", "c_imm", "b_val", "c_val",
                  "result"):
            t[:n, c.index[k]] = rec[k]
        t[:n, c.index["cc"]] = rec["c"]
        cv = np.asarray(rec["c_val"], dtype=np.int64)
        is_div = np.asarray(rec["op_idx"]) == 3
        inv = np.zeros(n, dtype=np.uint64)
        for i in np.nonzero(is_div)[0]:
            inv[i] = pow(int(cv[i]), -1, P)
        t[:n, c.index["inv_c"]] = inv
        b_cnt = 1 - np.asarray(rec["b_imm"])
        c_cnt = 1 - np.asarray(rec["c_imm"])
        t[:n, c.index["pts_b"]] = rec["p_tsb"]
        _fill_diff(t, c, n, "b", ts, np.asarray(rec["p_tsb"]), b_cnt)
        t[:n, c.index["pts_c"]] = rec["p_tsc"]
        _fill_diff(t, c, n, "c", ts + 1, np.asarray(rec["p_tsc"]), c_cnt)
        t[:n, c.index["prev_w"]] = rec["prev_w"]
        t[:n, c.index["pts_w"]] = rec["p_tsw"]
        _fill_diff(t, c, n, "w", ts + 2, np.asarray(rec["p_tsw"]))
        return _pad_pow2(t)


class NativeFieldExtensionAir(Air):
    """FE4ADD/FE4SUB/BBE4MUL/BBE4DIV on 4-blocks (reference
    field_extension/core.rs).  a/b/c are AS-4 block base addresses."""

    name = "native_field_extension"
    OPS = [FieldExtensionOpcode.FE4ADD, FieldExtensionOpcode.FE4SUB,
           FieldExtensionOpcode.BBE4MUL, FieldExtensionOpcode.BBE4DIV]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 4)
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("x", 4), c.alloc("y", 4), c.alloc("z", 4), c.alloc("w", 4)
        for i in range(4):
            _read_aux(c, f"x{i}")
        for i in range(4):
            _read_aux(c, f"y{i}")
        for i in range(4):
            _write_aux(c, f"z{i}")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 4)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        x = _marr(b, c, "x", 4)
        y = _marr(b, c, "y", 4)
        z = _marr(b, c, "z", 4)
        w = _marr(b, c, "w", 4)

        b.assert_bool(v)
        for k in range(4):
            b.assert_bool(f[k])
        b.assert_eq(f[0] + f[1] + f[2] + f[3], v)

        zy = _ext_mul_exprs(z, y)
        yw = _ext_mul_exprs(y, w)
        xy = _ext_mul_exprs(x, y)
        one = [1, 0, 0, 0]
        for k in range(4):
            b.assert_zero(f[0] * (z[k] - (x[k] + y[k]))
                          + f[1] * (z[k] - (x[k] - y[k])))
            b.assert_zero(f[2] * (z[k] - xy[k]))
            b.assert_zero(f[3] * (zy[k] - x[k]))
            b.assert_zero(f[3] * (yw[k] - one[k]))

        opcode = self.OPS[0] + f[1] + 2 * f[2] + 3 * f[3]
        B.fetch(b, pc, opcode, [oa, ob, oc, 4, 4, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 12, v)
        for i in range(4):
            p, dlo, dhi = _aux(b, c, f"x{i}")
            felt_read(b, AS_NATIVE, ob + i, x[i], p, ts + i, dlo, dhi, v)
        for i in range(4):
            p, dlo, dhi = _aux(b, c, f"y{i}")
            felt_read(b, AS_NATIVE, oc + i, y[i], p, ts + 4 + i, dlo, dhi, v)
        for i in range(4):
            p, dlo, dhi = _aux(b, c, f"z{i}")
            felt_write(b, AS_NATIVE, oa + i, z[i], _m(b, c, f"prev_z{i}"),
                       p, ts + 8 + i, dlo, dhi, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        ts = np.asarray(rec["ts"])
        t[:n, c.index["ts"]] = ts
        fcols = np.zeros((n, 4), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 4] = fcols
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["cc"]] = rec["c"]
        x = np.asarray(rec["x"], dtype=np.uint64)
        y = np.asarray(rec["y"], dtype=np.uint64)
        z = np.asarray(rec["z"], dtype=np.uint64)
        t[:n, c.index["x"]:c.index["x"] + 4] = x
        t[:n, c.index["y"]:c.index["y"] + 4] = y
        t[:n, c.index["z"]:c.index["z"] + 4] = z
        # div witness: w = y^{-1} in the extension field
        from ...field.babybear import ext_inv_int
        is_div = np.asarray(rec["op_idx"]) == 3
        wcols = np.zeros((n, 4), dtype=np.uint64)
        for i in np.nonzero(is_div)[0]:
            wcols[i] = ext_inv_int(tuple(int(v_) for v_ in y[i]))
        t[:n, c.index["w"]:c.index["w"] + 4] = wcols
        pts_x = np.asarray(rec["pts_x"], dtype=np.uint64)
        pts_y = np.asarray(rec["pts_y"], dtype=np.uint64)
        pts_z = np.asarray(rec["pts_z"], dtype=np.uint64)
        prev_z = np.asarray(rec["prev_z"], dtype=np.uint64)
        for i in range(4):
            t[:n, c.index[f"pts_x{i}"]] = pts_x[:, i]
            _fill_diff(t, c, n, f"x{i}", ts + i, pts_x[:, i])
            t[:n, c.index[f"pts_y{i}"]] = pts_y[:, i]
            _fill_diff(t, c, n, f"y{i}", ts + 4 + i, pts_y[:, i])
            t[:n, c.index[f"prev_z{i}"]] = prev_z[:, i]
            t[:n, c.index[f"pts_z{i}"]] = pts_z[:, i]
            _fill_diff(t, c, n, f"z{i}", ts + 8 + i, pts_z[:, i])
        return _pad_pow2(t)


class NativeBranchEqAir(Air):
    """BEQ/BNE on felts (reference branch_eq/ + BranchNativeAdapterAir).

    a/b = felt addr or immediate (d/e = 0 marks immediate), c = pc offset.
    """

    name = "native_branch_eq"
    OPS = [NativeBranchEqOpcode.BEQ, NativeBranchEqOpcode.BNE]

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 2)
        c.alloc("a"), c.alloc("b"), c.alloc("imm")
        c.alloc("a_imm"), c.alloc("b_imm")
        c.alloc("x_val"), c.alloc("y_val")
        c.alloc("cmp"), c.alloc("inv"), c.alloc("taken"), c.alloc("to_pc")
        _read_aux(c, "x"), _read_aux(c, "y")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 2)
        oa, ob, imm = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "imm")
        a_imm, b_imm = _m(b, c, "a_imm"), _m(b, c, "b_imm")
        xv, yv = _m(b, c, "x_val"), _m(b, c, "y_val")
        cmp = _m(b, c, "cmp")
        inv = _m(b, c, "inv")
        taken = _m(b, c, "taken")
        to_pc = _m(b, c, "to_pc")

        b.assert_bool(v)
        b.assert_bool(f[0])
        b.assert_bool(f[1])
        b.assert_eq(f[0] + f[1], v)
        b.assert_bool(a_imm)
        b.assert_bool(b_imm)
        b.assert_zero(a_imm * (xv - oa))
        b.assert_zero(b_imm * (yv - ob))
        diff = xv - yv
        b.assert_bool(cmp)
        b.assert_zero(cmp * diff)
        b.assert_zero(v * (inv * diff - (1 - cmp)))
        # taken committed to keep the to_pc constraint at degree 3
        b.assert_zero(taken - (f[0] * cmp + f[1] * (1 - cmp)))
        b.assert_zero(v * (to_pc - (pc + taken * imm + (1 - taken) * 4)))

        opcode = self.OPS[0] + f[1]
        B.fetch(b, pc, opcode,
                [oa, ob, imm, (1 - a_imm) * 4, (1 - b_imm) * 4, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, to_pc, ts + 2, v)
        p, dlo, dhi = _aux(b, c, "x")
        felt_read(b, AS_NATIVE, oa, xv, p, ts, dlo, dhi, v * (1 - a_imm))
        p, dlo, dhi = _aux(b, c, "y")
        felt_read(b, AS_NATIVE, ob, yv, p, ts + 1, dlo, dhi, v * (1 - b_imm))

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        ts = np.asarray(rec["ts"])
        t[:n, c.index["ts"]] = ts
        fcols = np.zeros((n, 2), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 2] = fcols
        for k in ("a", "b", "imm", "a_imm", "b_imm", "x_val", "y_val",
                  "to_pc"):
            t[:n, c.index[k]] = rec[k]
        x = np.asarray(rec["x_val"], dtype=np.int64)
        y = np.asarray(rec["y_val"], dtype=np.int64)
        d = (x - y) % P
        eq = d == 0
        t[:n, c.index["cmp"]] = eq
        inv = np.zeros(n, dtype=np.uint64)
        for i in np.nonzero(~eq)[0]:
            inv[i] = pow(int(d[i]), -1, P)
        t[:n, c.index["inv"]] = inv
        is_beq = np.asarray(rec["op_idx"]) == 0
        t[:n, c.index["taken"]] = np.where(is_beq, eq, ~eq)
        a_cnt = 1 - np.asarray(rec["a_imm"])
        b_cnt = 1 - np.asarray(rec["b_imm"])
        t[:n, c.index["pts_x"]] = rec["p_ts1"]
        _fill_diff(t, c, n, "x", ts, np.asarray(rec["p_ts1"]), a_cnt)
        t[:n, c.index["pts_y"]] = rec["p_ts2"]
        _fill_diff(t, c, n, "y", ts + 1, np.asarray(rec["p_ts2"]), b_cnt)
        return _pad_pow2(t)


class NativeLoadStoreAir(Air):
    """LOADW/STOREW/HINT_STOREW over N-cell blocks (reference
    loadstore/core.rs + NativeLoadStoreAdapterAir).

    ptr = (mem4[c] if f_as == 4 else c) + b;
      LOADW:       mem4[a .. a+N)   = mem4[ptr .. ptr+N)
      STOREW:      mem4[ptr..ptr+N) = mem4[a .. a+N)
      HINT_STOREW: mem4[ptr..ptr+N) = next N hint felts
    """

    def __init__(self, num_cells: int = 1):
        self.N = num_cells
        self.name = ("native_loadstore" if num_cells == 1
                     else f"native_loadstore{num_cells}")
        self.BASE = (NativeLoadStoreOpcode.LOADW if num_cells == 1
                     else NativeLoadStore4Opcode.LOADW4)
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 3)  # load, store, hint
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("has_ptr"), c.alloc("ptr_val")
        c.alloc("data", self.N)
        _read_aux(c, "p")
        for i in range(self.N):
            _read_aux(c, f"r{i}")
        for i in range(self.N):
            _write_aux(c, f"w{i}")
        self.width = c.width

    def eval(self, b):
        c, N = self.c, self.N
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 3)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        has_ptr = _m(b, c, "has_ptr")
        ptr_val = _m(b, c, "ptr_val")
        data = _marr(b, c, "data", N)

        b.assert_bool(v)
        for k in range(3):
            b.assert_bool(f[k])
        b.assert_eq(f[0] + f[1] + f[2], v)
        b.assert_bool(has_ptr)
        b.assert_zero((1 - has_ptr) * (ptr_val - oc))

        opcode = self.BASE + f[1] + 2 * f[2]
        B.fetch(b, pc, opcode, [oa, ob, oc, 4, 4, has_ptr * 4, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 1 + 2 * N, v)

        p, dlo, dhi = _aux(b, c, "p")
        felt_read(b, AS_NATIVE, oc, ptr_val, p, ts, dlo, dhi, v * has_ptr)
        ptr = ptr_val + ob
        # data reads: LOADW from ptr+i, STOREW from a+i; HINT skips
        for i in range(N):
            rd_addr = f[0] * (ptr + i) + f[1] * (oa + i)
            p, dlo, dhi = _aux(b, c, f"r{i}")
            felt_read(b, AS_NATIVE, rd_addr, data[i], p, ts + 1 + i,
                      dlo, dhi, v * (f[0] + f[1]))
        # writes: LOADW to a+i, STOREW/HINT to ptr+i
        for i in range(N):
            w_addr = f[0] * (oa + i) + (f[1] + f[2]) * (ptr + i)
            p, dlo, dhi = _aux(b, c, f"w{i}")
            felt_write(b, AS_NATIVE, w_addr, data[i], _m(b, c, f"prev_w{i}"),
                       p, ts + 1 + N + i, dlo, dhi, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c, N = self.c, self.N
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        ts = np.asarray(rec["ts"])
        t[:n, c.index["ts"]] = ts
        fcols = np.zeros((n, 3), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 3] = fcols
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["cc"]] = rec["c"]
        t[:n, c.index["has_ptr"]] = rec["has_ptr"]
        t[:n, c.index["ptr_val"]] = rec["ptr_val"]
        data = np.asarray(rec["data"], dtype=np.uint64).reshape(n, N)
        t[:n, c.index["data"]:c.index["data"] + N] = data
        hp = np.asarray(rec["has_ptr"])
        t[:n, c.index["pts_p"]] = rec["p_tsp"]
        _fill_diff(t, c, n, "p", ts, np.asarray(rec["p_tsp"]), hp)
        r_cnt = np.asarray(rec["op_idx"]) != 2
        pts_r = np.asarray(rec["pts_r"], dtype=np.uint64).reshape(n, N)
        pts_w = np.asarray(rec["pts_w"], dtype=np.uint64).reshape(n, N)
        prev_w = np.asarray(rec["prev_w"], dtype=np.uint64).reshape(n, N)
        for i in range(N):
            t[:n, c.index[f"pts_r{i}"]] = pts_r[:, i]
            _fill_diff(t, c, n, f"r{i}", ts + 1 + i, pts_r[:, i], r_cnt)
            t[:n, c.index[f"prev_w{i}"]] = prev_w[:, i]
            t[:n, c.index[f"pts_w{i}"]] = pts_w[:, i]
            _fill_diff(t, c, n, f"w{i}", ts + 1 + N + i, pts_w[:, i])
        return _pad_pow2(t)


class NativeJalRangeCheckAir(Air):
    """JAL + RANGE_CHECK in one chip (reference jal_rangecheck/mod.rs:89-146,
    "logically irrelevant ops share a chip to save columns").

      JAL a, b:           mem4[a] = pc + 4;  pc += b (field offset)
      RANGE_CHECK a, b, c: x = mem4[a]; assert x = x_lo + 2^15 x_hi with
                           x_lo < 2^b (b <= 15), x_hi < 2^c (c <= 15)

    The split point is 15 (not the reference's 16) to match this
    framework's range-table MAX_BITS=15; programs are generated in-repo so
    the operand convention is local to this ISA.

    Both express the memory op as a write (RANGE_CHECK rewrites the old
    value, matching the reference's write-with-prev_data trick).
    """

    name = "native_jal_rangecheck"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_jal"), c.alloc("is_rc")
        c.alloc("pc"), c.alloc("ts")
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("y")
        _write_aux(c, "w")
        self.width = c.width

    def eval(self, b):
        c = self.c
        is_jal, is_rc = _m(b, c, "is_jal"), _m(b, c, "is_rc")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        y = _m(b, c, "y")
        prev = _m(b, c, "prev_w")

        b.assert_bool(is_jal)
        b.assert_bool(is_rc)
        v = is_jal + is_rc
        b.assert_bool(v)
        b.assert_zero(is_jal * oc)

        wval = is_jal * (pc + 4) + is_rc * prev
        p, dlo, dhi = _aux(b, c, "w")
        felt_write(b, AS_NATIVE, oa, wval, prev, p, ts, dlo, dhi, v)

        from ..instructions import (NativeJalOpcode, NativeRangeCheckOpcode)
        opcode = (is_jal * NativeJalOpcode.JAL
                  + is_rc * NativeRangeCheckOpcode.RANGE_CHECK)
        B.fetch(b, pc, opcode, [oa, ob, oc, 4, 0, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + is_jal * ob + is_rc * 4, ts + 1, v)

        # range-check decomposition: prev = x + y * 2^15, x < 2^b, y < 2^c
        x = prev - y * (1 << 15)
        B.range_check(b, x, ob, is_rc)
        B.range_check(b, y, oc, is_rc)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        oi = np.asarray(rec["op_idx"])
        t[:n, c.index["is_jal"]] = oi == 0
        t[:n, c.index["is_rc"]] = oi == 1
        t[:n, c.index["pc"]] = rec["pc"]
        ts = np.asarray(rec["ts"])
        t[:n, c.index["ts"]] = ts
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["cc"]] = rec["c"]
        t[:n, c.index["y"]] = rec["y"]
        t[:n, c.index["prev_w"]] = rec["prev_w"]
        t[:n, c.index["pts_w"]] = rec["p_tsw"]
        _fill_diff(t, c, n, "w", ts, np.asarray(rec["p_tsw"]))
        return _pad_pow2(t)


class NativePoseidon2Air(Air):
    """PERM_POS2 / COMP_POS2 memory adapter (reference
    extensions/native/circuit/src/poseidon2/).  The permutation itself is
    proved by the shared system Poseidon2Air; this chip performs the AS-4
    block reads/writes and sends (input16 || output16) on POSEIDON2_BUS.

      PERM_POS2 a,b:   mem4[a..a+16) = perm(mem4[b..b+16))
      COMP_POS2 a,b,c: mem4[a..a+8) = perm(mem4[b..b+8) || mem4[c..c+8))[:8]
    """

    name = "native_poseidon2"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("f", 2)  # perm, comp
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        c.alloc("inp", 16), c.alloc("out", 16)
        for i in range(16):
            _read_aux(c, f"r{i}")
        for i in range(16):
            _write_aux(c, f"w{i}")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        f = _marr(b, c, "f", 2)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        inp = _marr(b, c, "inp", 16)
        out = _marr(b, c, "out", 16)

        b.assert_bool(v)
        b.assert_bool(f[0])
        b.assert_bool(f[1])
        b.assert_eq(f[0] + f[1], v)

        opcode = Poseidon2Opcode.PERM_POS2 + f[1]
        B.fetch(b, pc, opcode, [oa, ob, oc, 4, 4, 0, 0], v)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + 32, v)

        for i in range(8):
            p, dlo, dhi = _aux(b, c, f"r{i}")
            felt_read(b, AS_NATIVE, ob + i, inp[i], p, ts + i, dlo, dhi, v)
        for i in range(8, 16):
            addr = f[0] * (ob + i) + f[1] * (oc + i - 8)
            p, dlo, dhi = _aux(b, c, f"r{i}")
            felt_read(b, AS_NATIVE, addr, inp[i], p, ts + i, dlo, dhi, v)
        for i in range(8):
            p, dlo, dhi = _aux(b, c, f"w{i}")
            felt_write(b, AS_NATIVE, oa + i, out[i], _m(b, c, f"prev_w{i}"),
                       p, ts + 16 + i, dlo, dhi, v)
        for i in range(8, 16):
            p, dlo, dhi = _aux(b, c, f"w{i}")
            felt_write(b, AS_NATIVE, oa + i, out[i], _m(b, c, f"prev_w{i}"),
                       p, ts + 16 + i, dlo, dhi, v * f[0])

        b.push_send(POSEIDON2_BUS, inp + out, v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["pc"]] = rec["pc"]
        ts = np.asarray(rec["ts"])
        t[:n, c.index["ts"]] = ts
        fcols = np.zeros((n, 2), dtype=np.uint64)
        fcols[np.arange(n), rec["op_idx"]] = 1
        t[:n, c.index["f"]:c.index["f"] + 2] = fcols
        t[:n, c.index["a"]] = rec["a"]
        t[:n, c.index["b"]] = rec["b"]
        t[:n, c.index["cc"]] = rec["c"]
        inp = np.asarray(rec["inp"], dtype=np.uint64).reshape(n, 16)
        out = np.asarray(rec["out"], dtype=np.uint64).reshape(n, 16)
        t[:n, c.index["inp"]:c.index["inp"] + 16] = inp
        t[:n, c.index["out"]:c.index["out"] + 16] = out
        is_perm = np.asarray(rec["op_idx"]) == 0
        pts_r = np.asarray(rec["pts_r"], dtype=np.uint64).reshape(n, 16)
        pts_w = np.asarray(rec["pts_w"], dtype=np.uint64).reshape(n, 16)
        prev_w = np.asarray(rec["prev_w"], dtype=np.uint64).reshape(n, 16)
        for i in range(16):
            t[:n, c.index[f"pts_r{i}"]] = pts_r[:, i]
            _fill_diff(t, c, n, f"r{i}", ts + i, pts_r[:, i])
            t[:n, c.index[f"prev_w{i}"]] = prev_w[:, i]
            t[:n, c.index[f"pts_w{i}"]] = pts_w[:, i]
            cnt = None if i < 8 else is_perm
            _fill_diff(t, c, n, f"w{i}", ts + 16 + i, pts_w[:, i], cnt)
        return _pad_pow2(t)

    def p2_requests(self, trace: np.ndarray) -> np.ndarray:
        """(input16 || output16) rows for the shared Poseidon2Air."""
        c = self.c
        valid = trace[:, c.index["is_valid"]] == 1
        return trace[valid][:, c.index["inp"]:c.index["inp"] + 32]


class FriReducedOpeningAir(Air):
    """FRI_REDUCED_OPENING: one instruction computes the whole reduced
    opening  result = sum_{t=0}^{len-1} alpha^t * (b[t] - a[t])  where
    a[t] are base felts (the opened FRI row) and b[t] are ext elements
    (the claimed values at the out-of-domain point).

    TPU-native counterpart of the reference FriReducedOpeningChip
    (reference extensions/native/circuit/src/fri/mod.rs WorkloadCols /
    Instruction1Cols / Instruction2Cols; opcode FRI_REDUCED_OPENING,
    extensions/native/compiler/src/lib.rs:196-199).  Departures:
      * operands are direct pointers (a=a_ptr, b=b_ptr, c=length imm,
        d=alpha_ptr, e=result_ptr) — the generator emits shape-specialized
        programs, so the reference's pointer-to-pointer indirection and
        hint-write mode (write_a/is_init) are unnecessary;
      * power order is ascending in t (the reference folds ascending-i
        Horner, i.e. alpha^{len-1-i}); this matches the repo verifier's
        `sum_t alpha^t (p_t(z) - row_t)` convention so the generated
        program mirrors stark/verifier.py term for term.

    Trace layout: each instruction spans `len` contiguous rows in
    descending t (row 0 of the block handles t = len-1).  The accumulator
    chains by Horner: acc_start = b-a at t=len-1; acc_next = acc*alpha +
    (b-a).  The last row (t = 0) holds the result, reads alpha, writes the
    result and carries the fetch/execution-bus interaction.

    Timestamps (executor contract): row for t does its 5 reads at
    ts + 5*(len-1-t) .. +4; the end row additionally reads alpha at
    ts + 5*len .. +3 and writes the result at ts + 5*len + 4 .. +7.
    Total timestamp delta = 5*len + 8.
    """

    name = "fri_reduced_opening"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_start"), c.alloc("is_end")
        c.alloc("pc"), c.alloc("ts")
        c.alloc("a_ptr"), c.alloc("b_ptr"), c.alloc("length")
        c.alloc("alpha_ptr"), c.alloc("result_ptr")  # used on end row only
        c.alloc("t"), c.alloc("inv_t")
        c.alloc("alpha", 4)
        c.alloc("a_val"), c.alloc("b_val", 4)
        c.alloc("acc", 4)
        _read_aux(c, "a")
        for k in range(4):
            _read_aux(c, f"b{k}")
        for k in range(4):
            _read_aux(c, f"al{k}")
        for k in range(4):
            _write_aux(c, f"res{k}")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        start = _m(b, c, "is_start")
        end = _m(b, c, "is_end")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        a_ptr, b_ptr = _m(b, c, "a_ptr"), _m(b, c, "b_ptr")
        length = _m(b, c, "length")
        t = _m(b, c, "t")
        inv_t = _m(b, c, "inv_t")
        alpha = _marr(b, c, "alpha", 4)
        a_val = _m(b, c, "a_val")
        b_val = _marr(b, c, "b_val", 4)
        acc = _marr(b, c, "acc", 4)

        b.assert_bool(v)
        b.assert_bool(start)
        b.assert_bool(end)
        b.assert_zero(start * (1 - v))
        b.assert_zero(end * (1 - v))
        # end <=> (t == 0) on valid rows
        b.assert_zero(end * t)
        b.assert_zero((v - end) * (t * inv_t - 1))
        # start row enters at the highest index
        b.assert_zero(start * (t - (length - 1)))
        # start row initializes the Horner accumulator to b - a
        diff = [b_val[0] - a_val, b_val[1], b_val[2], b_val[3]]
        for k in range(4):
            b.assert_zero(start * (acc[k] - diff[k]))

        def nxt(name, i=0):
            return b.main(c.index[name] + i, 1)

        # block structure (keccak.py discipline): validity is a prefix of
        # the trace; a valid row is a block start iff it does not continue
        # the previous row; a truncated block cannot reach the trace end
        cont = v - end
        b.assert_zero(b.is_first_row() * v * (1 - start))
        b.assert_zero(b.is_transition()
                      * (nxt("is_start") - (nxt("is_valid") - cont)))
        b.assert_zero(b.is_transition() * (1 - v) * nxt("is_valid"))
        b.assert_zero(b.is_last_row() * cont)

        # intra-block continuity + Horner chaining
        for name in ("pc", "ts", "a_ptr", "b_ptr", "length"):
            b.assert_zero(cont * (nxt(name) - _m(b, c, name)))
        for k in range(4):
            b.assert_zero(cont * (nxt("alpha", k) - alpha[k]))
        b.assert_zero(cont * (nxt("t") - t + 1))
        nacc = [nxt("acc", k) for k in range(4)]
        ndiff = [nxt("b_val", 0) - nxt("a_val"), nxt("b_val", 1),
                 nxt("b_val", 2), nxt("b_val", 3)]
        prod = _ext_mul_exprs(acc, alpha)
        for k in range(4):
            b.assert_zero(cont * (nacc[k] - prod[k] - ndiff[k]))

        # memory reads for this row's term (ts_row = ts + 5*(length-1-t))
        ts_row = ts + 5 * (length - 1 - t)
        p, dlo, dhi = _aux(b, c, "a")
        felt_read(b, AS_NATIVE, a_ptr + t, a_val, p, ts_row, dlo, dhi, v)
        for k in range(4):
            p, dlo, dhi = _aux(b, c, f"b{k}")
            felt_read(b, AS_NATIVE, b_ptr + 4 * t + k, b_val[k], p,
                      ts_row + 1 + k, dlo, dhi, v)

        # end row: alpha read, result write, fetch + execution bus
        alpha_ptr = _m(b, c, "alpha_ptr")
        result_ptr = _m(b, c, "result_ptr")
        for k in range(4):
            p, dlo, dhi = _aux(b, c, f"al{k}")
            felt_read(b, AS_NATIVE, alpha_ptr + k, alpha[k], p,
                      ts + 5 * length + k, dlo, dhi, end)
        for k in range(4):
            p, dlo, dhi = _aux(b, c, f"res{k}")
            felt_write(b, AS_NATIVE, result_ptr + k, acc[k],
                       _m(b, c, f"prev_res{k}"), p,
                       ts + 5 * length + 4 + k, dlo, dhi, end)

        from ..instructions import FriOpcode
        B.fetch(b, pc, FriOpcode.FRI_REDUCED_OPENING,
                [a_ptr, b_ptr, length, alpha_ptr, result_ptr, 0, 0], end)
        B.exec_receive(b, pc, ts, end)
        B.exec_send(b, pc + 4, ts + 5 * length + 8, end)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        for k in ("is_start", "is_end", "pc", "ts", "a_ptr", "b_ptr",
                  "length", "alpha_ptr", "result_ptr", "a_val"):
            t[:n, c.index[k]] = rec[k]
        tt = np.asarray(rec["t"], dtype=np.uint64)
        t[:n, c.index["t"]] = tt
        inv = np.zeros(n, dtype=np.uint64)
        nz = np.nonzero(tt)[0]
        for i in nz:
            inv[i] = pow(int(tt[i]), -1, P)
        t[:n, c.index["inv_t"]] = inv
        for nm, w in (("alpha", 4), ("b_val", 4), ("acc", 4)):
            t[:n, c.index[nm]:c.index[nm] + w] = np.asarray(
                rec[nm], dtype=np.uint64).reshape(n, w)
        ts = np.asarray(rec["ts"], dtype=np.uint64)
        length = np.asarray(rec["length"], dtype=np.uint64)
        ts_row = ts + 5 * (length - 1 - tt)
        t[:n, c.index["pts_a"]] = rec["pts_a"]
        _fill_diff(t, c, n, "a", ts_row, np.asarray(rec["pts_a"]))
        pts_b = np.asarray(rec["pts_b"], dtype=np.uint64).reshape(n, 4)
        for k in range(4):
            t[:n, c.index[f"pts_b{k}"]] = pts_b[:, k]
            _fill_diff(t, c, n, f"b{k}", ts_row + 1 + k, pts_b[:, k])
        is_end = np.asarray(rec["is_end"])
        pts_al = np.asarray(rec["pts_alpha"], dtype=np.uint64).reshape(n, 4)
        pts_res = np.asarray(rec["pts_res"], dtype=np.uint64).reshape(n, 4)
        prev_res = np.asarray(rec["prev_res"], dtype=np.uint64).reshape(n, 4)
        for k in range(4):
            t[:n, c.index[f"pts_al{k}"]] = pts_al[:, k]
            _fill_diff(t, c, n, f"al{k}", ts + 5 * length + k,
                       pts_al[:, k], is_end)
            t[:n, c.index[f"prev_res{k}"]] = prev_res[:, k]
            t[:n, c.index[f"pts_res{k}"]] = pts_res[:, k]
            _fill_diff(t, c, n, f"res{k}", ts + 5 * length + 4 + k,
                       pts_res[:, k], is_end)
        return _pad_pow2(t)


VERIFY_BATCH_BUS = 9  # inside-row digests -> top-level incorporation


class VerifyBatchAir(Air):
    """VERIFY_BATCH top-level rows: one instruction verifies a whole
    Merkle batch opening (mixed-height matrices, openvm commit layout).

    TPU-native counterpart of the reference NativePoseidon2Chip TopLevel
    rows (reference extensions/native/circuit/src/poseidon2/README.md:
    IncorporateRow / IncorporateSibling; opcode VERIFY_BATCH,
    extensions/native/circuit/src/extension/mod.rs:89-99).  Departures:
      * permutations are delegated to the shared system Poseidon2Air via
        POSEIDON2_BUS (same split as every other chip here);
      * the rolling row hashes live in a separate trace
        (VerifyBatchInsideAir), linked over VERIFY_BATCH_BUS — the
        reference interleaves both row types in one matrix (bus 7);
      * operands point at a DESCRIPTOR in native memory rather than the
        reference's array-of-(ptr,len) layout: desc[3s..3s+3) =
        (has_seg, seg_ptr, seg_len) for level s = 0..depth.  The
        generator emits shape-specialized programs, so descriptors are
        static per call site and written once.

    Instruction operands: a=desc_ptr, b=sib_ptr (8*depth hinted felts),
    c=bits_ptr (depth felts, low bit first), d=commit_ptr (8 felts),
    e=depth (immediate), f=total inside rows (free metadata for height
    profiling, unconstrained), g=0.

    Semantics: node = H(seg_0)  [has_seg[0] must be 1]; then for
    s = 0..depth-1: node = bit_s ? C(sib_s, node) : C(node, sib_s); and
    if has_seg[s+1]: node = C(node, H(seg_{s+1})).  Assert node == commit.
    H = overwrite-rate poseidon2 sponge over the segment's felts (the
    merkle.py row-hash); C = 2-to-1 compression.

    Trace block per instruction: 2*depth+1 rows in order
    L_0, S_0, L_1, S_1, ..., S_{depth-1}, L_depth.  L_s (is_lvl) reads
    descriptor triple s and optionally incorporates the level's row hash;
    S_s (is_sib) does the ordered sibling compress.  First row carries
    fetch + execution receive; last row reads the commitment, asserts
    equality and sends the execution state.

    Timestamp schedule (executor contract), all relative to ts0:
      desc reads     ts0 + 3s + {0,1,2}           (L_s)
      bit reads      ts0 + 3(depth+1) + s         (S_s)
      sibling reads  ts0 + 3(depth+1) + depth + 8s + k   (S_s)
      commit reads   ts0 + 3(depth+1) + 9*depth + k      (L_depth)
      segment reads  8 ticks per inside row, sequential per level from
                     seg_base = ts0 + 3(depth+1) + 9*depth + 8
      total delta  = 3(depth+1) + 9*depth + 8 + 8*(total inside rows)
    """

    name = "verify_batch"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_lvl"), c.alloc("is_sib")
        c.alloc("is_start"), c.alloc("is_end")
        c.alloc("pc"), c.alloc("ts")
        c.alloc("depth"), c.alloc("f_op")
        c.alloc("desc_ptr"), c.alloc("sib_ptr"), c.alloc("bits_ptr")
        c.alloc("commit_ptr")
        c.alloc("s")
        c.alloc("node_in", 8), c.alloc("node", 8)
        c.alloc("ts_acc"), c.alloc("ts_add")
        # L-row specifics
        c.alloc("has_seg"), c.alloc("seg_ptr"), c.alloc("seg_len")
        c.alloc("n_rows"), c.alloc("digest", 8), c.alloc("do_comp")
        c.alloc("out_hi", 8)
        # S-row specifics
        c.alloc("bit"), c.alloc("sib", 8)
        c.alloc("in_l", 8), c.alloc("in_r", 8)
        # end-row commitment
        c.alloc("comm", 8)
        for k in range(3):
            _read_aux(c, f"d{k}")
        _read_aux(c, "bit")
        for k in range(8):
            _read_aux(c, f"s{k}")
        for k in range(8):
            _read_aux(c, f"c{k}")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        lvl, sibf = _m(b, c, "is_lvl"), _m(b, c, "is_sib")
        start, end = _m(b, c, "is_start"), _m(b, c, "is_end")
        pc, ts0 = _m(b, c, "pc"), _m(b, c, "ts")
        depth = _m(b, c, "depth")
        f_op = _m(b, c, "f_op")
        desc_ptr = _m(b, c, "desc_ptr")
        sib_ptr = _m(b, c, "sib_ptr")
        bits_ptr = _m(b, c, "bits_ptr")
        commit_ptr = _m(b, c, "commit_ptr")
        s = _m(b, c, "s")
        node_in = _marr(b, c, "node_in", 8)
        node = _marr(b, c, "node", 8)
        ts_acc, ts_add = _m(b, c, "ts_acc"), _m(b, c, "ts_add")
        has_seg = _m(b, c, "has_seg")
        seg_ptr, seg_len = _m(b, c, "seg_ptr"), _m(b, c, "seg_len")
        n_rows = _m(b, c, "n_rows")
        digest = _marr(b, c, "digest", 8)
        do_comp = _m(b, c, "do_comp")
        out_hi = _marr(b, c, "out_hi", 8)
        bit = _m(b, c, "bit")
        sib = _marr(b, c, "sib", 8)
        in_l = _marr(b, c, "in_l", 8)
        in_r = _marr(b, c, "in_r", 8)
        comm = _marr(b, c, "comm", 8)

        for flag in (v, lvl, sibf, start, end, has_seg):
            b.assert_bool(flag)
        b.assert_eq(lvl + sibf, v)
        b.assert_zero(start * (1 - lvl))   # blocks start on L_0
        b.assert_zero(end * (1 - lvl))     # and end on L_depth
        b.assert_zero(start * s)
        b.assert_zero(end * (s - depth))
        b.assert_zero(sibf * has_seg)
        b.assert_zero(start * (1 - has_seg))  # level 0 must carry rows
        b.assert_zero(sibf * bit * (1 - bit))

        # block structure (prefix discipline, cont = continues-next-row)
        cont = v - end

        def nxt(name, i=0):
            return b.main(c.index[name] + i, 1)

        b.assert_zero(b.is_first_row() * v * (1 - start))
        b.assert_zero(b.is_transition()
                      * (nxt("is_start") - (nxt("is_valid") - cont)))
        b.assert_zero(b.is_transition() * (1 - v) * nxt("is_valid"))
        b.assert_zero(b.is_last_row() * cont)
        # alternation: L (not end) -> S same level; S -> L next level
        cont_l = lvl - end
        b.assert_zero(cont_l * (1 - nxt("is_sib")))
        b.assert_zero(cont_l * (nxt("s") - s))
        b.assert_zero(sibf * (1 - nxt("is_lvl")))
        b.assert_zero(sibf * (nxt("s") - s - 1))
        # block-constant columns
        for name in ("pc", "ts", "depth", "f_op", "desc_ptr", "sib_ptr",
                     "bits_ptr", "commit_ptr"):
            b.assert_zero(cont * (nxt(name) - _m(b, c, name)))
        # node chaining + tick accounting
        for k in range(8):
            b.assert_zero(cont * (nxt("node_in", k) - node[k]))
        b.assert_zero(cont * (nxt("ts_acc") - ts_acc - ts_add))
        b.assert_zero(lvl * (ts_add - 8 * has_seg * n_rows))
        b.assert_zero(sibf * ts_add)
        b.assert_zero(lvl * (1 - has_seg) * n_rows)
        seg_base = ts0 + 3 * (depth + 1) + 9 * depth + 8
        b.assert_zero(start * (ts_acc - seg_base))

        # ---- L rows: descriptor read + optional row-hash incorporation
        p0, l0, h0 = _aux(b, c, "d0")
        felt_read(b, AS_NATIVE, desc_ptr + 3 * s, has_seg, p0,
                  ts0 + 3 * s, l0, h0, lvl)
        p1, l1, h1 = _aux(b, c, "d1")
        felt_read(b, AS_NATIVE, desc_ptr + 3 * s + 1, seg_ptr, p1,
                  ts0 + 3 * s + 1, l1, h1, lvl)
        p2, l2, h2 = _aux(b, c, "d2")
        felt_read(b, AS_NATIVE, desc_ptr + 3 * s + 2, seg_len, p2,
                  ts0 + 3 * s + 2, l2, h2, lvl)
        # digest arrives from the inside-row trace (keyed by tick base)
        b.push_receive(VERIFY_BATCH_BUS,
                       [ts_acc, seg_ptr, seg_len, n_rows] + list(digest),
                       lvl * has_seg)
        # node update: start -> digest; compress -> perm output;
        # no segment -> passthrough
        b.assert_zero(do_comp - (lvl * has_seg - start))
        for k in range(8):
            b.assert_zero(start * (node[k] - digest[k]))
            b.assert_zero(lvl * (1 - has_seg) * (node[k] - node_in[k]))
        b.push_send(POSEIDON2_BUS,
                    list(node_in) + list(digest) + list(node)
                    + list(out_hi), do_comp)

        # ---- S rows: ordered sibling compress
        pb, lb, hb = _aux(b, c, "bit")
        felt_read(b, AS_NATIVE, bits_ptr + s, bit, pb,
                  ts0 + 3 * (depth + 1) + s, lb, hb, sibf)
        for k in range(8):
            p, lo, hi = _aux(b, c, f"s{k}")
            felt_read(b, AS_NATIVE, sib_ptr + 8 * s + k, sib[k], p,
                      ts0 + 3 * (depth + 1) + depth + 8 * s + k, lo, hi,
                      sibf)
            b.assert_zero(sibf * (in_l[k] - node_in[k]
                                  - bit * (sib[k] - node_in[k])))
            b.assert_zero(sibf * (in_r[k] - sib[k]
                                  - bit * (node_in[k] - sib[k])))
        b.push_send(POSEIDON2_BUS,
                    list(in_l) + list(in_r) + list(node) + list(out_hi),
                    sibf)

        # ---- end row: commitment readback + equality
        for k in range(8):
            p, lo, hi = _aux(b, c, f"c{k}")
            felt_read(b, AS_NATIVE, commit_ptr + k, comm[k], p,
                      ts0 + 3 * (depth + 1) + 9 * depth + k, lo, hi, end)
            b.assert_zero(end * (node[k] - comm[k]))

        from ..instructions import VerifyBatchOpcode
        B.fetch(b, pc, VerifyBatchOpcode.VERIFY_BATCH,
                [desc_ptr, sib_ptr, bits_ptr, commit_ptr, depth, f_op, 0],
                start)
        B.exec_receive(b, pc, ts0, start)
        B.exec_send(b, pc + 4, ts_acc + ts_add, end)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        for k in ("is_lvl", "is_sib", "is_start", "is_end", "pc", "ts",
                  "depth", "f_op", "desc_ptr", "sib_ptr", "bits_ptr",
                  "commit_ptr", "s", "ts_acc", "ts_add", "has_seg",
                  "seg_ptr", "seg_len", "n_rows", "bit"):
            t[:n, c.index[k]] = rec[k]
        lvl = np.asarray(rec["is_lvl"], dtype=np.uint64)
        start = np.asarray(rec["is_start"], dtype=np.uint64)
        isend = np.asarray(rec["is_end"])
        hs = np.asarray(rec["has_seg"], dtype=np.uint64)
        t[:n, c.index["do_comp"]] = lvl * hs - start
        for nm, w in (("node_in", 8), ("node", 8), ("digest", 8),
                      ("out_hi", 8), ("sib", 8), ("in_l", 8), ("in_r", 8),
                      ("comm", 8)):
            t[:n, c.index[nm]:c.index[nm] + w] = np.asarray(
                rec[nm], dtype=np.uint64).reshape(n, w)
        ts0 = np.asarray(rec["ts"], dtype=np.uint64)
        depth = np.asarray(rec["depth"], dtype=np.uint64)
        sv = np.asarray(rec["s"], dtype=np.uint64)
        sibf = np.asarray(rec["is_sib"])
        pts_d = np.asarray(rec["pts_d"], dtype=np.uint64).reshape(n, 3)
        for k in range(3):
            t[:n, c.index[f"pts_d{k}"]] = pts_d[:, k]
            _fill_diff(t, c, n, f"d{k}", ts0 + 3 * sv + k, pts_d[:, k],
                       lvl)
        t[:n, c.index["pts_bit"]] = rec["pts_bit"]
        _fill_diff(t, c, n, "bit", ts0 + 3 * (depth + 1) + sv,
                   np.asarray(rec["pts_bit"]), sibf)
        pts_s = np.asarray(rec["pts_sib"], dtype=np.uint64).reshape(n, 8)
        pts_c = np.asarray(rec["pts_comm"], dtype=np.uint64).reshape(n, 8)
        for k in range(8):
            t[:n, c.index[f"pts_s{k}"]] = pts_s[:, k]
            _fill_diff(t, c, n, f"s{k}",
                       ts0 + 3 * (depth + 1) + depth + 8 * sv + k,
                       pts_s[:, k], sibf)
            t[:n, c.index[f"pts_c{k}"]] = pts_c[:, k]
            _fill_diff(t, c, n, f"c{k}",
                       ts0 + 3 * (depth + 1) + 9 * depth + k,
                       pts_c[:, k], isend)
        return _pad_pow2(t)

    def p2_requests(self, trace: np.ndarray) -> np.ndarray:
        """Permutation INPUT rows (N, 16) for the shared Poseidon2Air."""
        c = self.c
        comp = trace[:, c.index["do_comp"]] == 1
        sibf = trace[:, c.index["is_sib"]] == 1
        l_req = np.concatenate([
            trace[comp][:, c.index["node_in"]:c.index["node_in"] + 8],
            trace[comp][:, c.index["digest"]:c.index["digest"] + 8],
        ], axis=1)
        s_req = np.concatenate([
            trace[sibf][:, c.index["in_l"]:c.index["in_l"] + 8],
            trace[sibf][:, c.index["in_r"]:c.index["in_r"] + 8],
        ], axis=1)
        return np.concatenate([l_req, s_req], axis=0)


class VerifyBatchInsideAir(Air):
    """VERIFY_BATCH inside rows: rolling overwrite-rate poseidon2 sponge
    over one memory segment (a height-group's concatenated opened rows),
    8 felts per row.  Counterpart of the reference InsideRow rows
    (extensions/native/circuit/src/poseidon2/README.md).  The final row
    hands (tick base, seg_ptr, seg_len, row count, digest) to the
    top-level trace on VERIFY_BATCH_BUS.
    """

    name = "verify_batch_inside"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_first"), c.alloc("is_last")
        c.alloc("ts_seg"), c.alloc("seg_ptr"), c.alloc("seg_len")
        c.alloc("j"), c.alloc("rem")
        c.alloc("act", 8)
        c.alloc("absorbed", 8)
        c.alloc("state_in", 16), c.alloc("state_out", 16)
        for k in range(8):
            _read_aux(c, f"m{k}")
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        first, last = _m(b, c, "is_first"), _m(b, c, "is_last")
        ts_seg = _m(b, c, "ts_seg")
        seg_ptr, seg_len = _m(b, c, "seg_ptr"), _m(b, c, "seg_len")
        j, rem = _m(b, c, "j"), _m(b, c, "rem")
        act = _marr(b, c, "act", 8)
        absorbed = _marr(b, c, "absorbed", 8)
        state_in = _marr(b, c, "state_in", 16)
        state_out = _marr(b, c, "state_out", 16)

        b.assert_bool(v), b.assert_bool(first), b.assert_bool(last)
        b.assert_zero(first * (1 - v))
        b.assert_zero(last * (1 - v))
        b.assert_zero(v * (1 - act[0]))
        for k in range(8):
            b.assert_bool(act[k])
        for k in range(7):
            b.assert_zero(act[k + 1] * (1 - act[k]))  # monotone
        # non-last rows absorb a full chunk; last row absorbs the tail
        for k in range(8):
            b.assert_zero((v - last) * (1 - act[k]))
        b.assert_zero(last * (rem - sum(act[k] for k in range(8))))
        # inactive lanes pass the state through
        for k in range(8):
            b.assert_zero((1 - act[k]) * v * (absorbed[k] - state_in[k]))
        # first row: fresh sponge over this segment
        b.assert_zero(first * j)
        b.assert_zero(first * (rem - seg_len))
        for m in range(16):
            b.assert_zero(first * state_in[m])

        def nxt(name, i=0):
            return b.main(c.index[name] + i, 1)

        cont = v - last
        b.assert_zero(b.is_first_row() * v * (1 - first))
        b.assert_zero(b.is_transition()
                      * (nxt("is_first") - (nxt("is_valid") - cont)))
        b.assert_zero(b.is_transition() * (1 - v) * nxt("is_valid"))
        b.assert_zero(b.is_last_row() * cont)
        for name in ("ts_seg", "seg_ptr", "seg_len"):
            b.assert_zero(cont * (nxt(name) - _m(b, c, name)))
        b.assert_zero(cont * (nxt("j") - j - 1))
        b.assert_zero(cont * (nxt("rem") - rem + 8))
        for m in range(16):
            b.assert_zero(cont * (nxt("state_in", m) - state_out[m]))

        # gated memory reads for the active lanes
        for k in range(8):
            p, lo, hi = _aux(b, c, f"m{k}")
            felt_read(b, AS_NATIVE, seg_ptr + 8 * j + k, absorbed[k], p,
                      ts_seg + 8 * j + k, lo, hi, v * act[k])

        # overwrite-rate duplex: (absorbed || capacity) -> state_out
        b.push_send(POSEIDON2_BUS,
                    list(absorbed) + list(state_in[8:]) + list(state_out),
                    v)
        # hand the digest to the top-level row
        b.push_send(VERIFY_BATCH_BUS,
                    [ts_seg, seg_ptr, seg_len, j + 1]
                    + list(state_out[:8]), last)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["ts_seg"]) if rec else 0
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        t[:n, c.index["is_valid"]] = 1
        for k in ("is_first", "is_last", "ts_seg", "seg_ptr", "seg_len",
                  "j", "rem"):
            t[:n, c.index[k]] = rec[k]
        for nm, w in (("act", 8), ("absorbed", 8), ("state_in", 16),
                      ("state_out", 16)):
            t[:n, c.index[nm]:c.index[nm] + w] = np.asarray(
                rec[nm], dtype=np.uint64).reshape(n, w)
        ts_seg = np.asarray(rec["ts_seg"], dtype=np.uint64)
        jj = np.asarray(rec["j"], dtype=np.uint64)
        act = np.asarray(rec["act"], dtype=np.uint64).reshape(n, 8)
        pts_m = np.asarray(rec["pts_m"], dtype=np.uint64).reshape(n, 8)
        for k in range(8):
            t[:n, c.index[f"pts_m{k}"]] = pts_m[:, k]
            _fill_diff(t, c, n, f"m{k}", ts_seg + 8 * jj + k, pts_m[:, k],
                       act[:, k])
        return _pad_pow2(t)

    def p2_requests(self, trace: np.ndarray) -> np.ndarray:
        """Permutation INPUT rows (N, 16) for the shared Poseidon2Air."""
        c = self.c
        valid = trace[:, c.index["is_valid"]] == 1
        return np.concatenate([
            trace[valid][:, c.index["absorbed"]:c.index["absorbed"] + 8],
            trace[valid][:, c.index["state_in"] + 8:c.index["state_in"]
                         + 16],
        ], axis=1)


class NativePublicValuesAir(Air):
    """Felt-valued public values boundary for AS 3 (native config).

    Mirrors PublicValuesAir (system.py) but one felt per PV: row i sends the
    zero initial state at t=0, receives the final [pv, 0, 0, 0] at final_ts,
    and binds pv to AIR public value i via the preprocessed one-hot.
    """

    name = "native_public_values"

    def __init__(self, num_pvs: int = 16):
        self.num_pvs = num_pvs
        self.num_public_values = num_pvs
        c = self.c = Cols()
        c.alloc("pv"), c.alloc("final_ts")
        self.width = c.width

    def preprocessed_trace(self):
        n = self.num_pvs
        h = 1 << max(n - 1, 0).bit_length()   # pow2 height; pad inactive
        t = np.zeros((h, 2 + n), dtype=np.uint64)
        t[:n, 0] = 1                          # active flag
        t[:n, 1] = np.arange(n)
        t[np.arange(n), 2 + np.arange(n)] = 1
        return t

    def eval(self, b):
        c = self.c
        active = b.preprocessed(0)
        idx = b.preprocessed(1)
        onehot = [b.preprocessed(2 + i) for i in range(self.num_pvs)]
        pv = _m(b, c, "pv")
        final_ts = _m(b, c, "final_ts")
        b.push_send(B.MEMORY_BUS, [3, idx, 0, 0, 0, 0, 0], active)
        b.push_receive(B.MEMORY_BUS, [3, idx, pv, 0, 0, 0, final_ts],
                       active)
        for i in range(self.num_pvs):
            b.assert_zero(onehot[i] * (pv - b.public_value(i)))

    def trace(self, touched) -> np.ndarray:
        """touched: preflight (as,addr)->[d0..d3, ts] final word states."""
        h = 1 << max(self.num_pvs - 1, 0).bit_length()
        t = np.zeros((h, self.width), dtype=np.uint64)
        for i in range(self.num_pvs):
            w = touched.get((3, i))
            if w:
                t[i, 0] = w[0]
                t[i, 1] = w[4]
        return t


NATIVE_AIRS = {
    "native_field_arithmetic": NativeFieldArithmeticAir,
    "native_field_extension": NativeFieldExtensionAir,
    "native_branch_eq": NativeBranchEqAir,
    "native_loadstore": lambda: NativeLoadStoreAir(1),
    "native_loadstore4": lambda: NativeLoadStoreAir(4),
    "native_jal_rangecheck": NativeJalRangeCheckAir,
    "native_poseidon2": NativePoseidon2Air,
    "fri_reduced_opening": FriReducedOpeningAir,
    "verify_batch": VerifyBatchAir,
    "verify_batch_inside": VerifyBatchInsideAir,
}

NATIVE_EXECUTORS = tuple(NATIVE_AIRS)
