"""Modular-arithmetic VM chips (algebra extension).

Copy of openvm_tpu/vm/circuit/modular.py (the whole module: the three AIRs
:42-280, ``modular_airs`` :282 and the opcode constants :37-39).

TPU-native re-design of the reference algebra extension's modular chips
(reference extensions/algebra/circuit/src/modular_chip/, SURVEY.md
section 2.9): per configured modulus N, three chips over 256-bit (32x8)
heap operands behind register pointers (same access discipline as the
bigint chips, circuit/bigint.py):

  * ModularAddSubAir:  z = x +/- y (mod N)
  * ModularMulDivAir:  z = x*y (mod N)  |  z = x/y (mod N)
  * ModularIsEqAir:    rd-register u32 = (x == y), inputs checked < N

Constraint generation is delegated to the mod-builder (mod_builder.py) —
the FieldExpr equation compiler with auto q/carry witnesses.

Opcode space: 0x500 + mod_idx*8 + {ADD=0, SUB=1, SETUP_ADDSUB=2, MUL=3,
DIV=4, SETUP_MULDIV=5, IS_EQ=6, SETUP_ISEQ=7} (reference
Rv32ModularArithmeticOpcode, extensions/algebra/transpiler/src/lib.rs:18-30).
SETUP_* opcodes are transpiled to no-ops in this framework: the modulus is
hard-wired into the verifying key as constraint constants, so the
runtime-setup binding the reference needs is already enforced by keygen.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from . import buses as B
from .bigint import (N as NLIMBS, W, _adapter_cols, _adapter_eval,
                     _adapter_fill, _fill_flags, _flags, _pad_pow2)
from .mod_builder import ExprBuilder, int_to_limbs
from .rv32im import _m, _marr, _ts_diff

P = 2013265921

MODULAR_BASE = 0x500
MOD_KINDS = 8
ADD, SUB, SETUP_ADDSUB, MUL, DIV, SETUP_MULDIV, IS_EQ, SETUP_ISEQ = range(8)


class ModularAddSubAir(Air):
    TS_DELTA = 27

    def __init__(self, modulus: int, mod_idx: int):
        self.name = f"modular_addsub_{mod_idx}"
        self.modulus = modulus
        self.mod_idx = mod_idx
        eb = self.eb = ExprBuilder(modulus, NLIMBS)
        x = eb.input()
        y = eb.input()
        f_add = eb.flag()
        f_sub = eb.flag()
        eb.save((x + y).flag_mul(f_add) + (x - y).flag_mul(f_sub))
        from .buses import Cols
        c = self.c = Cols()
        _adapter_cols(c, writes=True)
        c.alloc("f", 2)
        c.alloc("aux", eb.aux_width())
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 2)
        base = MODULAR_BASE + self.mod_idx * MOD_KINDS
        opcode = f[0] * (base + ADD) + f[1] * (base + SUB)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True)
        self.eb.emit(
            b, v,
            get_input=lambda i: [x, y][i],
            get_var=lambda j: z,
            get_flag=lambda k: f[k],
            get_aux=lambda t: b.main(c.index["aux"] + t))

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True)
        _fill_flags(t, n, c, rec, 2)
        flags = [(rec["op_idx"] == 0).astype(np.uint64),
                 (rec["op_idx"] == 1).astype(np.uint64)]
        _, aux = self.eb.fill([rec["x"], rec["y"]], flags,
                              var_results=[rec["z"]])
        t[:n, c.index["aux"]:c.index["aux"] + aux.shape[1]] = aux
        return _pad_pow2(t)


class ModularMulDivAir(Air):
    TS_DELTA = 27

    def __init__(self, modulus: int, mod_idx: int):
        self.name = f"modular_muldiv_{mod_idx}"
        self.modulus = modulus
        self.mod_idx = mod_idx
        eb = self.eb = ExprBuilder(modulus, NLIMBS)
        x = eb.input()
        y = eb.input()
        f_mul = eb.flag()
        f_div = eb.flag()
        z = eb.new_var()
        # mul: x*y - z = 0;  div: z*y - x = 0  (z = x/y)
        eb.constrain_zero((x * y - z).flag_mul(f_mul)
                          + (z * y - x).flag_mul(f_div))
        from .buses import Cols
        c = self.c = Cols()
        _adapter_cols(c, writes=True)
        c.alloc("f", 2)
        c.alloc("aux", eb.aux_width())
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 2)
        base = MODULAR_BASE + self.mod_idx * MOD_KINDS
        opcode = f[0] * (base + MUL) + f[1] * (base + DIV)
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True)
        self.eb.emit(
            b, v,
            get_input=lambda i: [x, y][i],
            get_var=lambda j: z,
            get_flag=lambda k: f[k],
            get_aux=lambda t: b.main(c.index["aux"] + t))

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True)
        _fill_flags(t, n, c, rec, 2)
        flags = [(rec["op_idx"] == 0).astype(np.uint64),
                 (rec["op_idx"] == 1).astype(np.uint64)]
        _, aux = self.eb.fill([rec["x"], rec["y"]], flags,
                              var_results=[rec["z"]])
        t[:n, c.index["aux"]:c.index["aux"] + aux.shape[1]] = aux
        return _pad_pow2(t)


class ModularIsEqAir(Air):
    """x == y with canonicity checks x < N, y < N; writes u32 to rd reg.

    Reference modular_chip/is_eq.rs semantics: result is a register write
    (not a heap block); soundness requires canonical (reduced) inputs,
    enforced with borrow-chain comparisons against the constant N.
    """

    TS_DELTA = 19

    def __init__(self, modulus: int, mod_idx: int):
        self.name = f"modular_iseq_{mod_idx}"
        self.modulus = modulus
        self.mod_idx = mod_idx
        from .buses import Cols
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        for tag in ("r1", "r2"):
            c.alloc(f"{tag}p", 4)
            c.alloc(f"pts_{tag}"), c.alloc(f"dlo_{tag}"), c.alloc(f"dhi_{tag}")
            c.alloc(f"wa_{tag}_lo"), c.alloc(f"wa_{tag}_hi")
        c.alloc("x", NLIMBS), c.alloc("y", NLIMBS)
        for tag in ("x", "y"):
            c.alloc(f"pts_{tag}", W)
            c.alloc(f"dlo_{tag}", W), c.alloc(f"dhi_{tag}", W)
        # canonicity borrow chains vs constant N
        c.alloc("dx", NLIMBS), c.alloc("bx", NLIMBS)
        c.alloc("dy", NLIMBS), c.alloc("by", NLIMBS)
        c.alloc("cmp"), c.alloc("inv", NLIMBS)
        # rd register write
        c.alloc("pts_rd"), c.alloc("dlo_rd"), c.alloc("dhi_rd")
        c.alloc("prevrd", 4)
        self.width = c.width

    def _lt_const(self, b, v, vals, d, bor, n_limbs_const):
        for i in range(NLIMBS):
            b.assert_bool(bor[i])
            prev = bor[i - 1] if i else 0
            b.assert_zero(v * (vals[i] - n_limbs_const[i] - prev
                               + 256 * bor[i] - d[i]))
        for i in range(0, NLIMBS, 2):
            B.byte_pair_check(b, d[i], d[i + 1], v)
        b.assert_zero(v * (bor[NLIMBS - 1] - 1))  # strictly less

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        oa, ob, oc = _m(b, c, "a"), _m(b, c, "b"), _m(b, c, "cc")
        base = MODULAR_BASE + self.mod_idx * MOD_KINDS
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        B.fetch(b, pc, base + IS_EQ, [4 * oa, 4 * ob, 4 * oc, 1, 2, 0, 0],
                v)
        from .bigint import _ptr_word_addr
        for tag, operand, tick in (("r1", ob, 0), ("r2", oc, 1)):
            B.mem_read(b, B.AS_REGISTER, operand,
                       _marr(b, c, f"{tag}p", 4),
                       _m(b, c, f"pts_{tag}"), ts + tick,
                       _m(b, c, f"dlo_{tag}"), _m(b, c, f"dhi_{tag}"), v)
        wa1 = _ptr_word_addr(b, c, v, "r1")
        wa2 = _ptr_word_addr(b, c, v, "r2")
        x = _marr(b, c, "x", NLIMBS)
        y = _marr(b, c, "y", NLIMBS)
        for k in range(W):
            B.mem_read(b, B.AS_MEMORY, wa1 + k, x[4 * k:4 * k + 4],
                       b.main(c.index["pts_x"] + k), ts + 2 + k,
                       b.main(c.index["dlo_x"] + k),
                       b.main(c.index["dhi_x"] + k), v)
            B.mem_read(b, B.AS_MEMORY, wa2 + k, y[4 * k:4 * k + 4],
                       b.main(c.index["pts_y"] + k), ts + 2 + W + k,
                       b.main(c.index["dlo_y"] + k),
                       b.main(c.index["dhi_y"] + k), v)
        n_limbs = int_to_limbs(self.modulus, NLIMBS)
        self._lt_const(b, v, x, _marr(b, c, "dx", NLIMBS),
                       _marr(b, c, "bx", NLIMBS), n_limbs)
        self._lt_const(b, v, y, _marr(b, c, "dy", NLIMBS),
                       _marr(b, c, "by", NLIMBS), n_limbs)
        cmp = _m(b, c, "cmp")
        inv = _marr(b, c, "inv", NLIMBS)
        b.assert_bool(cmp)
        for i in range(NLIMBS):
            b.assert_zero(cmp * (x[i] - y[i]))
        acc = sum(((x[i] - y[i]) * inv[i] for i in range(1, NLIMBS)),
                  (x[0] - y[0]) * inv[0])
        b.assert_zero(v * (acc - (v - cmp)))
        B.mem_write(b, B.AS_REGISTER, oa, [cmp, 0, 0, 0],
                    _marr(b, c, "prevrd", 4), _m(b, c, "pts_rd"),
                    ts + 2 + 2 * W, _m(b, c, "dlo_rd"),
                    _m(b, c, "dhi_rd"), v, check_bytes=False)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        ix = c.index
        _adapter_fill(t, n, c, rec, writes=False, first_block_tick=2)
        n_limbs = np.asarray(int_to_limbs(self.modulus, NLIMBS),
                             dtype=np.int64)
        for tag, arr in (("x", rec["x"]), ("y", rec["y"])):
            bor = np.zeros(n, dtype=np.int64)
            for i in range(NLIMBS):
                diff = arr[:, i].astype(np.int64) - n_limbs[i] - bor
                bor = (diff < 0).astype(np.int64)
                t[:n, ix["d" + tag] + i] = (diff + 256 * bor).astype(
                    np.uint64)
                t[:n, ix["b" + tag] + i] = bor
        x = rec["x"].astype(np.int64)
        y = rec["y"].astype(np.int64)
        eq = (x == y).all(axis=1)
        t[:n, ix["cmp"]] = eq
        diff = x - y
        for r in range(n):
            if not eq[r]:
                i = int(np.argmax(diff[r] != 0))
                t[r, ix["inv"] + i] = pow(int(diff[r, i]) % P, P - 2, P)
        pts = rec["pts_rd"]
        t[:n, ix["pts_rd"]] = pts
        lo, hi = _ts_diff(pts, rec["ts"] + 2 + 2 * W)
        t[:n, ix["dlo_rd"]] = lo
        t[:n, ix["dhi_rd"]] = hi
        t[:n, ix["prevrd"]:ix["prevrd"] + 4] = rec["prevrd"]
        return _pad_pow2(t)


def modular_airs(moduli) -> dict:
    """All modular chips for the configured moduli, keyed by air name."""
    out = {}
    for i, m in enumerate(moduli):
        for cls in (ModularAddSubAir, ModularMulDivAir, ModularIsEqAir):
            air = cls(m, i)
            out[air.name] = air
    return out
