"""Fp2 (complex extension field) chips: add/sub/mul/div over Fp[u]/(u^2+1).

Copy of openvm_tpu/vm/circuit/fp2.py (the whole module: the opcode
constants :30-34, ``Fp2AddSubAir`` :76, ``Fp2MulDivAir`` :105, ``fp2_mul``
:134, ``fp2_div`` :138, ``fp2_airs`` :147), itself a re-design of the reference Fp2Extension
(reference extensions/algebra/circuit/src/fp2_chip/, extension/fp2.rs,
SURVEY.md section 2.9).  Elements are 64-byte heap blocks (c0 || c1, 32
limbs each); the irreducible polynomial is u^2 + 1 (BN254/BLS12-381
convention baked into the reference's Fp2 guest type).

  addsub:  z_i = a_i +/- b_i (mod p), i in {0,1}
  mul:     z0 = a0*b0 - a1*b1;  z1 = a0*b1 + a1*b0
  div:     z*b = a:  z0*b0 - z1*b1 = a0;  z0*b1 + z1*b0 = a1

Opcode space: 0x710 + fp2_idx*6 + {ADD=0, SUB=1, SETUP_ADDSUB=2, MUL=3,
DIV=4, SETUP_MULDIV=5} (reference Fp2Opcode, opcode_offset 0x710,
extensions/algebra/transpiler/src/lib.rs:42).  Guest encoding: custom-1
funct3=010, funct7 = fp2_idx*8 + {Add=0, Sub=1, Mul=2, Div=3, Setup=4}.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from . import buses as B
from .bigint import (_adapter_cols, _adapter_eval, _adapter_fill, _fill_flags,
                     _flags, _pad_pow2)
from .buses import Cols
from .mod_builder import ExprBuilder
from .rv32im import _m

FP2_BASE = 0x710
FP2_KINDS = 6
ADD, SUB, SETUP_ADDSUB, MUL, DIV, SETUP_MULDIV = range(6)
L = 32
PL = 2 * L


class _Fp2Base(Air):
    TS_DELTA = 51  # 3 reg reads + 16+16 reads + 16 writes

    def _common_eval(self, b, opcodes):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        f = _flags(b, c, v, 2)
        opcode = f[0] * opcodes[0] + f[1] * opcodes[1]
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True, nl=PL)
        self.eb.emit(b, v,
                     get_input=lambda i: [x[:L], x[L:], y[:L], y[L:]][i],
                     get_var=lambda j: [z[:L], z[L:]][j],
                     get_flag=lambda k: f[k],
                     get_aux=lambda t: b.main(c.index["aux"] + t))

    def _common_trace(self, rec):
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True, nl=PL)
        _fill_flags(t, n, c, rec, 2)
        flags = [(rec["op_idx"] == 0).astype(np.uint64),
                 (rec["op_idx"] == 1).astype(np.uint64)]
        _, aux = self.eb.fill(
            [rec["x"][:, :L], rec["x"][:, L:], rec["y"][:, :L],
             rec["y"][:, L:]], flags,
            var_results=[rec["z"][:, :L], rec["z"][:, L:]])
        t[:n, c.index["aux"]:c.index["aux"] + aux.shape[1]] = aux
        return _pad_pow2(t)


class Fp2AddSubAir(_Fp2Base):
    def __init__(self, modulus: int, fp2_idx: int):
        self.name = f"fp2_addsub_{fp2_idx}"
        self.modulus = modulus
        self.fp2_idx = fp2_idx
        eb = self.eb = ExprBuilder(modulus, L)
        a0, a1, b0, b1 = (eb.input() for _ in range(4))
        f_add = eb.flag()
        f_sub = eb.flag()
        z0 = eb.new_var()
        z1 = eb.new_var()
        eb.constrain_zero((a0 + b0 - z0).flag_mul(f_add)
                          + (a0 - b0 - z0).flag_mul(f_sub))
        eb.constrain_zero((a1 + b1 - z1).flag_mul(f_add)
                          + (a1 - b1 - z1).flag_mul(f_sub))
        c = self.c = Cols()
        _adapter_cols(c, writes=True, nl=PL)
        c.alloc("f", 2)
        c.alloc("aux", eb.aux_width())
        self.width = c.width

    def eval(self, b):
        base = FP2_BASE + self.fp2_idx * FP2_KINDS
        self._common_eval(b, (base + ADD, base + SUB))

    def trace(self, rec):
        return self._common_trace(rec)


class Fp2MulDivAir(_Fp2Base):
    def __init__(self, modulus: int, fp2_idx: int):
        self.name = f"fp2_muldiv_{fp2_idx}"
        self.modulus = modulus
        self.fp2_idx = fp2_idx
        eb = self.eb = ExprBuilder(modulus, L)
        a0, a1, b0, b1 = (eb.input() for _ in range(4))
        f_mul = eb.flag()
        f_div = eb.flag()
        z0 = eb.new_var()
        z1 = eb.new_var()
        eb.constrain_zero((a0 * b0 - a1 * b1 - z0).flag_mul(f_mul)
                          + (z0 * b0 - z1 * b1 - a0).flag_mul(f_div))
        eb.constrain_zero((a0 * b1 + a1 * b0 - z1).flag_mul(f_mul)
                          + (z0 * b1 + z1 * b0 - a1).flag_mul(f_div))
        c = self.c = Cols()
        _adapter_cols(c, writes=True, nl=PL)
        c.alloc("f", 2)
        c.alloc("aux", eb.aux_width())
        self.width = c.width

    def eval(self, b):
        base = FP2_BASE + self.fp2_idx * FP2_KINDS
        self._common_eval(b, (base + MUL, base + DIV))

    def trace(self, rec):
        return self._common_trace(rec)


def fp2_mul(p, a0, a1, b0, b1):
    return (a0 * b0 - a1 * b1) % p, (a0 * b1 + a1 * b0) % p


def fp2_div(p, a0, a1, b0, b1):
    den = (b0 * b0 + b1 * b1) % p
    if den == 0:
        raise ZeroDivisionError("fp2 division by zero")
    inv = pow(den, -1, p)
    return ((a0 * b0 + a1 * b1) * inv % p,
            (a1 * b0 - a0 * b1) * inv % p)


def fp2_airs(moduli) -> dict:
    out = {}
    for i, m in enumerate(moduli):
        for cls in (Fp2AddSubAir, Fp2MulDivAir):
            air = cls(m, i)
            out[air.name] = air
    return out
