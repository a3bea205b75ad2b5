"""ECC (short Weierstrass) extension: EC_ADD_NE / EC_DOUBLE chips.

Copy of openvm_tpu/vm/circuit/ecc.py (the whole module: ``EcAddNeAir``
:66, ``EcDoubleAir`` :130, ``ecc_airs`` :257, ``_lambda_add`` and
``_lambda_double`` :41-46), itself a re-design of the reference ECC extension
(reference extensions/ecc/circuit/src/weierstrass_chip/, SURVEY.md
section 2.10): affine point add (distinct x) and double over a configured
curve y^2 = x^3 + a*x + b, built from mod-builder equations:

  add-ne:  lam*(x2-x1) = y2-y1;  x3 = lam^2-x1-x2;  y3 = lam*(x1-x3)-y1
  double:  lam*2y1 = 3*x1^2 + a; x3 = lam^2-2x1;    y3 = lam*(x1-x3)-y1

Points are 64-byte heap blocks (x||y, 32 limbs each) behind register
pointers (the reference's Rv32VecHeapAdapter at BLOCKS=2, BLOCK_SIZE=32).
Like the reference's EC_ADD_NE, the add chip's lambda equation constrains
nothing when x1 == x2 (mod p) — guests must use EC_DOUBLE there (the
"_NE" contract).

Opcode space: 0x600 + curve_idx*4 + {EC_ADD_NE=0, SETUP_EC_ADD_NE=1,
EC_DOUBLE=2, SETUP_EC_DOUBLE=3} (reference Rv32WeierstrassOpcode,
extensions/ecc/transpiler/src/lib.rs:14-22).  SETUP_* lowers to a no-op
(curve constants live in the verifying key).
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from . import buses as B
from .bigint import (_adapter_cols, _adapter_eval, _adapter_fill,
                     _pad_pow2, _ptr_word_addr)
from .buses import Cols
from .mod_builder import ExprBuilder
from .rv32im import _m, _marr, _ts_diff

P = 2013265921
SW_BASE = 0x600
SW_KINDS = 4
EC_ADD_NE, SETUP_EC_ADD_NE, EC_DOUBLE, SETUP_EC_DOUBLE = range(4)
L = 32  # limbs per coordinate
PL = 2 * L  # limbs per point


def _lambda_add(p, x1, y1, x2, y2):
    return ((y2 - y1) * pow((x2 - x1) % p, -1, p)) % p


def _lambda_double(p, a, x1, y1):
    return ((3 * x1 * x1 + a) * pow((2 * y1) % p, -1, p)) % p


def _limbs(v: int) -> list:
    return [(v >> (8 * i)) & 255 for i in range(L)]


def _row_ints(arr):
    """(n, L) limb array -> list of python ints."""
    out = []
    for r in range(arr.shape[0]):
        v = 0
        for i in range(L - 1, -1, -1):
            v = (v << 8) + int(arr[r, i])
        out.append(v)
    return out


class EcAddNeAir(Air):
    TS_DELTA = 51  # 3 reg reads + 16+16 word reads + 16 writes

    def __init__(self, modulus: int, a_coeff: int, curve_idx: int):
        self.name = f"sw_add_ne_{curve_idx}"
        self.modulus = modulus
        self.curve_idx = curve_idx
        eb = self.eb = ExprBuilder(modulus, L)
        x1, y1, x2, y2 = (eb.input() for _ in range(4))
        lam = eb.new_var()
        x3 = eb.new_var()
        y3 = eb.new_var()
        eb.constrain_zero(lam * (x2 - x1) - (y2 - y1))
        eb.constrain_zero(lam * lam - x1 - x2 - x3)
        eb.constrain_zero(lam * (x1 - x3) - y1 - y3)
        c = self.c = Cols()
        _adapter_cols(c, writes=True, nl=PL)
        c.alloc("lam", L)
        c.alloc("aux", eb.aux_width())
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        opcode = SW_BASE + self.curve_idx * SW_KINDS + EC_ADD_NE
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        x, y, z = _adapter_eval(b, c, v, pc, ts, opcode, writes=True, nl=PL)
        lam = _marr(b, c, "lam", L)
        inputs = [x[:L], x[L:], y[:L], y[L:]]  # x1, y1, x2, y2
        vars_ = [lam, z[:L], z[L:]]
        self.eb.emit(b, v,
                     get_input=lambda i: inputs[i],
                     get_var=lambda j: vars_[j],
                     get_flag=lambda k: None,
                     get_aux=lambda t: b.main(c.index["aux"] + t))
        for i in range(0, L, 2):  # lam limbs are witness: byte-check
            B.byte_pair_check(b, lam[i], lam[i + 1], v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        _adapter_fill(t, n, c, rec, writes=True, nl=PL)
        x1 = _row_ints(rec["x"][:, :L])
        y1 = _row_ints(rec["x"][:, L:])
        x2 = _row_ints(rec["y"][:, :L])
        y2 = _row_ints(rec["y"][:, L:])
        lam = np.asarray(
            [_limbs(_lambda_add(self.modulus, x1[r], y1[r], x2[r], y2[r]))
             for r in range(n)], dtype=np.uint64)
        t[:n, c.index["lam"]:c.index["lam"] + L] = lam
        _, aux = self.eb.fill(
            [rec["x"][:, :L], rec["x"][:, L:], rec["y"][:, :L],
             rec["y"][:, L:]], [],
            var_results=[lam, rec["z"][:, :L], rec["z"][:, L:]])
        t[:n, c.index["aux"]:c.index["aux"] + aux.shape[1]] = aux
        return _pad_pow2(t)


class EcDoubleAir(Air):
    """Single-point-input variant: reads rs1 point, writes rd point."""

    TS_DELTA = 34  # 2 reg reads + 16 word reads + 16 writes

    def __init__(self, modulus: int, a_coeff: int, curve_idx: int):
        self.name = f"sw_double_{curve_idx}"
        self.modulus = modulus
        self.a_coeff = a_coeff % modulus
        self.curve_idx = curve_idx
        eb = self.eb = ExprBuilder(modulus, L)
        x1 = eb.input()
        y1 = eb.input()
        lam = eb.new_var()
        x3 = eb.new_var()
        y3 = eb.new_var()
        eb.constrain_zero(lam * (y1 + y1) - (x1 * x1).int_mul(3)
                          - eb.const(self.a_coeff))
        eb.constrain_zero(lam * lam - x1 - x1 - x3)
        eb.constrain_zero(lam * (x1 - x3) - y1 - y3)
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("pc"), c.alloc("ts")
        c.alloc("a"), c.alloc("b"), c.alloc("cc")
        for tag in ("r1", "rd"):
            c.alloc(f"{tag}p", 4)
            c.alloc(f"pts_{tag}"), c.alloc(f"dlo_{tag}"), c.alloc(f"dhi_{tag}")
            c.alloc(f"wa_{tag}_lo"), c.alloc(f"wa_{tag}_hi")
        c.alloc("x", PL)
        c.alloc("pts_x", PL // 4)
        c.alloc("dlo_x", PL // 4), c.alloc("dhi_x", PL // 4)
        c.alloc("z", PL), c.alloc("prevz", PL)
        c.alloc("pts_z", PL // 4)
        c.alloc("dlo_z", PL // 4), c.alloc("dhi_z", PL // 4)
        c.alloc("lam", L)
        c.alloc("aux", eb.aux_width())
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v)
        oa, ob = _m(b, c, "a"), _m(b, c, "b")
        opcode = SW_BASE + self.curve_idx * SW_KINDS + EC_DOUBLE
        B.exec_receive(b, pc, ts, v)
        B.exec_send(b, pc + 4, ts + self.TS_DELTA, v)
        B.fetch(b, pc, opcode, [4 * oa, 4 * ob, 0, 1, 2, 0, 0], v)
        for tag, operand, tick in (("r1", ob, 0), ("rd", oa, 1)):
            B.mem_read(b, B.AS_REGISTER, operand,
                       _marr(b, c, f"{tag}p", 4), _m(b, c, f"pts_{tag}"),
                       ts + tick, _m(b, c, f"dlo_{tag}"),
                       _m(b, c, f"dhi_{tag}"), v)
        wa1 = _ptr_word_addr(b, c, v, "r1")
        wad = _ptr_word_addr(b, c, v, "rd")
        x = _marr(b, c, "x", PL)
        z = _marr(b, c, "z", PL)
        prevz = _marr(b, c, "prevz", PL)
        wn = PL // 4
        for k in range(wn):
            B.mem_read(b, B.AS_MEMORY, wa1 + k, x[4 * k:4 * k + 4],
                       b.main(c.index["pts_x"] + k), ts + 2 + k,
                       b.main(c.index["dlo_x"] + k),
                       b.main(c.index["dhi_x"] + k), v)
            B.mem_write(b, B.AS_MEMORY, wad + k, z[4 * k:4 * k + 4],
                        prevz[4 * k:4 * k + 4],
                        b.main(c.index["pts_z"] + k), ts + 2 + wn + k,
                        b.main(c.index["dlo_z"] + k),
                        b.main(c.index["dhi_z"] + k), v)
        lam = _marr(b, c, "lam", L)
        inputs = [x[:L], x[L:]]
        vars_ = [lam, z[:L], z[L:]]
        self.eb.emit(b, v,
                     get_input=lambda i: inputs[i],
                     get_var=lambda j: vars_[j],
                     get_flag=lambda k: None,
                     get_aux=lambda t: b.main(c.index["aux"] + t))
        for i in range(0, L, 2):
            B.byte_pair_check(b, lam[i], lam[i + 1], v)

    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"])
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)
        c = self.c
        ix = c.index
        t[:n, ix["is_valid"]] = 1
        for nm in ("pc", "ts", "a", "b"):
            t[:n, ix[nm]] = rec[nm]
        ts = rec["ts"]
        for tag, fld, tick in (("r1", "rs1p", 0), ("rd", "rdp", 1)):
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
        t[:n, ix["x"]:ix["x"] + PL] = rec["x"]
        t[:n, ix["z"]:ix["z"] + PL] = rec["z"]
        t[:n, ix["prevz"]:ix["prevz"] + PL] = rec["prevz"]
        wn = PL // 4
        for tag, base in (("x", 2), ("z", 2 + wn)):
            pts = rec[f"pts_{tag}"]
            t[:n, ix[f"pts_{tag}"]:ix[f"pts_{tag}"] + wn] = pts
            for k in range(wn):
                lo, hi = _ts_diff(pts[:, k], ts + base + k)
                t[:n, ix[f"dlo_{tag}"] + k] = lo
                t[:n, ix[f"dhi_{tag}"] + k] = hi
        x1 = _row_ints(rec["x"][:, :L])
        y1 = _row_ints(rec["x"][:, L:])
        lam = np.asarray(
            [_limbs(_lambda_double(self.modulus, self.a_coeff, x1[r],
                                   y1[r])) for r in range(n)],
            dtype=np.uint64)
        t[:n, ix["lam"]:ix["lam"] + L] = lam
        _, aux = self.eb.fill(
            [rec["x"][:, :L], rec["x"][:, L:]], [],
            var_results=[lam, rec["z"][:, :L], rec["z"][:, L:]])
        t[:n, ix["aux"]:ix["aux"] + aux.shape[1]] = aux
        return _pad_pow2(t)


def ecc_airs(curves) -> dict:
    """curves: sequence of (modulus, a_coeff) tuples."""
    out = {}
    for i, (p, a) in enumerate(curves):
        add = EcAddNeAir(p, a, i)
        dbl = EcDoubleAir(p, a, i)
        out[add.name] = add
        out[dbl.name] = dbl
    return out
