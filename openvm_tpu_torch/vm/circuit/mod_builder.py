"""Mod-builder: symbolic modular-arithmetic circuit compiler.

Copy of openvm_tpu/vm/circuit/mod_builder.py (the whole module: ExprBuilder,
its ``emit`` :258 and ``fill`` :376, ``int_to_limbs``).

TPU-native re-design of the reference mod-builder
(reference crates/circuits/mod-builder/src/{builder,symbolic_expr,
core_chip}.rs, SURVEY.md section 2.14): expressions over multi-limb
modular integers compile to carry-chained limb constraints with
automatically-sized quotient (q) and carry witness columns, plus
vectorized numpy tracegen — the circuit "compiler" that makes
algebra/ecc/pairing chips cheap to define.

Design notes (vs the reference's Rust builder):
  * An expression AST node tracks, per limb position, a symbolic value
    (affine in trace columns, products allowed to depth matching the
    max constraint degree 3) and an integer bound.
  * `save(expr)` introduces a variable `z` and the integer equation
        expr - z - (q_u - Q_OFF) * N - ... = 0
    where q_u is an unsigned byte-limbed witness offset by Q_OFF so the
    quotient may be negative.  The equation is enforced limb-wise with a
    signed running carry, each carry range-checked via an offset.
  * Every term must vanish on padding rows (all columns zero); constants
    are therefore multiplied by `is_valid` when emitted.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import buses as B

P = 2013265921
LIMB_BITS = 8
LB = 1 << LIMB_BITS  # 256


def int_to_limbs(v: int, n: int) -> list:
    return [(v >> (LIMB_BITS * i)) & (LB - 1) for i in range(n)]


def limbs_needed(v: int) -> int:
    return max(1, (v.bit_length() + LIMB_BITS - 1) // LIMB_BITS)


class Node:
    """AST node: evaluates to a limbed integer.

    kind: input(idx) | const(value) | var(idx) | add | sub | mul |
          int_mul(scalar) | flagmul(flag_idx)
    """

    def __init__(self, kind, children=(), **kw):
        self.kind = kind
        self.children = list(children)
        self.kw = kw

    def __add__(self, o):
        return Node("add", [self, _n(o)])

    def __sub__(self, o):
        return Node("sub", [self, _n(o)])

    def __mul__(self, o):
        return Node("mul", [self, _n(o)])

    def int_mul(self, k: int):
        return Node("int_mul", [self], k=k)

    def flag_mul(self, flag_idx: int):
        """Multiply by a 0/1 flag column (selector gating)."""
        return Node("flagmul", [self], flag=flag_idx)


def _n(x):
    if isinstance(x, Node):
        return x
    raise TypeError(x)


def select(flag_idx: int, a: Node, b: Node) -> Node:
    """flag ? a : b  ==  flag*a + (1-flag)*b, emitted as two flag-muls."""
    return Node("add", [a.flag_mul(flag_idx),
                        Node("flagnot", [b], flag=flag_idx)])


@dataclass
class Equation:
    expr: Node          # integer equation:  expr - var = 0 (mod N)
    var_idx: int        # result variable index (-1: plain zero equation)
    q_limbs: int
    q_off: int
    n_pos: int          # carry-chain positions
    carry_bits: int     # shifted-carry width
    carry_off: int      # carry offset (carries stored as c + carry_off)
    carry_split: bool   # True: two cols (lo15, hi) per carry

    @property
    def carry_cols(self) -> int:
        return 2 * self.n_pos if self.carry_split else self.n_pos


class ExprBuilder:
    """Collects inputs/flags/vars and compiles saved equations."""

    def __init__(self, modulus: int, num_limbs: int = 32):
        assert modulus > 1
        self.N = modulus
        self.L = num_limbs
        self.n_inputs = 0
        self.n_flags = 0
        self.n_vars = 0
        self.eqs: list[Equation] = []

    # -- AST construction -------------------------------------------------
    def input(self) -> Node:
        self.n_inputs += 1
        return Node("input", idx=self.n_inputs - 1)

    def flag(self) -> int:
        self.n_flags += 1
        return self.n_flags - 1

    def const(self, value: int) -> Node:
        return Node("const", value=value % self.N)

    def var(self, idx: int) -> Node:
        return Node("var", idx=idx)

    def new_var(self) -> Node:
        """Allocate a var with no defining equation (value supplied at
        tracegen; constrained via constrain_zero by the caller)."""
        vi = self.n_vars
        self.n_vars += 1
        return Node("var", idx=vi)

    def save(self, expr: Node) -> Node:
        """Introduce var z with  expr ≡ z (mod N); returns the var node."""
        vi = self.n_vars
        self.n_vars += 1
        self._add_eq(expr, vi)
        return Node("var", idx=vi)

    def constrain_zero(self, expr: Node):
        """Require expr ≡ 0 (mod N) (e.g. div: z*y - x)."""
        self._add_eq(expr, -1)

    # -- bounds ------------------------------------------------------------
    def _bounds(self, node: Node):
        """Returns (limb_lo, limb_hi, n_limbs) integer bounds per limb."""
        k = node.kind
        if k == "input":
            return 0, LB - 1, self.L
        if k == "var":
            return 0, LB - 1, self.L
        if k == "const":
            return 0, LB - 1, limbs_needed(node.kw["value"] or 1)
        if k in ("flagmul", "flagnot"):
            lo, hi, n = self._bounds(node.children[0])
            return min(lo, 0), max(hi, 0), n
        if k == "int_mul":
            lo, hi, n = self._bounds(node.children[0])
            s = node.kw["k"]
            v = sorted((lo * s, hi * s))
            return v[0], v[1], n
        a_lo, a_hi, a_n = self._bounds(node.children[0])
        b_lo, b_hi, b_n = self._bounds(node.children[1])
        if k == "add":
            return a_lo + b_lo, a_hi + b_hi, max(a_n, b_n)
        if k == "sub":
            return a_lo - b_hi, a_hi - b_lo, max(a_n, b_n)
        if k == "mul":
            prods = [a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi]
            m = min(a_n, b_n)
            return m * min(prods), m * max(prods), a_n + b_n - 1
        raise ValueError(k)

    def _add_eq(self, expr: Node, var_idx: int):
        lo, hi, n_limbs = self._bounds(expr)
        # integer bound of |expr - var|
        max_abs = max(abs(lo), abs(hi)) * ((1 << (LIMB_BITS * n_limbs))
                                           // (LB - 1) + 1) + (1 << (LIMB_BITS * self.L))
        q_max = max_abs // self.N + 1
        q_limbs = limbs_needed(2 * q_max)
        q_off = 1 << (LIMB_BITS * q_limbs - 1)
        n_pos = max(n_limbs, self.L, q_limbs + limbs_needed(self.N) - 1,
                    limbs_needed(q_off * self.N))
        # per-position magnitude bound -> carry bound
        e_max = (max(abs(lo), abs(hi))
                 + (LB - 1)                                  # var limb
                 + min(q_limbs, limbs_needed(self.N)) * (LB - 1) ** 2
                 + (LB - 1))                                 # q_off*N limb
        c_max = 0
        for _ in range(4):
            c_max = (e_max + c_max) // LB + 1
        carry_off = 1 << max(c_max.bit_length(), 1)
        carry_bits = (2 * carry_off - 1).bit_length()
        self.eqs.append(Equation(expr, var_idx, q_limbs, q_off,
                                 n_pos, carry_bits, carry_off,
                                 carry_split=carry_bits > 15))

    # -- compiled layout ---------------------------------------------------
    def aux_width(self) -> int:
        return sum(eq.q_limbs + eq.carry_cols for eq in self.eqs)

    def var_width(self) -> int:
        return self.n_vars * self.L

    # -- symbolic emission -------------------------------------------------
    def _limb_exprs(self, node: Node, get_input, get_var, get_flag, v):
        """Symbolic per-limb expressions for `node` (list of exprs)."""
        k = node.kind
        if k == "input":
            return list(get_input(node.kw["idx"]))
        if k == "var":
            return list(get_var(node.kw["idx"]))
        if k == "const":
            return [v * c for c in
                    int_to_limbs(node.kw["value"],
                                 limbs_needed(node.kw["value"] or 1))]
        if k == "flagmul":
            f = get_flag(node.kw["flag"])
            return [f * e for e in self._limb_exprs(
                node.children[0], get_input, get_var, get_flag, v)]
        if k == "flagnot":
            f = get_flag(node.kw["flag"])
            return [(v - f) * e for e in self._limb_exprs(
                node.children[0], get_input, get_var, get_flag, v)]
        if k == "int_mul":
            s = node.kw["k"] % P
            return [e * s for e in self._limb_exprs(
                node.children[0], get_input, get_var, get_flag, v)]
        a = self._limb_exprs(node.children[0], get_input, get_var, get_flag,
                             v)
        b = self._limb_exprs(node.children[1], get_input, get_var, get_flag,
                             v)
        if k in ("add", "sub"):
            n = max(len(a), len(b))
            out = []
            for i in range(n):
                ai = a[i] if i < len(a) else None
                bi = b[i] if i < len(b) else None
                if ai is None:
                    out.append(bi if k == "add" else 0 - bi)
                elif bi is None:
                    out.append(ai)
                else:
                    out.append(ai + bi if k == "add" else ai - bi)
            return out
        if k == "mul":
            out = [None] * (len(a) + len(b) - 1)
            for i, ai in enumerate(a):
                for j, bj in enumerate(b):
                    t = ai * bj
                    out[i + j] = t if out[i + j] is None else out[i + j] + t
            return out
        raise ValueError(k)

    def emit(self, b, v, get_input, get_var, get_flag, get_aux):
        """Emit all equation constraints + range checks into AIR builder b.

        get_input(i) -> list of L column exprs (input i limbs)
        get_var(j)   -> list of L column exprs (var j limbs)
        get_flag(k)  -> flag column expr
        get_aux(t)   -> aux column expr (flat index over q limbs + carries
                        in equation order)
        """
        aux_base = 0
        NL = limbs_needed(self.N)
        N_limbs = int_to_limbs(self.N, NL)
        for eq in self.eqs:
            e = self._limb_exprs(eq.expr, get_input, get_var, get_flag, v)
            # pad to n_pos
            e = [e[i] if i < len(e) else None for i in range(eq.n_pos)]
            if eq.var_idx >= 0:
                zv = get_var(eq.var_idx)
                for i in range(self.L):
                    e[i] = zv[i] * (-1 % P) if e[i] is None else e[i] - zv[i]
            q_cols = [get_aux(aux_base + t) for t in range(eq.q_limbs)]
            if eq.carry_split:
                carry_cols = []
                for t in range(eq.n_pos):
                    lo = get_aux(aux_base + eq.q_limbs + 2 * t)
                    hi = get_aux(aux_base + eq.q_limbs + 2 * t + 1)
                    B.range_check(b, lo, 15, v)
                    B.range_check(b, hi, eq.carry_bits - 15, v)
                    carry_cols.append(lo + (1 << 15) * hi)
            else:
                carry_cols = [get_aux(aux_base + eq.q_limbs + t)
                              for t in range(eq.n_pos)]
            aux_base += eq.q_limbs + eq.carry_cols
            # - q_u * N
            for i, qi in enumerate(q_cols):
                for j, nj in enumerate(N_limbs):
                    t = qi * ((-nj) % P)
                    p_ = i + j
                    e[p_] = t if e[p_] is None else e[p_] + t
            # + Q_OFF * N (constant, v-gated)
            offN = int_to_limbs(eq.q_off * self.N,
                                limbs_needed(eq.q_off * self.N))
            for i, c_ in enumerate(offN):
                if c_ == 0:
                    continue
                t = v * c_
                e[i] = t if e[i] is None else e[i] + t
            # byte checks on q
            for i in range(0, eq.q_limbs - 1, 2):
                B.byte_pair_check(b, q_cols[i], q_cols[i + 1], v)
            if eq.q_limbs % 2:
                B.byte_pair_check(b, q_cols[-1], 0 * v, v)
            # carry chain:  e_i + c_{i-1} - 256*c_i = 0 with c stored
            # offset:  c_col = c + carry_off  (so c = c_col - v*carry_off)
            coff = eq.carry_off
            for i in range(eq.n_pos):
                c_prev = (carry_cols[i - 1] - v * coff) if i else 0
                c_here = carry_cols[i] - v * coff
                ei = e[i] if e[i] is not None else 0 * v
                b.assert_zero(ei + c_prev - LB * c_here)
                if not eq.carry_split:
                    B.range_check(b, carry_cols[i], eq.carry_bits, v)
            # final carry must be zero: c_{n_pos-1} = 0  (offset form)
            b.assert_zero(carry_cols[eq.n_pos - 1] - v * coff)

    # -- numeric tracegen --------------------------------------------------
    def _limb_vals(self, node: Node, inputs, var_vals, flags, n):
        k = node.kind
        if k == "input":
            return inputs[node.kw["idx"]].astype(np.int64)
        if k == "var":
            return var_vals[node.kw["idx"]].astype(np.int64)
        if k == "const":
            nl = limbs_needed(node.kw["value"] or 1)
            return np.tile(np.asarray(int_to_limbs(node.kw["value"], nl),
                                      dtype=np.int64), (n, 1))
        if k == "flagmul":
            return (self._limb_vals(node.children[0], inputs, var_vals,
                                    flags, n)
                    * flags[node.kw["flag"]][:, None].astype(np.int64))
        if k == "flagnot":
            return (self._limb_vals(node.children[0], inputs, var_vals,
                                    flags, n)
                    * (1 - flags[node.kw["flag"]][:, None].astype(np.int64)))
        if k == "int_mul":
            return self._limb_vals(node.children[0], inputs, var_vals,
                                   flags, n) * node.kw["k"]
        a = self._limb_vals(node.children[0], inputs, var_vals, flags, n)
        bv = self._limb_vals(node.children[1], inputs, var_vals, flags, n)
        if k == "add":
            w = max(a.shape[1], bv.shape[1])
            out = np.zeros((n, w), dtype=np.int64)
            out[:, :a.shape[1]] += a
            out[:, :bv.shape[1]] += bv
            return out
        if k == "sub":
            w = max(a.shape[1], bv.shape[1])
            out = np.zeros((n, w), dtype=np.int64)
            out[:, :a.shape[1]] += a
            out[:, :bv.shape[1]] -= bv
            return out
        if k == "mul":
            w = a.shape[1] + bv.shape[1] - 1
            out = np.zeros((n, w), dtype=np.int64)
            for i in range(a.shape[1]):
                out[:, i:i + bv.shape[1]] += a[:, i:i + 1] * bv
            return out
        raise ValueError(k)

    @staticmethod
    def _limbs_to_ints(arr) -> list:
        out = [0] * arr.shape[0]
        for i in range(arr.shape[1] - 1, -1, -1):
            col = arr[:, i]
            for r in range(arr.shape[0]):
                out[r] = (out[r] << LIMB_BITS) + int(col[r])
        return out

    def fill(self, inputs, flags, var_results=None):
        """Numeric witness generation.

        inputs: list of (n, L) uint arrays; flags: list of (n,) 0/1 arrays.
        var_results: optional precomputed var values (list of (n, L)) —
        needed when a var is defined through constrain_zero (e.g. div
        results computed by modular inverse in the caller/preflight).
        Returns (var_arrays, aux_array (n, aux_width)).
        """
        n = inputs[0].shape[0] if inputs else flags[0].shape[0]
        var_vals: list = [None] * self.n_vars
        if var_results:
            for i, vr in enumerate(var_results):
                if vr is not None:
                    var_vals[i] = np.asarray(vr, dtype=np.uint64)
        aux = np.zeros((n, self.aux_width()), dtype=np.uint64)
        aux_base = 0
        NL = limbs_needed(self.N)
        N_limbs = np.asarray(int_to_limbs(self.N, NL), dtype=np.int64)
        for eq in self.eqs:
            # compute var value if not supplied
            if eq.var_idx >= 0 and var_vals[eq.var_idx] is None:
                ev = self._limb_vals(eq.expr, inputs, var_vals, flags, n)
                ints = self._limbs_to_ints(ev)
                zs = [v_ % self.N for v_ in ints]
                var_vals[eq.var_idx] = np.asarray(
                    [int_to_limbs(z, self.L) for z in zs], dtype=np.uint64)
            ev = self._limb_vals(eq.expr, inputs, var_vals, flags, n)
            e = np.zeros((n, eq.n_pos), dtype=np.int64)
            e[:, :ev.shape[1]] = ev
            if eq.var_idx >= 0:
                e[:, :self.L] -= var_vals[eq.var_idx].astype(np.int64)
            ints = self._limbs_to_ints(e)
            # q = value / N  (exact)
            qs = []
            for v_ in ints:
                assert v_ % self.N == 0, "mod equation does not hold"
                qs.append(v_ // self.N)
            # write q_u = q + q_off limbs; subtract q_u*N - q_off*N from e
            q_arr = np.zeros((n, eq.q_limbs), dtype=np.int64)
            for r, q in enumerate(qs):
                qu = q + eq.q_off
                assert 0 <= qu < (1 << (LIMB_BITS * eq.q_limbs)), \
                    "quotient out of range"
                q_arr[r] = int_to_limbs(qu, eq.q_limbs)
            aux[:, aux_base:aux_base + eq.q_limbs] = q_arr
            for i in range(eq.q_limbs):
                e[:, i:i + NL] -= q_arr[:, i:i + 1] * N_limbs
            offN = int_to_limbs(eq.q_off * self.N,
                                limbs_needed(eq.q_off * self.N))
            e[:, :len(offN)] += np.asarray(offN, dtype=np.int64)
            # carry chain
            c = np.zeros(n, dtype=np.int64)
            for i in range(eq.n_pos):
                tot = e[:, i] + c
                assert (tot % LB == 0).all(), "carry chain broken"
                c = tot // LB
                shifted = (c + eq.carry_off).astype(np.uint64)
                if eq.carry_split:
                    aux[:, aux_base + eq.q_limbs + 2 * i] = shifted & 0x7FFF
                    aux[:, aux_base + eq.q_limbs + 2 * i + 1] = shifted >> 15
                else:
                    aux[:, aux_base + eq.q_limbs + i] = shifted
            assert (c == 0).all(), "final carry nonzero"
            aux_base += eq.q_limbs + eq.carry_cols
        return var_vals, aux
