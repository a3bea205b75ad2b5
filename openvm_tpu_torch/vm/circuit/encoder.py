"""Flag encoder: many mutually-exclusive selectors in few columns.

Copy of openvm_tpu/vm/circuit/encoder.py (the whole module).  No AIR of
the port uses it yet.

Role of the reference's ``crates/circuits/primitives/src/encoder/mod.rs``:
represent ``flag_cnt`` selectors as points in F^k with coordinates in
[0, max_degree] summing to at most max_degree; the flag expression for a
point is its multivariate Lagrange polynomial over that solution set
(degree == max_degree), so k = O(flag_cnt^(1/max_degree)) columns encode
what one-hot encoding spends flag_cnt columns on.

Usage in a chip::

    enc = Encoder(flag_cnt=9, max_degree=2)   # 3 vars instead of 9 bools
    vars_ = [b.main(c.index["sel"] + i) for i in range(enc.width)]
    enc.eval(b, vars_)                        # well-formedness constraints
    flags = enc.flags(vars_)                  # degree-2 selector exprs
    ...
    row[c.index["sel"]:...] = enc.flag_pt(flag_idx)   # tracegen

The zero point is reserved for invalid/dummy rows by default
(``is_valid = 1 - flag_expr(zero point)``).
"""

from __future__ import annotations

from ...field.babybear import P


def _binom_points(k: int, max_degree: int):
    """All points in [0, max_degree]^k with coordinate sum <= max_degree,
    in the reference's enumeration order (counting order of mod.rs:58-79:
    lexicographic by successive increments from (0,...,0))."""
    pts = [[0] * k]
    cur = [0] * k
    while True:
        # increment like an odometer keeping sum <= max_degree
        i = 0
        while i < k:
            if sum(cur) < max_degree:
                cur[i] += 1
                break
            cur[i] = 0
            i += 1
        if i == k:
            break
        pts.append(list(cur))
    return pts


class Encoder:
    """k-variable, degree-``max_degree`` selector encoding (reference
    Encoder, crates/circuits/primitives/src/encoder/mod.rs:14-34)."""

    def __init__(self, flag_cnt: int, max_degree: int = 2,
                 reserve_invalid: bool = True):
        self.flag_cnt = flag_cnt
        self.max_degree = max_degree
        self.reserve_invalid = reserve_invalid

        def binom(x):
            r = 1
            for i in range(1, max_degree + 1):
                r = r * (x + i) // i
            return r

        k = 0
        while binom(k) < flag_cnt + int(reserve_invalid):
            k += 1
        self.var_cnt = k
        self.pts = _binom_points(k, max_degree)

    @property
    def width(self) -> int:
        return self.var_cnt

    def _expr_for_point(self, pt, vars_):
        """Lagrange polynomial: 1 at pt, 0 at every other solution point
        (reference expression_for_point, encoder/mod.rs:87-115)."""
        expr = 1
        denom = 1
        for i, coord in enumerate(pt):
            for j in range(coord):
                expr = expr * (vars_[i] - j)
                denom = denom * (coord - j) % P
        s = sum(pt)
        var_sum = 0
        for v in vars_:
            var_sum = var_sum + v
        for j in range(self.max_degree - s):
            expr = expr * (self.max_degree - j - var_sum)
            denom = denom * (j + 1) % P
        return expr * pow(denom, -1, P)

    def flag_expr(self, flag_idx: int, vars_):
        assert flag_idx < self.flag_cnt
        return self._expr_for_point(
            self.pts[flag_idx + int(self.reserve_invalid)], vars_)

    def flags(self, vars_):
        return [self.flag_expr(i, vars_) for i in range(self.flag_cnt)]

    def flag_pt(self, flag_idx: int):
        """Coordinates to write into the trace for this flag."""
        assert flag_idx < self.flag_cnt
        return list(self.pts[flag_idx + int(self.reserve_invalid)])

    def is_valid(self, vars_):
        """1 iff the variables encode any real flag (not the zero point)."""
        return 1 - self._expr_for_point(self.pts[0], vars_)

    def sum_of_unused(self, vars_):
        """Sum of Lagrange polynomials of unused points — constrained to 0
        so variables can only encode real flags (or the invalid point)."""
        expr = 0
        for i in range(self.flag_cnt + int(self.reserve_invalid),
                       len(self.pts)):
            expr = expr + self._expr_for_point(self.pts[i], vars_)
        return expr

    def eval(self, b, vars_):
        """Well-formedness (reference SubAir impl, encoder/mod.rs:166-189):
        each var in [0, max_degree], their sum <= max_degree, and no unused
        point is taken.  Constraint degree is max_degree + 1."""
        for v in vars_:
            expr = 1
            for j in range(self.max_degree + 1):
                expr = expr * (v - j)
            b.assert_zero(expr)
        var_sum = 0
        for v in vars_:
            var_sum = var_sum + v
        expr = 1
        for j in range(self.max_degree + 1):
            expr = expr * (var_sum - j)
        b.assert_zero(expr)
        b.assert_zero(self.sum_of_unused(vars_))
