"""Fp12 expressions on the mod-builder (pairing circuit layer).

Copy of openvm_tpu/vm/circuit/fp12.py (the whole module: ``Fp2Expr`` :19,
``Fp12Expr`` :51 with ``mul`` :59, ``mul_by_01234`` :77 and ``mul_by_02345``
:97, ``fp12_mul_builder`` :119).  No AIR uses it, as in the JAX package.

Counterpart of the reference `extensions/pairing/circuit/src/fp12.rs`:
Fp12 elements as 6 Fp2 coefficients ``c0 + c1 w + ... + c5 w^5`` over the
FieldExpr AST, with the three sparse products the Miller loop needs —
full ``mul`` (with w^6 = xi folding), ``mul_by_01234`` (D-type line
product) and ``mul_by_02345`` (M-type).  Like the reference, these are
circuit building blocks (constraint generators + witness fillers), not VM
chips — the v1.4 pairing extension's only ISA surface is the HintFinalExp
phantom (`pairing_extension.rs:67-86`), with Miller-loop arithmetic done
through the algebra extension's Fp/Fp2 intrinsics.
"""

from __future__ import annotations

from .mod_builder import ExprBuilder, Node


class Fp2Expr:
    """Pair of limb expressions (reference openvm_algebra_circuit::Fp2)."""

    def __init__(self, eb: ExprBuilder, c0: Node = None, c1: Node = None):
        self.eb = eb
        self.c0 = c0 if c0 is not None else eb.input()
        self.c1 = c1 if c1 is not None else eb.input()

    def add(self, o: "Fp2Expr") -> "Fp2Expr":
        return Fp2Expr(self.eb, self.c0 + o.c0, self.c1 + o.c1)

    def sub(self, o: "Fp2Expr") -> "Fp2Expr":
        return Fp2Expr(self.eb, self.c0 - o.c0, self.c1 - o.c1)

    def mul(self, o: "Fp2Expr") -> "Fp2Expr":
        # (a0 + a1 u)(b0 + b1 u), u^2 = -1
        return Fp2Expr(self.eb,
                       self.c0 * o.c0 - self.c1 * o.c1,
                       self.c0 * o.c1 + self.c1 * o.c0)

    def int_mul(self, xi: tuple) -> "Fp2Expr":
        """Multiply by the small constant xi = x0 + x1 u (reference
        Fp2::int_mul; xi is (9,1) / (1,1))."""
        x0, x1 = xi
        return Fp2Expr(self.eb,
                       self.c0.int_mul(x0) - self.c1.int_mul(x1),
                       self.c0.int_mul(x1) + self.c1.int_mul(x0))

    def save(self) -> "Fp2Expr":
        return Fp2Expr(self.eb, self.eb.save(self.c0), self.eb.save(self.c1))


class Fp12Expr:
    """6 Fp2 coefficients (reference fp12.rs Fp12)."""

    def __init__(self, eb: ExprBuilder, coeffs=None):
        self.eb = eb
        self.c = list(coeffs) if coeffs is not None else \
            [Fp2Expr(eb) for _ in range(6)]

    def mul(self, o: "Fp12Expr", xi: tuple) -> "Fp12Expr":
        """Schoolbook product with w^6 = xi (reference fp12.rs:46-70);
        each output coefficient is saved as a constrained variable."""
        eb = self.eb
        out = []
        for i in range(6):
            s = self.c[0].mul(o.c[i]) if i < 6 else None
            for j in range(1, min(5, i) + 1):
                s = s.add(self.c[j].mul(o.c[i - j]))
            hi = None
            for j in range(i + 1, 6):
                term = self.c[j].mul(o.c[6 + i - j])
                hi = term if hi is None else hi.add(term)
            if hi is not None:
                s = s.add(hi.int_mul(xi))
            out.append(s.save())
        return Fp12Expr(eb, out)

    def mul_by_01234(self, xs, xi: tuple) -> "Fp12Expr":
        """self * (x0 + x1 w + x2 w^2 + x3 w^3 + x4 w^4)
        (reference fp12.rs:72-131, D-type line product)."""
        c = self.c
        x0, x1, x2, x3, x4 = xs
        o0 = c[0].mul(x0).add(
            c[2].mul(x4).add(c[3].mul(x3)).add(c[4].mul(x2))
            .add(c[5].mul(x1)).int_mul(xi))
        o1 = c[0].mul(x1).add(c[1].mul(x0)).add(
            c[3].mul(x4).add(c[4].mul(x3)).add(c[5].mul(x2)).int_mul(xi))
        o2 = c[0].mul(x2).add(c[1].mul(x1)).add(c[2].mul(x0)).add(
            c[4].mul(x4).add(c[5].mul(x3)).int_mul(xi))
        o3 = c[0].mul(x3).add(c[1].mul(x2)).add(c[2].mul(x1)) \
            .add(c[3].mul(x0)).add(c[5].mul(x4).int_mul(xi))
        o4 = c[0].mul(x4).add(c[1].mul(x3)).add(c[2].mul(x2)) \
            .add(c[3].mul(x1)).add(c[4].mul(x0))
        o5 = c[1].mul(x4).add(c[2].mul(x3)).add(c[3].mul(x2)) \
            .add(c[4].mul(x1)).add(c[5].mul(x0))
        return Fp12Expr(self.eb, [o.save() for o in (o0, o1, o2, o3, o4, o5)])

    def mul_by_02345(self, xs, xi: tuple) -> "Fp12Expr":
        """self * (x0 + x2 w^2 + x3 w^3 + x4 w^4 + x5 w^5)
        (reference fp12.rs:132-196, M-type line product)."""
        c = self.c
        x0, x2, x3, x4, x5 = xs
        o0 = c[0].mul(x0).add(
            c[1].mul(x5).add(c[2].mul(x4)).add(c[3].mul(x3))
            .add(c[4].mul(x2)).int_mul(xi))
        o1 = c[1].mul(x0).add(
            c[2].mul(x5).add(c[3].mul(x4)).add(c[4].mul(x3))
            .add(c[5].mul(x2)).int_mul(xi))
        o2 = c[0].mul(x2).add(c[2].mul(x0)).add(
            c[3].mul(x5).add(c[4].mul(x4)).add(c[5].mul(x3)).int_mul(xi))
        o3 = c[0].mul(x3).add(c[1].mul(x2)).add(c[3].mul(x0)).add(
            c[4].mul(x5).add(c[5].mul(x4)).int_mul(xi))
        o4 = c[0].mul(x4).add(c[1].mul(x3)).add(c[2].mul(x2)) \
            .add(c[4].mul(x0)).add(c[5].mul(x5).int_mul(xi))
        o5 = c[0].mul(x5).add(c[1].mul(x4)).add(c[2].mul(x3)) \
            .add(c[3].mul(x2)).add(c[5].mul(x0))
        return Fp12Expr(self.eb, [o.save() for o in (o0, o1, o2, o3, o4, o5)])


def fp12_mul_builder(modulus: int, xi: tuple, num_limbs: int = 32):
    """(builder, output var indices) for z = x * y in Fp12 — 24 Fp inputs,
    12 saved output vars (reference fp12.rs test_fp12_mul)."""
    eb = ExprBuilder(modulus, num_limbs=num_limbs)
    x = Fp12Expr(eb)
    y = Fp12Expr(eb)
    z = x.mul(y, xi)
    out_idx = [v.kw["idx"] for coeff in z.c for v in (coeff.c0, coeff.c1)]
    return eb, out_idx
