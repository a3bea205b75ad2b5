"""Fp2 / Fp12 tower arithmetic over Python integers (host side).

Copy of openvm_tpu/pairing/tower.py (the whole module: ``Tower`` :30-204,
its Fp2 ops :39-86, ``f12_mul`` :96, ``f12_inv`` :124, ``f12_frobenius``
:179, ``f12_to_bytes``/``f12_from_bytes`` :189-204).  The guest emitter of
``vm.guest`` subclasses ``Tower`` to record these ops as Fp2 instructions.

Mirrors the reference pairing guest-lib semantics
(`extensions/pairing/guest/src/halo2curves_shims/{bn254,
bls12_381}`): Fp2 = Fp[u]/(u^2+1), Fp12 = Fp2[w]/(w^6 - xi) with elements
stored as 6 Fp2 coefficients ``c0 + c1 w + ... + c5 w^5`` (the same layout
as the circuit Fp12, reference `extensions/pairing/circuit/src/fp12.rs:7-11`).

This module is the execution/hint side of the pairing extension: the VM's
``HintFinalExp`` phantom and the pairing guest-lib equivalents run on it.
Elements are plain tuples — ``(c0, c1)`` ints for Fp2, a 6-tuple of Fp2 for
Fp12 — and every function takes the :class:`Tower` (modulus + xi +
precomputed Frobenius constants) as the first argument.
"""

from __future__ import annotations

from dataclasses import dataclass, field

Fp2 = tuple  # (c0, c1) ints mod p
Fp12 = tuple  # 6-tuple of Fp2

F2_ZERO = (0, 0)
F2_ONE = (1, 0)
F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5
F12_ZERO = (F2_ZERO,) * 6


@dataclass(frozen=True)
class Tower:
    """Modulus + xi defining Fp12 = Fp2[w]/(w^6 - xi), u^2 = -1."""

    p: int
    xi: Fp2  # nonresidue of Fp2 (9+u for BN254, 1+u for BLS12-381)
    # gamma[k][i] = xi^(i*(p^k-1)/6) for the k-th Frobenius power, i in 1..5
    _frob: dict = field(default_factory=dict, compare=False, hash=False)

    # -- Fp2 ---------------------------------------------------------------
    def f2_add(self, a: Fp2, b: Fp2) -> Fp2:
        p = self.p
        return ((a[0] + b[0]) % p, (a[1] + b[1]) % p)

    def f2_sub(self, a: Fp2, b: Fp2) -> Fp2:
        p = self.p
        return ((a[0] - b[0]) % p, (a[1] - b[1]) % p)

    def f2_neg(self, a: Fp2) -> Fp2:
        p = self.p
        return ((-a[0]) % p, (-a[1]) % p)

    def f2_mul(self, a: Fp2, b: Fp2) -> Fp2:
        # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
        p = self.p
        return ((a[0] * b[0] - a[1] * b[1]) % p,
                (a[0] * b[1] + a[1] * b[0]) % p)

    def f2_sq(self, a: Fp2) -> Fp2:
        p = self.p
        return ((a[0] - a[1]) * (a[0] + a[1]) % p, 2 * a[0] * a[1] % p)

    def f2_smul(self, a: Fp2, k: int) -> Fp2:
        p = self.p
        return (a[0] * k % p, a[1] * k % p)

    def f2_conj(self, a: Fp2) -> Fp2:
        return (a[0], (-a[1]) % self.p)

    def f2_inv(self, a: Fp2) -> Fp2:
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        p = self.p
        norm = (a[0] * a[0] + a[1] * a[1]) % p
        ninv = pow(norm, -1, p)
        return (a[0] * ninv % p, (-a[1]) * ninv % p)

    def f2_pow(self, a: Fp2, e: int) -> Fp2:
        acc = F2_ONE
        while e:
            if e & 1:
                acc = self.f2_mul(acc, a)
            a = self.f2_sq(a)
            e >>= 1
        return acc

    def f2_embed(self, x: int) -> Fp2:
        return (x % self.p, 0)

    # -- Fp12 --------------------------------------------------------------
    def f12_add(self, a: Fp12, b: Fp12) -> Fp12:
        return tuple(self.f2_add(x, y) for x, y in zip(a, b))

    def f12_conj(self, a: Fp12) -> Fp12:
        """Conjugation w -> -w (the p^6 Frobenius on the cyclotomic part)."""
        neg = self.f2_neg
        return (a[0], neg(a[1]), a[2], neg(a[3]), a[4], neg(a[5]))

    def f12_mul(self, a: Fp12, b: Fp12) -> Fp12:
        """Schoolbook over w with w^6 = xi (reference fp12.rs `mul`)."""
        f2_mul, f2_add = self.f2_mul, self.f2_add
        out = []
        for i in range(6):
            lo = F2_ZERO
            for j in range(i + 1):
                lo = f2_add(lo, f2_mul(a[j], b[i - j]))
            hi = F2_ZERO
            for j in range(i + 1, 6):
                hi = f2_add(hi, f2_mul(a[j], b[6 + i - j]))
            out.append(f2_add(lo, f2_mul(hi, self.xi)))
        return tuple(out)

    def f12_sq(self, a: Fp12) -> Fp12:
        return self.f12_mul(a, a)

    def f12_pow(self, a: Fp12, e: int) -> Fp12:
        if e < 0:
            a, e = self.f12_inv(a), -e
        acc = F12_ONE
        while e:
            if e & 1:
                acc = self.f12_mul(acc, a)
            a = self.f12_mul(a, a)
            e >>= 1
        return acc

    def f12_inv(self, a: Fp12) -> Fp12:
        """Inverse via the tower norm: reduce to an Fp2 inversion.

        N(a) = prod of a's conjugates under Gal(Fp12/Fp2); compute
        a^(p^6) * a^(p^2 ...): use a simpler route — solve with the
        (w^6 - xi) structure by computing the inverse of the 6x6
        coefficient matrix action.  We use the standard trick:
        a^-1 = a_conj_prod / N where N in Fp2 is the resultant.  For
        simplicity and testability we use linear algebra over Fp2: invert
        the multiplication-by-a matrix applied to (1,0,...,0).
        """
        # multiplication-by-a matrix M[i][j]: coefficient i of a * w^j
        # a * w^j has coefficients: (a << j) with wraparound * xi
        p = self.p
        f2_mul = self.f2_mul
        cols = []
        for j in range(6):
            col = [F2_ZERO] * 6
            for k in range(6):
                i = k + j
                if i < 6:
                    col[i] = a[k]
                else:
                    col[i - 6] = f2_mul(a[k], self.xi)
            cols.append(col)
        # solve M x = e0 by Gaussian elimination over Fp2
        m = [[cols[j][i] for j in range(6)] for i in range(6)]
        rhs = [F2_ONE] + [F2_ZERO] * 5
        for c in range(6):
            piv = next(r for r in range(c, 6) if m[r][c] != (0, 0))
            m[c], m[piv] = m[piv], m[c]
            rhs[c], rhs[piv] = rhs[piv], rhs[c]
            inv = self.f2_inv(m[c][c])
            m[c] = [f2_mul(x, inv) for x in m[c]]
            rhs[c] = f2_mul(rhs[c], inv)
            for r in range(6):
                if r != c and m[r][c] != (0, 0):
                    factor = m[r][c]
                    m[r] = [self.f2_sub(x, f2_mul(factor, y))
                            for x, y in zip(m[r], m[c])]
                    rhs[r] = self.f2_sub(rhs[r], f2_mul(factor, rhs[c]))
        return tuple(rhs)

    # -- Frobenius ---------------------------------------------------------
    def _frob_gammas(self, k: int):
        """gamma_i = xi^(i*(p^k-1)/6), i in 0..5, for the p^k Frobenius."""
        if k not in self._frob:
            e = (self.p ** k - 1) // 6
            g1 = self.f2_pow(self.xi, e)
            gs = [F2_ONE]
            for _ in range(5):
                gs.append(self.f2_mul(gs[-1], g1))
            self._frob[k] = tuple(gs)
        return self._frob[k]

    def f12_frobenius(self, a: Fp12, k: int = 1) -> Fp12:
        """a^(p^k): conjugate each Fp2 coeff k times, scale by gammas."""
        gammas = self._frob_gammas(k)
        out = []
        for i in range(6):
            c = a[i] if k % 2 == 0 else self.f2_conj(a[i])
            out.append(self.f2_mul(c, gammas[i]))
        return tuple(out)

    # -- serialization (guest memory layout: LE bytes per Fp, c0 first) ----
    def f12_to_bytes(self, a: Fp12, num_limbs: int) -> bytes:
        out = b""
        for c in a:
            out += int(c[0]).to_bytes(num_limbs, "little")
            out += int(c[1]).to_bytes(num_limbs, "little")
        return out

    def f12_from_bytes(self, data: bytes, num_limbs: int) -> Fp12:
        coeffs = []
        for i in range(6):
            off = i * 2 * num_limbs
            c0 = int.from_bytes(data[off:off + num_limbs], "little")
            c1 = int.from_bytes(data[off + num_limbs:off + 2 * num_limbs],
                                "little")
            coeffs.append((c0 % self.p, c1 % self.p))
        return tuple(coeffs)
