"""Final exponentiation hints + pairing check (Novakovic–Eagen residue
witness, eprint 2024/640).

Copy of openvm_tpu/pairing/final_exp.py (the whole module: the derived
exponents :36-82, ``final_exp_hint`` :89, ``assert_final_exp_is_one``
:185, ``pairing_check`` :205, ``hint_final_exp_bytes`` :211-241).  The
residue check after the hint is ``final_exp_product``, which returns the
product that is one exactly when the check holds: the pairing guest of
``vm.guest`` runs it over its hinted (c, u).

Mirrors the reference `halo2curves_shims/{bn254,bls12_381}/final_exp.rs`
(gnark-derived).  The hint exponents are *derived* from (p, r, seed) with
their defining relations instead of vendoring the reference's decimal
strings:

BN254 (final_exp.rs:33-141):
  exp1  = (p^12 - 1) / 3
  p^12 - 1 = 3^3 * s with 3 !| s;  exp2 = (s + 1) / 3
  r_inv = r^-1 mod (p^12 - 1)/r
  m     = (6x + 2 + p^3 - p^2 + p) / (3r);  m_inv = m^-1 mod p^12 - 1
  w27   = a 27th root of unity of exact order 27 (any works: the checker
          uses the same w27 the hinter produced)

BLS12-381 (final_exp.rs:52-115, gnark hints.go):
  poly_factor      = (1 - x)/3
  final_exp_factor = ((p^12 - 1) / r) / (27 * poly_factor)
  lambda           = p - x
"""

from __future__ import annotations

import functools

from .curve import BLS12_381, BN254, PairingCurveParams
from .miller import finite_pairs, g1_fracs, miller_loop_fracs, multi_miller_loop
from .tower import F12_ONE


# ---------------------------------------------------------------------------
# derived exponents
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bn254_exponents():
    p, r, x = BN254.p, BN254.r, BN254.seed
    h = p ** 12 - 1
    exp1 = h // 3
    s = h
    n = 0
    while s % 3 == 0:
        s //= 3
        n += 1
    assert n == 3, n
    exp2 = (s + 1) // 3
    r_inv = pow(r, -1, h // r)
    lam = 6 * x + 2 + p ** 3 - p ** 2 + p
    assert lam % (3 * r) == 0
    m = lam // (3 * r)
    m_inv = pow(m, -1, h)
    return exp1, exp2, r_inv, m_inv


@functools.lru_cache(maxsize=None)
def _unity_root_27():
    """A deterministic element of exact multiplicative order 27 in BN254
    Fp12 (counterpart of the reference's UNITY_ROOT_27, final_exp.rs:12-28;
    any order-27 element works since hinter and checker share it)."""
    t = BN254.tower
    h = BN254.p ** 12 - 1
    k = 0
    while True:
        k += 1
        g = ((k, 1), (1, 0), (0, 0), (0, 0), (0, 0), (0, 0))
        z = t.f12_pow(g, h // 27)
        if t.f12_pow(z, 9) != F12_ONE:
            return z


@functools.lru_cache(maxsize=None)
def _bls12_381_exponents():
    p, r, x = BLS12_381.p, BLS12_381.r, BLS12_381.seed
    h = p ** 12 - 1
    poly_factor = (1 - x) // 3
    assert (1 - x) % 3 == 0
    cofactor = h // r
    assert cofactor % (27 * poly_factor) == 0
    final_exp_factor = cofactor // (27 * poly_factor)
    lam = p - x
    return poly_factor, final_exp_factor, lam


# ---------------------------------------------------------------------------
# hints
# ---------------------------------------------------------------------------

def final_exp_hint(cv: PairingCurveParams, f):
    """(residue witness c, scaling factor u/s) for the pairing check."""
    if cv.name == "Bn254":
        return _bn254_hint(f)
    if cv.name == "Bls12_381":
        return _bls12_381_hint(f)
    raise ValueError(cv.name)


def _bn254_hint(f):
    t = BN254.tower
    exp1, exp2, r_inv, m_inv = _bn254_exponents()
    w27 = _unity_root_27()

    # pick u in {1, w27, w27^2} making f*u a cubic residue
    if t.f12_pow(f, exp1) == F12_ONE:
        c, u = f, F12_ONE
    else:
        f1 = t.f12_mul(f, w27)
        if t.f12_pow(f1, exp1) == F12_ONE:
            c, u = f1, w27
        else:
            c, u = t.f12_mul(f1, w27), t.f12_mul(w27, w27)

    c = t.f12_pow(c, r_inv)   # r-th root
    c = t.f12_pow(c, m_inv)   # m-th root

    # cube root via modified Tonelli–Shanks (Alg. 4, eprint 2024/640)
    x = t.f12_pow(c, exp2)
    c_inv = t.f12_inv(c)
    w27_exp2 = t.f12_pow(w27, exp2)

    # 3^t = ord(x^3 / c): repeated cubing until 1 (reference
    # tonelli_shanks_loop, final_exp.rs:115-123)
    def order_pow3(x3):
        tt = 0
        while x3 != F12_ONE:
            x3 = t.f12_mul(t.f12_mul(x3, x3), x3)
            tt += 1
        return tt

    x3 = t.f12_mul(t.f12_mul(t.f12_mul(x, x), x), c_inv)
    tt = order_pow3(x3)
    while tt != 0:
        x = t.f12_mul(x, w27_exp2)
        x3 = t.f12_mul(t.f12_mul(t.f12_mul(x, x), x), c_inv)
        tt = order_pow3(x3)

    assert t.f12_mul(t.f12_mul(x, x), x) == c
    return x, u


def _bls12_381_hint(f):
    t = BLS12_381.tower
    poly_factor, final_exp_factor, lam = _bls12_381_exponents()

    # 1. p-th root inverse
    exp = final_exp_factor * 27
    root = t.f12_pow(f, exp)
    if root == F12_ONE:
        root_pth_inv = F12_ONE
    else:
        exp_inv = pow(exp, -1, poly_factor)
        root_pth_inv = t.f12_inv(t.f12_pow(root, exp_inv % poly_factor))

    # 2. 27th root inverse.  The reference scans root^(3^k) for k=1..3 and
    # keeps the LAST match, so order_3rd_power is 3 whenever root is
    # 27-torsion and 0 otherwise (final_exp.rs:66-100) — using exponent 27
    # is valid for any order dividing 27.
    exp = poly_factor * final_exp_factor
    root = t.f12_pow(f, exp)
    order_3rd_power = 0
    r3 = root
    for k in (1, 2, 3):
        r3 = t.f12_pow(r3, 3)
        if r3 == F12_ONE:
            order_3rd_power = k
    if order_3rd_power == 0:
        root_27th_inv = F12_ONE
    else:
        order_3rd = 3 ** order_3rd_power
        exp_inv = pow(exp, -1, order_3rd)
        root_27th_inv = t.f12_inv(t.f12_pow(root, exp_inv % order_3rd))

    # 3. shift f into the order-final_exp_factor subgroup; extract witness
    s = t.f12_mul(root_pth_inv, root_27th_inv)
    f_shift = t.f12_mul(f, s)
    exp = pow(lam, -1, final_exp_factor)
    c = t.f12_pow(f_shift, exp)
    return c, s


# ---------------------------------------------------------------------------
# pairing check
# ---------------------------------------------------------------------------

def assert_final_exp_is_one(cv: PairingCurveParams, f, ps, qs):
    """Check f^((p^12-1)/r) == 1 via the residue witness, re-running the
    Miller loop with the embedded exponent (reference
    assert_final_exp_is_one, bn254/final_exp.rs:37-63)."""
    c, u = final_exp_hint(cv, f)
    ps, qs = finite_pairs(ps, qs)
    return final_exp_product(cv, c, u, g1_fracs(cv, ps), qs) == F12_ONE


def final_exp_product(cv: PairingCurveParams, c, u, xy_fracs, qs):
    """The residue check's product from the hint (c, u): the Miller loop
    with c^-1 embedded, times the Frobenius terms of c, times u; one
    exactly when the check holds."""
    t = cv.tower
    c_inv = t.f12_inv(c)
    if cv.name == "Bn254":
        c_mul = t.f12_mul(
            t.f12_mul(t.f12_frobenius(c_inv, 3), t.f12_frobenius(c, 2)),
            t.f12_frobenius(c_inv, 1))
        fc = miller_loop_fracs(cv, xy_fracs, qs, c=c_inv)
        return t.f12_mul(t.f12_mul(fc, c_mul), u)
    # BLS12-381: f * c^x * c^-q * s == 1 via conjugate-inverse embedding
    c_conj_inv = t.f12_inv(t.f12_conj(c))
    c_q_inv = t.f12_frobenius(c_inv, 1)
    fc = miller_loop_fracs(cv, xy_fracs, qs, c=c_conj_inv)
    return t.f12_mul(t.f12_mul(fc, c_q_inv), u)


def pairing_check(cv: PairingCurveParams, ps, qs) -> bool:
    """True iff prod_i e(P_i, Q_i) == 1 (reference PairingCheck trait)."""
    f = multi_miller_loop(cv, ps, qs)
    return assert_final_exp_is_one(cv, f, ps, qs)


def hint_final_exp_bytes(curve_idx: int, rd_bytes, rs1: int, rs2: int
                         ) -> bytes:
    """Shared HintFinalExp phantom body (reference hint_pairing,
    pairing_extension.rs:151-210): ``rd_bytes(ptr, n)`` reads guest AS2
    memory.  [rs1] -> (p_ptr, p_len), [rs2] -> (q_ptr, q_len); returns the
    new hint stream = (c, u) as LE limb bytes."""
    from .curve import CURVES

    cv = CURVES[curve_idx]
    n = cv.num_limbs

    def rd_u32(ptr):
        return int.from_bytes(rd_bytes(ptr, 4), "little")

    def rd_fp(ptr):
        return int.from_bytes(rd_bytes(ptr, n), "little") % cv.p

    p_ptr, p_len = rd_u32(rs1), rd_u32(rs1 + 4)
    q_ptr, q_len = rd_u32(rs2), rd_u32(rs2 + 4)
    if p_len != q_len:
        raise ValueError(f"hint_pairing: p_len={p_len} != q_len={q_len}")
    ps = [(rd_fp(p_ptr + i * 2 * n), rd_fp(p_ptr + i * 2 * n + n))
          for i in range(p_len)]
    qs = [((rd_fp(q_ptr + i * 4 * n), rd_fp(q_ptr + i * 4 * n + n)),
           (rd_fp(q_ptr + i * 4 * n + 2 * n),
            rd_fp(q_ptr + i * 4 * n + 3 * n)))
          for i in range(q_len)]
    f = multi_miller_loop(cv, ps, qs)
    c, u = final_exp_hint(cv, f)
    t = cv.tower
    return t.f12_to_bytes(c, n) + t.f12_to_bytes(u, n)
