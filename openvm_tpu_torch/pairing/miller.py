"""Multi-Miller loop with optional embedded exponent.

Copy of openvm_tpu/pairing/miller.py (the whole module: the steps
:18-58, ``evaluate_line`` :61, ``mul_lines`` :82, ``g2_frobenius`` :117,
``multi_miller_loop`` :130-218).  Its body after the G1 fractions is
``miller_loop_fracs``, so that a caller may give (x/y, 1/y) itself, as the
pairing guest of ``vm.guest`` computes them with the modular chips.

Host-side pairing execution mirroring the reference pairing guest lib
(`extensions/pairing/guest/src/pairing/miller_loop.rs` and the
halo2curves shims `halo2curves_shims/{bn254,bls12_381}/miller_loop.rs`).
Used by the VM's HintFinalExp phantom and by the pairing tests.

Points are affine tuples over Fp2: ``((x0, x1), (y0, y1))``; G1 points are
``(x, y)`` ints.  The point at infinity is ``None``.
"""

from __future__ import annotations

from .curve import PairingCurveParams
from .tower import F2_ONE, F2_ZERO, F12_ONE


def miller_double_step(cv: PairingCurveParams, s):
    """2S and the tangent line (b, c) = (-lambda, lambda*x_s - y_s)."""
    t = cv.tower
    x, y = s
    # lambda = 3x^2 / 2y
    lam = t.f2_mul(t.f2_smul(t.f2_sq(x), 3),
                   t.f2_inv(t.f2_smul(y, 2)))
    x2 = t.f2_sub(t.f2_sq(lam), t.f2_smul(x, 2))
    y2 = t.f2_sub(t.f2_mul(lam, t.f2_sub(x, x2)), y)
    line = (t.f2_neg(lam), t.f2_sub(t.f2_mul(lam, x), y))
    return (x2, y2), line


def miller_add_step(cv: PairingCurveParams, s, q):
    """S+Q and the chord line through S and Q."""
    t = cv.tower
    xs, ys = s
    xq, yq = q
    lam = t.f2_mul(t.f2_sub(ys, yq), t.f2_inv(t.f2_sub(xs, xq)))
    xr = t.f2_sub(t.f2_sub(t.f2_sq(lam), xs), xq)
    yr = t.f2_sub(t.f2_mul(lam, t.f2_sub(xq, xr)), yq)
    line = (t.f2_neg(lam), t.f2_sub(t.f2_mul(lam, xs), ys))
    return (xr, yr), line


def miller_double_and_add_step(cv: PairingCurveParams, s, q):
    """2S+Q as (S+Q)+S, returning both chord lines (reference
    miller_double_and_add_step)."""
    t = cv.tower
    xs, ys = s
    xq, yq = q
    lam1 = t.f2_mul(t.f2_sub(ys, yq), t.f2_inv(t.f2_sub(xs, xq)))
    x_sq = t.f2_sub(t.f2_sub(t.f2_sq(lam1), xs), xq)
    lam2 = t.f2_sub(t.f2_neg(lam1),
                    t.f2_mul(t.f2_smul(ys, 2),
                             t.f2_inv(t.f2_sub(x_sq, xs))))
    xr = t.f2_sub(t.f2_sub(t.f2_sq(lam2), xs), x_sq)
    yr = t.f2_sub(t.f2_mul(lam2, t.f2_sub(xs, xr)), ys)
    l1 = (t.f2_neg(lam1), t.f2_sub(t.f2_mul(lam1, xs), ys))
    l2 = (t.f2_neg(lam2), t.f2_sub(t.f2_mul(lam2, xs), ys))
    return (xr, yr), l1, l2


def evaluate_line(cv: PairingCurveParams, line, xy_frac):
    """Scale the unevaluated line by P's (x/y, 1/y) (reference Evaluatable)."""
    t = cv.tower
    b, c = line
    x_over_y, y_inv = xy_frac
    return (t.f2_mul(b, t.f2_embed(x_over_y)),
            t.f2_mul(c, t.f2_embed(y_inv)))


def line_to_f12(cv: PairingCurveParams, line):
    """Embed an evaluated line into Fp12.

    D-type (BN254): 1 + b w + c w^3 (FromLineDType).
    M-type (BLS12-381): c + b w^2 + w^3 (FromLineMType).
    """
    b, c = line
    if cv.line_type == "D":
        return (F2_ONE, b, F2_ZERO, c, F2_ZERO, F2_ZERO)
    return (c, F2_ZERO, b, F2_ONE, F2_ZERO, F2_ZERO)


def mul_lines(cv: PairingCurveParams, l0, l1):
    """Product of two evaluated lines as a sparse 5-coefficient element
    (reference mul_013_by_013 / mul_023_by_023); returned as full Fp12."""
    t = cv.tower
    b0, c0 = l0
    b1, c1 = l1
    if cv.line_type == "D":
        # (1 + b0 w + c0 w^3)(1 + b1 w + c1 w^3), w^6 = xi
        x0 = t.f2_add(F2_ONE, t.f2_mul(t.f2_mul(c0, c1), cv.xi))
        x1 = t.f2_add(b0, b1)
        x2 = t.f2_mul(b0, b1)
        x3 = t.f2_add(c0, c1)
        x4 = t.f2_add(t.f2_mul(b0, c1), t.f2_mul(b1, c0))
        return (x0, x1, x2, x3, x4, F2_ZERO)
    # (c0 + b0 w^2 + w^3)(c1 + b1 w^2 + w^3)
    x0 = t.f2_add(t.f2_mul(c0, c1), cv.xi)
    x2 = t.f2_add(t.f2_mul(c0, b1), t.f2_mul(c1, b0))
    x3 = t.f2_add(c0, c1)
    x4 = t.f2_mul(b0, b1)
    x5 = t.f2_add(b0, b1)
    return (x0, F2_ZERO, x2, x3, x4, x5)


def evaluate_lines_vec(cv: PairingCurveParams, f, lines):
    """Fold evaluated lines into f, pairing them up (reference
    evaluate_lines_vec: mul lines two at a time, then into f)."""
    t = cv.tower
    lines = list(lines)
    if len(lines) % 2 == 1:
        f = t.f12_mul(f, line_to_f12(cv, lines.pop()))
    for i in range(0, len(lines), 2):
        f = t.f12_mul(f, mul_lines(cv, lines[i], lines[i + 1]))
    return f


def g2_frobenius(cv: PairingCurveParams, q, power: int):
    """The twist Frobenius endomorphism psi^power on E'(Fp2) (reference
    post_loop q1/q2 computation, bn254/miller_loop.rs:210-247)."""
    t = cv.tower
    x, y = q
    if power == 1:
        return (t.f2_mul(t.f2_conj(x), cv.frob_g2_x),
                t.f2_mul(t.f2_conj(y), cv.frob_g2_y))
    if power == 2:
        return (t.f2_mul(x, cv.frob_g2_x_sq), y)
    raise ValueError(power)


def multi_miller_loop(cv: PairingCurveParams, ps, qs, c=None):
    """f_{Miller}(P, Q) with optional embedded exponent c (reference
    multi_miller_loop_embedded_exp, pairing/miller_loop.rs:64-180).

    With ``c`` given, multiplies c^digit into f at each nonzero loop digit,
    computing f * c^{6x+2} (BN254) / the conjugate trick (BLS12-381) without
    a separate exponentiation.
    """
    ps, qs = finite_pairs(ps, qs)
    return miller_loop_fracs(cv, g1_fracs(cv, ps), qs, c)


def finite_pairs(ps, qs):
    """The pairs with neither point at infinity, as (ps, qs)."""
    pairs = [(p, q) for p, q in zip(ps, qs, strict=True)
             if p is not None and q is not None]
    if not pairs:
        raise ValueError("all pairs at infinity")
    return [p for p, _ in pairs], [q for _, q in pairs]


def g1_fracs(cv: PairingCurveParams, ps):
    """(x/y, 1/y) of each affine G1 point."""
    return [(x * pow(y, -1, cv.p) % cv.p, pow(y, -1, cv.p)) for x, y in ps]


def miller_loop_fracs(cv: PairingCurveParams, xy_fracs, qs, c=None):
    """``multi_miller_loop`` from each P's (x/y, 1/y)."""
    t = cv.tower
    c_inv = t.f12_inv(c) if c is not None else F12_ONE

    q_acc = list(qs)
    enc = cv.pseudo_binary_encoding

    # pre-loop (reference pre_loop): consume the top digit(s)
    if cv.line_type == "D":
        f = t.f12_mul(c, c) if c is not None else F12_ONE
        lines = []
        q_acc, ls = zip(*[miller_double_step(cv, q) for q in q_acc])
        q_acc = list(q_acc)
        lines += [evaluate_line(cv, l, xy) for l, xy in zip(ls, xy_fracs)]
        f = evaluate_lines_vec(cv, f, lines)
    else:
        # BLS12-381: top two digits are 1,1 -> double and add, f = c^3
        if c is not None:
            c2 = t.f12_mul(c, c)
            f = t.f12_mul(c2, c)
        else:
            f = F12_ONE
        lines = []
        q_acc, ls = zip(*[miller_double_step(cv, q) for q in q_acc])
        q_acc = list(q_acc)
        lines += [evaluate_line(cv, l, xy) for l, xy in zip(ls, xy_fracs)]
        out = [miller_add_step(cv, s, q) for s, q in zip(q_acc, qs)]
        q_acc = [o[0] for o in out]
        lines += [evaluate_line(cv, o[1], xy)
                  for o, xy in zip(out, xy_fracs)]
        f = evaluate_lines_vec(cv, f, lines)

    # reference: `for i in (0..len-2).rev()` — the top two digits are
    # consumed by the pre-loop
    for i in range(len(enc) - 3, -1, -1):
        f = t.f12_mul(f, f)
        lines = []
        if enc[i] == 0:
            out = [miller_double_step(cv, s) for s in q_acc]
            q_acc = [o[0] for o in out]
            lines += [evaluate_line(cv, o[1], xy)
                      for o, xy in zip(out, xy_fracs)]
        else:
            if c is not None:
                f = t.f12_mul(f, c if enc[i] == 1 else c_inv)
            q_signed = [q if enc[i] == 1 else (q[0], t.f2_neg(q[1]))
                        for q in qs]
            out = [miller_double_and_add_step(cv, s, q)
                   for s, q in zip(q_acc, q_signed)]
            q_acc = [o[0] for o in out]
            for o, xy in zip(out, xy_fracs):
                lines.append(evaluate_line(cv, o[1], xy))
                lines.append(evaluate_line(cv, o[2], xy))
        f = evaluate_lines_vec(cv, f, lines)

    # post-loop
    if cv.line_type == "D":
        # BN254: two extra Frobenius add steps with q1 = psi(Q), q2 = psi^2(Q)
        lines = []
        q1s = [g2_frobenius(cv, q, 1) for q in qs]
        out = [miller_add_step(cv, s, q1) for s, q1 in zip(q_acc, q1s)]
        q_acc = [o[0] for o in out]
        lines += [evaluate_line(cv, o[1], xy)
                  for o, xy in zip(out, xy_fracs)]
        q2s = [g2_frobenius(cv, q, 2) for q in qs]
        out = [miller_add_step(cv, s, q2) for s, q2 in zip(q_acc, q2s)]
        q_acc = [o[0] for o in out]
        lines += [evaluate_line(cv, o[1], xy)
                  for o, xy in zip(out, xy_fracs)]
        f = evaluate_lines_vec(cv, f, lines)
    else:
        # BLS12-381: seed is negative — conjugate instead of inverting
        f = t.f12_conj(f)
    return f
