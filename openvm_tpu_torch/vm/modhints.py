"""Modular-arithmetic hint helpers: non-QR and square-root hints.

Copy of openvm_tpu/vm/modhints.py (the whole module).

Host-side analogs of the reference's `NonQrHintSubEx` / `SqrtHintSubEx`
phantom sub-executors (reference extensions/algebra/circuit/src/extension/
modular.rs:500-698): the guest asks for a square root (curve-point
decompression in k256/p256) or a quadratic non-residue via phantom
instructions, receives the value through the hint stream, and verifies it
in-circuit (sqrt^2 == x, resp. the non-QR property) — so the hint values
need only satisfy the property, not match the reference bit-for-bit.

Deviation note: for moduli with p % 8 not in {3 mod 4, 5 mod 8} the
reference samples a random non-QR from StdRng seeded with zeros
(modular.rs:590-600); replicating Rust's StdRng in Python is not
meaningful, so this host picks the SMALLEST non-QR instead.  Guests
verify the property in-circuit, so any non-QR is sound.  secp256k1 /
p256 / BN254 / BLS12-381 base fields are all 3 mod 4 and hit the
deterministic branch, matching the reference exactly (p - 1).
"""

from __future__ import annotations

import functools


def num_limbs(modulus: int) -> int:
    """Reference limb sizing: 32 bytes for <=256-bit, else 48."""
    nbytes = (modulus.bit_length() + 7) // 8
    if nbytes <= 32:
        return 32
    if nbytes <= 48:
        return 48
    raise ValueError("modulus too large")


@functools.lru_cache(maxsize=None)
def find_non_qr(modulus: int) -> int:
    """A quadratic non-residue mod `modulus` (reference find_non_qr,
    modular.rs:699-725; deterministic branches identical)."""
    if modulus % 4 == 3:
        return modulus - 1
    if modulus % 8 == 5:
        return 2
    exp = (modulus - 1) >> 1
    z = 2
    while pow(z, exp, modulus) != modulus - 1:
        z += 1
    return z


def mod_sqrt(x: int, modulus: int) -> int | None:
    """Square root of x mod modulus, or None if x is a non-residue
    (reference mod_sqrt, modular.rs:645-697: p=3 mod 4 shortcut, else
    Tonelli-Shanks)."""
    x %= modulus
    if modulus % 4 == 3:
        r = pow(x, (modulus + 1) >> 2, modulus)
        return r if r * r % modulus == x else None
    # Tonelli-Shanks
    if x == 0:
        return 0
    if pow(x, (modulus - 1) >> 1, modulus) != 1:
        return None
    q, s = modulus - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = find_non_qr(modulus)
    m, c = s, pow(z, q, modulus)
    t, r = pow(x, q, modulus), pow(x, (q + 1) >> 1, modulus)
    while t != 1:
        i, tmp = 0, t
        while tmp != 1 and i < m:
            tmp = tmp * tmp % modulus
            i += 1
        if i == m:
            return None
        b = pow(c, 1 << (m - i - 1), modulus)
        m, c = i, b * b % modulus
        t = t * c % modulus
        r = r * b % modulus
    return r


def sqrt_hint(x: int, modulus: int) -> tuple[bool, int]:
    """(success, sqrt): sqrt of x if it is a QR, else sqrt of x*non_qr
    (reference SqrtHintSubEx, modular.rs:540-570)."""
    r = mod_sqrt(x, modulus)
    if r is not None:
        return True, r
    r = mod_sqrt(x * find_non_qr(modulus) % modulus, modulus)
    assert r is not None, "either x or x*non_qr must be a square"
    return False, r


def non_qr_hint_bytes(modulus: int) -> list[int]:
    """Hint-stream payload for HintNonQr: non_qr LE bytes, limb-padded."""
    n = num_limbs(modulus)
    return list(find_non_qr(modulus).to_bytes(n, "little"))


def sqrt_hint_bytes(x: int, modulus: int) -> list[int]:
    """Hint-stream payload for HintSqrt: [success, 0, 0, 0] + sqrt LE
    bytes, limb-padded (modular.rs:562-575)."""
    ok, r = sqrt_hint(x, modulus)
    n = num_limbs(modulus)
    return [1 if ok else 0, 0, 0, 0] + list(r.to_bytes(n, "little"))
