"""Batched host extension-field arithmetic (numpy, canonical uint64).

Copy of openvm_tpu/stark/npext.py:1-132, for the host verifier: the
quartic-binomial arithmetic of field/ext.py (F_p[x]/(x^4 - 11) over
BabyBear) vectorised over a leading query axis; arrays are (..., 4) uint64
canonical, all values < P.

Overflow note: products of canonical values are < (P-1)^2 ~ 2^62; sums of
up to 4 such products stay < 2^64, so schoolbook ext multiplication
accumulates raw u64 then reduces once.
"""

from __future__ import annotations

import numpy as np

P = 2013265921
EXT_W = 11


def nadd(a, b):
    return (np.asarray(a, dtype=np.uint64) + np.asarray(b, dtype=np.uint64)) % P


def nsub(a, b):
    return (np.asarray(a, dtype=np.uint64) + P
            - np.asarray(b, dtype=np.uint64) % P) % P


def nmul(a, b):
    """Ext mul: a, b (..., 4) canonical uint64 -> (..., 4)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    a0, a1, a2, a3 = (a[..., i] for i in range(4))
    b0, b1, b2, b3 = (b[..., i] for i in range(4))
    d0 = a0 * b0
    d1 = a0 * b1 + a1 * b0
    d2 = a0 * b2 + a1 * b1 + a2 * b0
    d3 = a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0
    d4 = a1 * b3 + a2 * b2 + a3 * b1
    d5 = a2 * b3 + a3 * b2
    d6 = a3 * b3
    e0 = (d0 % P + EXT_W * (d4 % P)) % P
    e1 = (d1 % P + EXT_W * (d5 % P)) % P
    e2 = (d2 % P + EXT_W * (d6 % P)) % P
    e3 = d3 % P
    return np.stack([e0, e1, e2, e3], axis=-1)


def nmul_base(a, s):
    """Ext (..., 4) times base (...,) or scalar."""
    a = np.asarray(a, dtype=np.uint64)
    s = np.asarray(s, dtype=np.uint64) % P
    return (a * s[..., None]) % P


def from_base(x, like_shape=None):
    """Base (...,) -> ext (..., 4) with zero high coefficients."""
    x = np.asarray(x, dtype=np.uint64) % P
    out = np.zeros(x.shape + (4,), dtype=np.uint64)
    out[..., 0] = x
    return out


def npow_base(x, e: int):
    """Batched base-field power with a fixed integer exponent."""
    x = np.asarray(x, dtype=np.uint64) % P
    r = np.ones_like(x)
    while e:
        if e & 1:
            r = (r * x) % P
        x = (x * x) % P
        e >>= 1
    return r


def ninv_base(x):
    return npow_base(x, P - 2)


def npow_base_varexp(g: int, e):
    """g^e[i] for a scalar base g and per-element exponents e (...,)."""
    e = np.asarray(e, dtype=np.uint64)
    r = np.ones(e.shape, dtype=np.uint64)
    b = np.uint64(g % P)
    max_e = int(e.max()) if e.size else 0
    bit = 0
    while (1 << bit) <= max_e:
        mask = (e >> np.uint64(bit)) & np.uint64(1)
        r = np.where(mask == 1, (r * b) % P, r)
        b = (b * b) % P
        bit += 1
    return r


_FROB_SCALE = None


def _frob_scales():
    global _FROB_SCALE
    if _FROB_SCALE is None:
        scales = []
        for k in range(4):
            s = pow(EXT_W, (P - 1) // 4 * k, P)
            scales.append(np.asarray([pow(s, i, P) for i in range(4)],
                                     dtype=np.uint64))
        _FROB_SCALE = scales
    return _FROB_SCALE


def ninv(a):
    """Batched ext inverse via Frobenius/norm (same algebra as hinv)."""
    a = np.asarray(a, dtype=np.uint64) % P
    scales = _frob_scales()
    f1 = (a * scales[1]) % P
    f2 = (a * scales[2]) % P
    f3 = (a * scales[3]) % P
    g = nmul(f1, nmul(f2, f3))
    norm = nmul(a, g)[..., 0]
    return (g * ninv_base(norm)[..., None]) % P


def rev_bits_arr(x, bits: int):
    """Bit-reverse each element of x (...,) within `bits` bits."""
    x = np.asarray(x, dtype=np.uint64)
    r = np.zeros_like(x)
    for _ in range(bits):
        r = (r << np.uint64(1)) | (x & np.uint64(1))
        x = x >> np.uint64(1)
    return r
