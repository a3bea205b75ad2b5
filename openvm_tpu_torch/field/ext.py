"""Quartic binomial extension F_p[x]/(x^4 - 11) over BabyBear.

Port of openvm_tpu/field/ext.py.  Elements are ``torch.int32`` Montgomery
words whose trailing axis has length 4 (coefficients a0 + a1 x + a2 x^2 +
a3 x^3), the JAX package's layout.

Two versions:
  * ``*64`` helpers and ``*_plain``: plain PyTorch in int64, any device.
  * ``mul``/``add``/``sub``/``scale``/``inv``: kernel K2 (csrc/ext.cu) on
    CUDA tensors, the plain version on CPU tensors.  ``neg``, ``exp_u64``,
    ``sum_mod``, ``dot`` and ``powers`` are built from those.
``ext.inv(0)`` is 0, like ``bb.inv(0)``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import resolve_device
from . import babybear as bb

D = 4
W = 11  # x^4 - 11 is irreducible over BabyBear
P = bb.P
W_MONTY = bb.to_monty_int(W)
_FROB_BASE = pow(W, (P - 1) // 4, P)


def frob_consts(k: int) -> list:
    """Montgomery words W^(i*k*(p-1)/4), i < 4: a^(p^k) scales coefficient
    i by the i-th (ext.py:28-32)."""
    s = pow(_FROB_BASE, k % 4, P)
    return [bb.to_monty_int(pow(s, i, P)) for i in range(4)]


# ---------------------------------------------------------------------------
# Plain versions: int64 words in [0, p), any device
# ---------------------------------------------------------------------------

def mul64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product with x^4 -> W (ext.py:72-92), int64 (..., 4)."""
    m, ad = bb.mul64, bb.add64
    a0, a1, a2, a3 = a.unbind(-1)
    b0, b1, b2, b3 = b.unbind(-1)
    c0 = m(a0, b0)
    c1 = ad(m(a0, b1), m(a1, b0))
    c2 = ad(ad(m(a0, b2), m(a1, b1)), m(a2, b0))
    c3 = ad(ad(m(a0, b3), m(a1, b2)), ad(m(a2, b1), m(a3, b0)))
    c4 = ad(ad(m(a1, b3), m(a2, b2)), m(a3, b1))
    c5 = ad(m(a2, b3), m(a3, b2))
    c6 = m(a3, b3)
    return torch.stack([ad(c0, m(c4, W_MONTY)), ad(c1, m(c5, W_MONTY)),
                        ad(c2, m(c6, W_MONTY)), c3], dim=-1)


def scale64(a: torch.Tensor, s) -> torch.Tensor:
    """Extension (..., 4) times base (...) , int64."""
    if isinstance(s, torch.Tensor):
        s = s[..., None]
    return bb.mul64(a, s)


def bb_pow64(x: torch.Tensor, e: int) -> torch.Tensor:
    """Base-field x^e, int64 Montgomery words, square and multiply on
    canonical values (one reduction a product; the same words)."""
    c = x * bb.RINV_MOD_P % P
    r = torch.ones_like(x)
    while e:
        if e & 1:
            r = r * c % P
        e >>= 1
        if e:
            c = c * c % P
    return r * bb.R_MOD_P % P


def bb_inv64(x: torch.Tensor) -> torch.Tensor:
    """Fermat inverse x^(p-2), int64 words; 0 maps to 0."""
    return bb_pow64(x, P - 2)


def frobenius64(a: torch.Tensor, k: int) -> torch.Tensor:
    return bb.mul64(a, torch.tensor(frob_consts(k), dtype=torch.int64,
                                    device=a.device))


def inv64(a: torch.Tensor) -> torch.Tensor:
    """Inverse through the norm (ext.py:106-116), int64; 0 maps to 0."""
    g = mul64(frobenius64(a, 1), mul64(frobenius64(a, 2), frobenius64(a, 3)))
    norm = mul64(a, g)[..., 0]
    return scale64(g, bb_inv64(norm))


def mul_plain(a, b):
    return mul64(a.long(), b.long()).int()


def add_plain(a, b):
    return bb.add64(a.long(), b.long()).int()


def sub_plain(a, b):
    return bb.sub64(a.long(), b.long()).int()


def scale_plain(a, s):
    return scale64(a.long(), s.long()).int()


def inv_plain(a):
    return inv64(a.long()).int()


# ---------------------------------------------------------------------------
# Constructors and host conversion
# ---------------------------------------------------------------------------

def from_base(a: torch.Tensor) -> torch.Tensor:
    """Embed base-field words (...) into the extension (..., 4)."""
    z = torch.zeros(a.shape + (D - 1,), dtype=torch.int32, device=a.device)
    return torch.cat([a[..., None], z], dim=-1)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape) + (D,), dtype=torch.int32,
                       device=resolve_device(device))


def ones(shape, device=None) -> torch.Tensor:
    z = zeros(shape, device)
    z[..., 0] = bb.R_MOD_P
    return z


def from_canonical(coeffs, device=None) -> torch.Tensor:
    """Canonical host ints (..., 4) -> Montgomery words on ``device``,
    converted on the host."""
    arr = np.asarray(coeffs, dtype=np.uint64) % P
    return bb.from_numpy(bb.to_monty_np(arr), device=device)


# ---------------------------------------------------------------------------
# K2 wrappers
# ---------------------------------------------------------------------------

_OPS = {"mul": (0, mul_plain), "add": (1, add_plain), "sub": (2, sub_plain),
        "scale": (3, scale_plain), "inv": (4, inv_plain)}


def _elementwise(op: str, a: torch.Tensor, b=None) -> torch.Tensor:
    """Kernel K2 (csrc/ext.cu) on CUDA, the plain version on the CPU.
    ``a`` is (..., 4); ``b`` is (..., 4), or (...) for ``scale``, and
    broadcasts against ``a``.  A one-element ``b`` is passed to the kernel as
    it is; any other broadcast is materialised first."""
    code, plain = _OPS[op]
    operands = (a,) if b is None else (a, b)
    dev = _build.kernel_device(*operands)
    if dev.type == "cpu":
        return plain(a) if b is None else plain(a, b)
    if a.shape[-1] != D:
        raise ValueError(f"extension operand must end in 4, got {tuple(a.shape)}")
    bcast = 0
    if b is not None:
        b_elem = b.shape[:-1] if op != "scale" else b.shape
        if op != "scale" and b.shape[-1] != D:
            raise ValueError(f"extension operand must end in 4, got {tuple(b.shape)}")
        if b_elem.numel() == 1:
            bcast = 1
            out_shape = torch.broadcast_shapes(a.shape[:-1], b_elem) + (D,)
            a = a.expand(out_shape)
            b = b.reshape(-1)
        else:
            a_elem = a.shape[:-1]
            shape = torch.broadcast_shapes(a_elem, b_elem)
            a = a.expand(shape + (D,))
            b = b.expand(shape + ((D,) if op != "scale" else ()))
        b = b.contiguous()
        _build.check_words(b, f"ext {op} operand 1", dev)
    a = a.contiguous()
    _build.check_words(a, f"ext {op} operand 0", dev)
    out = torch.empty_like(a)
    n = a.numel() // D
    if n:
        _build.launch("ext_elementwise", "ovt_ext_elementwise", dev, code,
                      a.data_ptr(), None if b is None else b.data_ptr(),
                      out.data_ptr(), n, bcast)
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise("mul", a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise("add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise("sub", a, b)


def scale(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Extension element(s) times base-field scalar(s), broadcast."""
    return _elementwise("scale", a, c)


def inv(a: torch.Tensor) -> torch.Tensor:
    return _elementwise("inv", a)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def frobenius(a: torch.Tensor, k: int = 1) -> torch.Tensor:
    """a^(p^k): coefficient-wise scale (a K1 product on the card)."""
    consts = torch.tensor(frob_consts(k), dtype=torch.int32, device=a.device)
    return bb.mul(a, consts)


def exp_u64(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python exponent, by square and multiply.  The JAX package
    picks one of three programs by the exponent (ext.py:122-141); all three
    compute the same power."""
    result = ones(a.shape[:-1], device=a.device)
    while e > 0:
        if e & 1:
            result = mul(result, a)
        e >>= 1
        if e:
            a = mul(a, a)
    return result


def sum_mod(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum of extension elements along a non-trailing axis."""
    if axis < 0:
        axis -= 1
    a = a.movedim(axis, 0)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        a = torch.cat([add(a[:half], a[half:2 * half]), a[2 * half:]])
    return a[0]


def dot(a: torch.Tensor, b: torch.Tensor, axis: int) -> torch.Tensor:
    return sum_mod(mul(a, b), axis=axis)


def _powers(u: torch.Tensor, n: int, mul_fn) -> torch.Tensor:
    """Doubling into one buffer: step k writes u^k * out[:k] into out[k:2k]."""
    out = torch.empty((n, D), dtype=torch.int32, device=u.device)
    if n:
        out[0] = ones((), device=u.device)
    cur = u.reshape(1, D)  # u^k
    k = 1
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = mul_fn(out[:m], cur)
        k += m
        if k < n:
            cur = mul_fn(cur, cur)
    return out


def powers(u: torch.Tensor, n: int) -> torch.Tensor:
    """u^0 .. u^(n-1) of one element u (4,) by doubling, (n, 4): log2 n
    steps of two products each, as _ext_pows_jit (prover.py:220) does."""
    return _powers(u, n, mul)


def powers_plain(u: torch.Tensor, n: int) -> torch.Tensor:
    """``powers`` through the plain product, any device."""
    return _powers(u, n, mul_plain)
