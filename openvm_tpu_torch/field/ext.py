"""Quartic binomial extension F_p[x]/(x^4 - 11) over BabyBear.

Port of openvm_tpu/field/ext.py.  Elements are ``torch.int32`` Montgomery
words whose trailing axis has length 4 (coefficients a0 + a1 x + a2 x^2 +
a3 x^3), the JAX package's layout.

Two versions:
  * ``*64`` helpers and ``*_plain``: plain PyTorch in int64, any device.
  * ``mul``/``add``/``sub``/``scale``/``inv``: kernel K2 (csrc/ext.cu) on
    CUDA tensors, the plain version on CPU tensors.  ``neg``, ``exp_u64``,
    ``sum_mod`` and ``dot`` are built from those.
  * ``powers_host``/``powers``: K2's power series, one launch (the prover's
    zeta powers); ``powers_plain`` on the CPU.
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


def powers_plain(u: torch.Tensor, n: int) -> torch.Tensor:
    """u^0 .. u^(n-1) of one element u (4,) by doubling through the plain
    product, (n, 4), any device: log2 n steps of two products each, as
    _ext_pows_jit (prover.py:220) does; step k writes u^k * out[:k] into
    out[k:2k]."""
    out = torch.empty((n, D), dtype=torch.int32, device=u.device)
    if n:
        out[0] = ones((), device=u.device)
    cur = u.reshape(1, D)  # u^k
    k = 1
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = mul_plain(out[:m], cur)
        k += m
        if k < n:
            cur = mul_plain(cur, cur)
    return out


# The power series kernel (csrc/ext.cu ext_powers_kernel): POW_T threads a
# block, POW_E powers a thread.
POW_T, POW_E = 256, 16
POW_MAX = 1 << 31  # warp 0 makes the u^(2^j) of a block's first power, j < 31


def powers_host(u_words, n: int, device=None) -> torch.Tensor:
    """u^0 .. u^(n-1), (n, 4) int32 Montgomery words on ``device``, of one
    element given as four host Montgomery words.

    Kernel K2's power series (csrc/ext.cu) on CUDA: one launch, u's words
    passed by value, so nothing goes up; ``powers_plain`` on the CPU."""
    dev = resolve_device(device)
    words = [int(w) for w in u_words]
    if len(words) != D or not all(0 <= w < P for w in words):
        raise ValueError(f"u must be four Montgomery words below p, got {words}")
    if dev.type == "cpu":
        return powers_plain(torch.tensor(words, dtype=torch.int32), n)
    if not 0 <= n <= POW_MAX:
        raise ValueError(f"the power series takes 0 <= n <= 2^31, got {n}")
    out = torch.empty((n, D), dtype=torch.int32, device=dev)
    if n:
        _build.launch("ext_powers", "ovt_ext_powers", dev, *words, out.data_ptr(), n)
    return out


def powers(u: torch.Tensor, n: int) -> torch.Tensor:
    """``powers_host`` of an element (4,) held in a tensor, on its device:
    on CUDA its words make one copy to the host before the launch."""
    return powers_host(u.reshape(D).tolist(), n, u.device)


def _mul_pre_model(a: np.ndarray, b) -> np.ndarray:
    """csrc/ext.cuh mul_pre on numpy uint64 words (..., 4) by one fixed b
    (4,): b's W-multiples made once, each coefficient's four products
    summed unreduced (below 4 p^2 < 2^64, so uint64 holds them exactly)
    and reduced once, x R^-1 mod p."""
    b = [int(v) for v in b]
    bw = [0] + [b[k] * W_MONTY * bb.RINV_MOD_P % P for k in (1, 2, 3)]
    a = np.asarray(a, dtype=np.uint64)
    a0, a1, a2, a3 = (a[..., k] for k in range(4))
    u = np.uint64
    sums = [a0 * u(b[0]) + a1 * u(bw[3]) + a2 * u(bw[2]) + a3 * u(bw[1]),
            a0 * u(b[1]) + a1 * u(b[0]) + a2 * u(bw[3]) + a3 * u(bw[2]),
            a0 * u(b[2]) + a1 * u(b[1]) + a2 * u(b[0]) + a3 * u(bw[3]),
            a0 * u(b[3]) + a1 * u(b[2]) + a2 * u(b[1]) + a3 * u(b[0])]
    return np.stack([s % u(P) * u(bb.RINV_MOD_P) % u(P) for s in sums], axis=-1)


def _powers_model(u, n: int, threads: int = POW_T, per_thread: int = POW_E) -> torch.Tensor:
    """ext_powers_kernel modelled on the CPU in int64: per block of
    ``threads`` x ``per_thread`` powers, u^(2^j) by repeated squaring, the
    block's first power as the product of those of its exponent's bits,
    the table u^0 .. u^(threads-1) in log2 threads rounds, and each thread's
    column from u^(first + t), stepping by u^threads (``_mul_pre_model``)."""
    log_t = threads.bit_length() - 1
    if threads != 1 << log_t:
        raise ValueError("threads must be a power of two")
    u = torch.as_tensor(np.asarray(u, dtype=np.int64))
    one = torch.tensor([bb.R_MOD_P, 0, 0, 0], dtype=torch.int64)
    span = threads * per_thread
    blocks = -(-n // span)
    firsts = torch.arange(blocks, dtype=torch.int64) * span
    bits = max(log_t + 1, int(firsts[-1]).bit_length() if blocks else 0)
    sq = [u]
    for _ in range(1, bits):
        sq.append(mul64(sq[-1], sq[-1]))
    first_pow = one.expand(blocks, D)
    for j in range(bits):
        bit = ((firsts >> j) & 1).bool()[:, None]
        first_pow = torch.where(bit, mul64(first_pow, sq[j].expand(blocks, D)), first_pow)
    tab = one[None].clone()
    for j in range(log_t):  # tab[k:2k] = tab[:k] u^k
        tab = torch.cat([tab, mul64(tab, sq[j].expand(tab.shape[0], D))])
    x = mul64(first_pow[:, None], tab[None]).numpy().astype(np.uint64)
    cols = []  # (blocks, threads, 4) a step
    for e in range(per_thread):
        cols.append(x)
        x = _mul_pre_model(x, sq[log_t].tolist())
    out = np.stack(cols, axis=1).reshape(-1, D)[:n]  # (block, e, thread)
    return torch.from_numpy(out.astype(np.int32))
