"""BabyBear prime field arithmetic on int32 Montgomery words.

Port of openvm_tpu/field/babybear.py.  The field is F_p with
p = 2^31 - 2^27 + 1; tensors hold ``torch.int32`` Montgomery words x*R mod p
with R = 2^32 and values in [0, p), the JAX package's layout
(babybear.py:1-15), so raw words compare equal with its uint32 output.

Two versions of the elementwise operations:
  * ``*_plain``: plain PyTorch in int64 (the CPU has no uint32 arithmetic);
    any device.  The tests and chip_smoke.py compare against them.
  * ``to_monty``/``from_monty``/``mul``/``add``/``sub``: kernel K1
    (csrc/babybear.cu) on CUDA tensors, the plain version on CPU tensors.
``neg``, ``exp_u64``, ``inv``, ``sum_mod`` and ``dot`` are built from those
five, so on the card they too run through K1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import resolve_device

P = 2013265921  # 2^31 - 2^27 + 1
TWO_ADICITY = 27
GENERATOR = 31  # multiplicative generator of F_p^* (matches plonky3)

_R = 1 << 32
R_MOD_P = _R % P  # Montgomery form of 1
R2_MOD_P = (_R * _R) % P
RINV_MOD_P = pow(_R, -1, P)
NPRIME = (-pow(P, -1, _R)) % _R  # -p^-1 mod 2^32


# ---------------------------------------------------------------------------
# Host (python int / numpy) helpers
# ---------------------------------------------------------------------------

def to_monty_int(x: int) -> int:
    return (x * _R) % P


def from_monty_int(x: int) -> int:
    return (x * RINV_MOD_P) % P


def inv_int(x: int) -> int:
    return pow(x, -1, P)


def ext_mul_int(x: tuple, y: tuple) -> tuple:
    """Quartic-extension product in canonical ints, F_p[w]/(w^4 - 11)
    (openvm_tpu/field/babybear.py:67)."""
    out = [0, 0, 0, 0]
    for i in range(4):
        for j in range(4):
            k = i + j
            t = x[i] * y[j]
            if k < 4:
                out[k] += t
            else:
                out[k - 4] += 11 * t
    return tuple(v % P for v in out)


def ext_inv_int(x: tuple) -> tuple:
    """Quartic-extension inverse via the norm to the base field
    (openvm_tpu/field/babybear.py:81): conj2(a) = a(w -> -w); N2 = a *
    conj2(a) lies in F_p[w^2]; then one more norm step down to F_p."""
    a0, a1, a2, a3 = (int(v) % P for v in x)
    # b = a * conj(a) where conj negates odd coefficients -> even only
    b0 = (a0 * a0 - 11 * (2 * a1 * a3 - a2 * a2)) % P
    b2 = (2 * a0 * a2 - a1 * a1 - 11 * a3 * a3) % P
    # c = b * conj'(b) with conj'(w^2 -> -w^2): c = b0^2 - 11*b2^2 in F_p
    c = (b0 * b0 - 11 * b2 * b2) % P
    cinv = pow(c, -1, P)
    # a^{-1} = conj(a) * conj'(b) * c^{-1}
    d0, d2 = (b0 * cinv) % P, (-b2 * cinv) % P
    # e = conj(a) = (a0, -a1, a2, -a3); result = e * (d0 + d2 w^2)
    e = (a0, (-a1) % P, a2, (-a3) % P)
    return ext_mul_int(e, (d0, 0, d2, 0))


def two_adic_generator_int(bits: int) -> int:
    """Canonical 2^bits-th root of unity: g^((p-1)/2^bits) with g=31."""
    if not 0 <= bits <= TWO_ADICITY:
        raise ValueError(f"no 2^{bits}-th root of unity in BabyBear")
    return pow(GENERATOR, (P - 1) >> bits, P)


def to_monty_np(x: np.ndarray) -> np.ndarray:
    """Canonical values (any unsigned dtype, < 2^31) -> uint32 Montgomery."""
    return ((np.asarray(x, dtype=np.uint64) << np.uint64(32)) % P).astype(np.uint32)


def powers_np(base: int, n: int, scale: int = 1) -> np.ndarray:
    """Canonical uint64 scale*base^i for i < n, vectorised by doubling."""
    out = np.empty(n, dtype=np.uint64)
    if n:
        out[0] = scale % P
    filled = 1
    while filled < n:
        k = min(filled, n - filled)
        out[filled:filled + k] = out[:k] * np.uint64(pow(base, filled, P)) % P
        filled += k
    return out


# ---------------------------------------------------------------------------
# numpy <-> device
# ---------------------------------------------------------------------------

def from_numpy(arr, device=None) -> torch.Tensor:
    """Raw uint32 Montgomery words (as the JAX package holds them) -> int32
    tensor, unchanged.  ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    a = np.ascontiguousarray(arr, dtype=np.uint32)
    if a.size and int(a.max()) >= P:
        raise ValueError("Montgomery words must lie in [0, p)")
    return torch.from_numpy(a.view(np.int32)).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32 Montgomery words -> uint32 numpy array, unchanged."""
    return t.detach().cpu().numpy().astype(np.uint32)


def monty(x, device=None) -> torch.Tensor:
    """Canonical host values -> Montgomery words on ``device`` (default
    CUDA), through ``to_monty``."""
    arr = (np.asarray(x, dtype=np.uint64) % P).astype(np.uint32)
    return to_monty(torch.from_numpy(arr.view(np.int32)).to(resolve_device(device)))


def canonical_np(t: torch.Tensor) -> np.ndarray:
    """Montgomery words on any device -> canonical uint64 numpy values."""
    return from_monty(t).cpu().numpy().astype(np.uint64)


# ---------------------------------------------------------------------------
# Plain versions (int64 arithmetic, any device)
# ---------------------------------------------------------------------------

def mul64(a: torch.Tensor, b) -> torch.Tensor:
    """Montgomery product of int64 words in [0, p): a*b*R^-1 mod p."""
    return a * b % P * RINV_MOD_P % P


def add64(a: torch.Tensor, b) -> torch.Tensor:
    s = a + b
    return torch.where(s >= P, s - P, s)


def sub64(a: torch.Tensor, b) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + P, d)


def to_monty_plain(x: torch.Tensor) -> torch.Tensor:
    return (x.long() * _R % P).int()


def from_monty_plain(x: torch.Tensor) -> torch.Tensor:
    return (x.long() * RINV_MOD_P % P).int()


def mul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return mul64(a.long(), b.long()).int()


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add64(a.long(), b.long()).int()


def sub_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return sub64(a.long(), b.long()).int()


# ---------------------------------------------------------------------------
# K1 wrappers
# ---------------------------------------------------------------------------

_OPS = {"to_monty": (0, to_monty_plain), "from_monty": (1, from_monty_plain),
        "mul": (2, mul_plain), "add": (3, add_plain), "sub": (4, sub_plain)}


def _elementwise(op: str, *operands: torch.Tensor) -> torch.Tensor:
    """Kernel K1 (csrc/babybear.cu), replacing the JAX package's jitted
    elementwise ops (babybear.py:131-182).  Bound by bytes: one word read
    per operand and one written.  Operands broadcast as in JAX; a broadcast
    or strided operand is materialised contiguous before the launch."""
    code, plain = _OPS[op]
    dev = _build.kernel_device(*operands)
    if dev.type == "cpu":
        return plain(*operands)
    if len(operands) == 2:
        operands = torch.broadcast_tensors(*operands)
    operands = [t.contiguous() for t in operands]
    for i, t in enumerate(operands):
        _build.check_words(t, f"{op} operand {i}", dev)
    out = torch.empty_like(operands[0])
    if out.numel():
        b = operands[1] if len(operands) == 2 else operands[0]
        _build.launch("bb_elementwise", "ovt_bb_elementwise", dev, code,
                      operands[0].data_ptr(), b.data_ptr(), out.data_ptr(),
                      out.numel())
    return out


def to_monty(x: torch.Tensor) -> torch.Tensor:
    """Canonical words in [0, p) -> Montgomery form."""
    return _elementwise("to_monty", x)


def from_monty(x: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical words in [0, p)."""
    return _elementwise("from_monty", x)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product: mul(aR, bR) = abR (mod p)."""
    return _elementwise("mul", a, b)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise("add", a, b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _elementwise("sub", a, b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def ones_like(a: torch.Tensor) -> torch.Tensor:
    return torch.full_like(a, R_MOD_P)


def exp_u64(base: torch.Tensor, e: int) -> torch.Tensor:
    """base^e for a python exponent, by square and multiply."""
    result = ones_like(base)
    while e > 0:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = mul(base, base)
    return result


def inv(a: torch.Tensor) -> torch.Tensor:
    """Inverse via Fermat: a^(p-2).  0 maps to 0."""
    return exp_u64(a, P - 2)


def sum_mod(a: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Modular sum along an axis, as a log-depth tree of ``add``."""
    a = a.movedim(axis, 0)
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        a = torch.cat([add(a[:half], a[half:2 * half]), a[2 * half:]])
    return a[0]


def dot(a: torch.Tensor, b: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Sum_i a_i * b_i mod p along an axis (both in Montgomery form)."""
    return sum_mod(mul(a, b), axis=axis)
