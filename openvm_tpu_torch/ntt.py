"""Batched radix-2 NTT / coset LDE over BabyBear.

Port of openvm_tpu/ntt.py.  Trace matrices are (N, W) int32 Montgomery
words; the transform runs down the rows, across all W columns.

Conventions (the JAX package's, mirroring plonky3):
  * ``ntt`` / ``intt``: natural order in and out, domain generator
    ``two_adic_generator(log2 N)``.
  * ``coset_lde``: natural-order evaluations over in_shift*<g_N> in,
    evaluations over shift*<g_{N*blowup}> out, in **bit-reversed** row order
    unless ``bitrev_out=False``.

On CUDA tensors ``ntt``, ``intt`` and ``coset_lde`` run kernel K3
(csrc/ntt.cu); on CPU tensors their ``*_plain`` versions, which repeat the
JAX package's decimation-in-frequency stages in int64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .field import babybear as bb


def _log2_exact(n: int) -> int:
    log_n = int(n).bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT size {n} is not a power of two")
    return log_n


@functools.lru_cache(maxsize=None)
def _twiddle_table(log_n: int, inverse: bool) -> np.ndarray:
    """Powers g^0..g^(N/2-1) of the 2^log_n root (monty), natural order;
    equal to the JAX package's table (ntt.py:31), built by doubling."""
    g = bb.two_adic_generator_int(log_n)
    if inverse:
        g = bb.inv_int(g)
    return bb.to_monty_np(bb.powers_np(g, (1 << log_n) // 2))


@functools.lru_cache(maxsize=None)
def _row_factors(log_n: int, base: int, scale: int) -> np.ndarray:
    """Monty scale*base^i for i < 2^log_n: the coset-shift powers of the
    JAX package (ntt.py:106) times an optional 1/N."""
    return bb.to_monty_np(bb.powers_np(base, 1 << log_n, scale))


def _table(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(arr.view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _device_twiddles(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    return _table(_twiddle_table(log_n, inverse), device)


@functools.lru_cache(maxsize=None)
def _device_row_factors(log_n: int, base: int, scale: int,
                        device: torch.device) -> torch.Tensor:
    return _table(_row_factors(log_n, base, scale), device)


@functools.lru_cache(maxsize=None)
def bitrev_perm(log_n: int) -> np.ndarray:
    idx = np.arange(1 << log_n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def bitrev_rows(x: torch.Tensor) -> torch.Tensor:
    """Rows in bit-reversed order (plain gather; any device)."""
    log_n = _log2_exact(x.shape[0])
    return x[torch.from_numpy(bitrev_perm(log_n)).to(x.device)]


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _dif_stages_plain(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Decimation-in-frequency stages: natural input -> bit-reversed output,
    int64 words (ntt.py:60)."""
    n = 1 << log_n
    w = x.shape[1]
    tw_full = _table(_twiddle_table(log_n, inverse), x.device).long() if log_n else None
    for s in range(log_n):
        half = n >> (s + 1)
        x = x.reshape(1 << s, 2, half, w)
        a, b = x[:, 0], x[:, 1]
        tw = tw_full[::1 << s][None, :, None]
        x = torch.stack([bb.add64(a, b), bb.mul64(bb.sub64(a, b), tw)],
                        dim=1).reshape(n, w)
    return x


def ntt_plain(x: torch.Tensor) -> torch.Tensor:
    log_n = _log2_exact(x.shape[0])
    return bitrev_rows(_dif_stages_plain(x.long(), log_n, False)).int()


def intt_plain(x: torch.Tensor) -> torch.Tensor:
    log_n = _log2_exact(x.shape[0])
    y = bitrev_rows(_dif_stages_plain(x.long(), log_n, True))
    n_inv = bb.to_monty_int(bb.inv_int(x.shape[0]))
    return bb.mul64(y, n_inv).int()


def coset_lde_plain(x: torch.Tensor, log_blowup: int, shift: int = bb.GENERATOR,
                    bitrev_out: bool = True, in_shift: int = 1,
                    return_coeffs: bool = False):
    n, w = x.shape
    log_n = _log2_exact(n)
    raw_coeffs = intt_plain(x)
    eff_shift = shift * bb.inv_int(in_shift) % bb.P
    pw = _table(_row_factors(log_n, eff_shift, 1), x.device).long()[:, None]
    coeffs = bb.mul64(raw_coeffs.long(), pw)
    padded = torch.cat([coeffs, coeffs.new_zeros(((n << log_blowup) - n, w))])
    y = _dif_stages_plain(padded, log_n + log_blowup, False)
    if not bitrev_out:
        y = bitrev_rows(y)
    y = y.int()
    return (y, raw_coeffs) if return_coeffs else y


# ---------------------------------------------------------------------------
# K3 wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, rows: int) -> torch.device:
    dev = _build.kernel_device(x)
    if dev.type == "cuda":
        _build.check_words(x, "NTT input", dev)
        if x.dim() != 2:
            raise ValueError(f"NTT input must be (N, W), got {tuple(x.shape)}")
        if rows * x.shape[1] >= 1 << 32:
            raise ValueError("NTT kernels index with 32 bits: N*W < 2^32")
    return dev


def _dif(src: torch.Tensor, dst: torch.Tensor, log_n: int, inverse: bool) -> None:
    """All DIF stages, the first from src into dst, the rest in place."""
    tw = _device_twiddles(log_n, inverse, dst.device)
    for s in range(log_n):
        _build.launch("ntt", "ovt_ntt_dif_stage", dst.device,
                      (src if s == 0 else dst).data_ptr(), dst.data_ptr(),
                      tw.data_ptr(), log_n, dst.shape[1], s)


def _rows(src: torch.Tensor, dst: torch.Tensor, factors, bitrev_log: int) -> None:
    """dst[i] = src[bitrev(i) or i] * factors[i] for i < len(src), 0 below."""
    _build.launch("ntt", "ovt_ntt_rows", dst.device, src.data_ptr(),
                  dst.data_ptr(), None if factors is None else factors.data_ptr(),
                  src.shape[0], dst.shape[0], dst.shape[1], bitrev_log)


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along axis 0, natural in / natural out. x: (N, W) monty."""
    log_n = _log2_exact(x.shape[0])
    if _check(x, x.shape[0]).type == "cpu":
        return ntt_plain(x)
    if log_n == 0 or x.numel() == 0:
        return x.clone()
    y = torch.empty_like(x)
    _dif(x, y, log_n, False)
    out = torch.empty_like(x)
    _rows(y, out, None, log_n)
    return out


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along axis 0, natural in / natural out (scaled by 1/N)."""
    log_n = _log2_exact(x.shape[0])
    dev = _check(x, x.shape[0])
    if dev.type == "cpu":
        return intt_plain(x)
    if log_n == 0 or x.numel() == 0:
        return x.clone()
    y = torch.empty_like(x)
    _dif(x, y, log_n, True)
    out = torch.empty_like(x)
    n_inv = bb.inv_int(x.shape[0])
    _rows(y, out, _device_row_factors(log_n, 1, n_inv, dev), log_n)
    return out


def coset_lde(x: torch.Tensor, log_blowup: int, shift: int = bb.GENERATOR,
              bitrev_out: bool = True, in_shift: int = 1,
              return_coeffs: bool = False):
    """Low-degree extend the columns of x onto coset shift*<g_{N<<blowup}>.

    x holds evaluations over the coset in_shift*<g_N> (natural order).
    Returns evaluations in bit-reversed row order when bitrev_out (the order
    committed to Merkle trees).  return_coeffs=True also returns the raw
    INTT coefficients (natural order, monty, before the coset-shift
    multiply), as the JAX package's coset_lde (ntt.py:117) does.

    Kernel K3 on CUDA: inverse DIF stages, one row pass that bit-reverses,
    multiplies by (1/N)*(shift/in_shift)^i and zero-pads, forward DIF stages
    on the padded matrix in place, and a bit-reversal pass only when
    ``bitrev_out`` is False.  Bound by bytes (see csrc/ntt.cu)."""
    n, w = x.shape
    log_n = _log2_exact(n)
    big_n = n << log_blowup
    dev = _check(x, big_n)
    if dev.type == "cpu":
        return coset_lde_plain(x, log_blowup, shift, bitrev_out, in_shift,
                               return_coeffs)
    eff_shift = shift * bb.inv_int(in_shift) % bb.P
    padded = torch.empty((big_n, w), dtype=torch.int32, device=dev)
    raw_coeffs = None
    if w == 0:
        return (padded, x.clone()) if return_coeffs else padded
    if return_coeffs:
        raw_coeffs = intt(x)
        _rows(raw_coeffs, padded,
              _device_row_factors(log_n, eff_shift, 1, dev), 0)
    else:
        y = x
        if log_n:
            y = torch.empty_like(x)
            _dif(x, y, log_n, True)
        _rows(y, padded,
              _device_row_factors(log_n, eff_shift, bb.inv_int(n), dev), log_n)
    big_log = log_n + log_blowup
    _dif(padded, padded, big_log, False)
    if not bitrev_out and big_log:
        out = torch.empty_like(padded)
        _rows(padded, out, None, big_log)
        padded = out
    return (padded, raw_coeffs) if return_coeffs else padded


def batched_coset_ldes(mats: list, log_blowup: int) -> list:
    """``coset_lde`` over a list of matrices, all matrices of one height
    extended by one call on their column-wise concatenation, as the JAX
    prover batches them (stark/prover.py:144).  Returns the LDEs in input
    order; those of a batch are column slices of one matrix."""
    by_h: dict[int, list] = {}
    for k, m in enumerate(mats):
        by_h.setdefault(int(m.shape[0]), []).append(k)
    ldes: list = [None] * len(mats)
    for idxs in by_h.values():
        joined = mats[idxs[0]] if len(idxs) == 1 else torch.cat(
            [mats[k] for k in idxs], dim=1)
        y = coset_lde(joined, log_blowup)
        off = 0
        for k in idxs:
            w = int(mats[k].shape[1])
            ldes[k] = y[:, off:off + w]
            off += w
    return ldes
