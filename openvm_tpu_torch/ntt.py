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
    """rev(i) for i < 2^log_n, built by doubling: rev_{k+1} is 2 rev_k
    followed by 2 rev_k + 1."""
    rev = np.zeros(1, dtype=np.int64)
    for _ in range(log_n):
        rev = np.concatenate([2 * rev, 2 * rev + 1])
    return rev


def lde_points_np(log_n: int, shift: int = bb.GENERATOR) -> np.ndarray:
    """Montgomery words of x_r = shift * w^bitrev(r) over the coset
    shift*<w_{2^log_n}>, bit-reversed order: the points of a committed LDE
    (stark/prover.py:206-216), vectorised."""
    pts = bb.powers_np(bb.two_adic_generator_int(log_n), 1 << log_n, shift)
    return bb.to_monty_np(pts[bitrev_perm(log_n)])


# Device tables whose every prefix of 2^k words is the table for k, so the
# largest one built serves every smaller height: {(name, device): tensor}.
_PREFIX_TABLES: dict = {}


def prefix_table(name: str, log_n: int, build, device: torch.device) -> torch.Tensor:
    """The first 2^log_n words of the device table ``name``; ``build(log)``
    makes the numpy table of 2^log words when the cached one is too short."""
    key = (name, torch.device(device))
    have = _PREFIX_TABLES.get(key)
    if have is None or have.shape[0] < 1 << log_n:
        have = _table(np.ascontiguousarray(build(log_n), dtype=np.uint32),
                      device)
        _PREFIX_TABLES[key] = have
    return have[:1 << log_n]


def lde_points(log_n: int, device: torch.device) -> torch.Tensor:
    """``lde_points_np(log_n)`` on ``device``.  For r < 2^k the bit-reversed
    points of height 2^log_n are those of height 2^k (w_n^(2^(n-k)) = w_k),
    so one table serves every LDE height and every quotient domain."""
    return prefix_table("lde_points", log_n, lde_points_np, device)


# Points of a bit-reversed domain made on the card (K13, K14): for row
# r = hi 2^t + lo of height 2^h (t = ROOT_BITS), w_H^rev_h(r) =
# w_H^rev_(h-t)(hi) * w_(2^t)^rev_t(lo), a product of A(hi), made from the
# powers w_H^(2^k) = w_(H/2^k), and B(lo), a 2^t table shared by every
# height (for h <= t, B(r) = w_H^rev_h(r) itself: a prefix of the table).
ROOT_BITS = 10


@functools.lru_cache(maxsize=None)
def rev_roots_np(bits: int = ROOT_BITS) -> np.ndarray:
    """Montgomery words [B | B^-1 | gen | gen^-1]: B[j] = w_(2^bits)^rev(j)
    and its inverse for j < 2^bits, then w_(2^j) and w_(2^j)^-1 for
    j < 32 (0 past the field's two-adicity)."""
    gens = [bb.two_adic_generator_int(j) if j <= bb.TWO_ADICITY else 0 for j in range(32)]
    w = gens[bits]
    rev = bitrev_perm(bits)
    return np.concatenate([
        bb.to_monty_np(bb.powers_np(w, 1 << bits)[rev]),
        bb.to_monty_np(bb.powers_np(pow(w, -1, bb.P), 1 << bits)[rev]),
        bb.to_monty_np(np.asarray(gens, dtype=np.uint64)),
        bb.to_monty_np(np.asarray([pow(g, -1, bb.P) if g else 0 for g in gens],
                                  dtype=np.uint64))])


@functools.lru_cache(maxsize=None)
def rev_root_table(device: torch.device) -> torch.Tensor:
    """``rev_roots_np()`` on ``device``: 8.5 KB, the only table K13 and K14
    read to make their points."""
    return _table(rev_roots_np(), device)


def rev_root_points(log_h: int, rows, inverse: bool = False,
                    bits: int = ROOT_BITS) -> np.ndarray:
    """Canonical w_H^(+-rev_h(r)) for ``rows`` r < 2^log_h, made as K13 and
    K14 make them: A(r >> bits) from the set bits of rev(hi), one product a
    bit, times B(r mod 2^bits) from ``rev_roots_np(bits)``."""
    n = 1 << bits
    tab = rev_roots_np(bits).astype(np.uint64) * bb.RINV_MOD_P % bb.P
    b_tab, gen = (tab[n:2 * n], tab[2 * n + 32:]) if inverse else (tab[:n], tab[2 * n:2 * n + 32])
    r = np.asarray(rows, dtype=np.int64)
    a = np.ones(r.shape, dtype=np.uint64)
    hb = log_h - bits
    if hb > 0:
        e = bitrev_perm(hb)[r >> bits]
        for k in range(hb):
            a = np.where((e >> k) & 1 == 1, a * gen[log_h - k] % bb.P, a)
    return a * b_tab[r & (n - 1)] % bb.P


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
# K3: the pass plan and its plain model
# ---------------------------------------------------------------------------

K_MAX = 11  # stages per pass (csrc/ntt.cu K_MAX): a tile of 2^11 rows x 8 columns


def _pass_plan(log_n: int, k_max: int = K_MAX) -> list:
    """The passes [(s0, k), ...] of a 2^log_n-point DIF: every stage once, in
    order, in as few passes of at most k_max stages as can be, their sizes
    as even as can be (21 -> 11 + 10)."""
    if log_n == 0:
        return []
    n_pass = -(-log_n // k_max)
    base, extra = divmod(log_n, n_pass)
    plan, s0 = [], 0
    for p in range(n_pass):
        k = base + (p < extra)
        plan.append((s0, k))
        s0 += k
    return plan


def _pass_model(src, dst, tw, in_fac, out_fac, log_n, w, s0, k, n_in,
                bitrev_out) -> None:
    """Plain PyTorch mirror of one launch of csrc/ntt.cu's pass kernel, with
    its index arithmetic: tile rows hi | t << L | lo, 3-stage groups over
    bits b .. b+g-1 of t, twiddle tw[j << s] with j = ((t mod 2^(b+bv)) <<
    L) | lo; loads stop at n_in and take in_fac, stores go to bitrev(r) when
    bitrev_out and take out_fac of the row they go to."""
    n = 1 << log_n
    L = log_n - s0 - k
    x = torch.zeros((n, w), dtype=torch.int64, device=dst.device)
    x[:n_in] = src[:n_in].long()
    if in_fac is not None:
        x[:n_in] = bb.mul64(x[:n_in], in_fac[:n_in].long()[:, None])
    x = x.reshape(1 << s0, 1 << k, 1 << L, w)  # (hi, t, lo, column)
    lo = torch.arange(1 << L, device=dst.device)
    twl = tw.long()
    n_groups = (k + 2) // 3
    i = 0
    for gi in range(n_groups):
        g = k // n_groups + (gi < k % n_groups)
        b = k - i - g
        u = torch.arange(1 << (k - g), device=dst.device)
        base = ((u >> b) << (b + g)) | (u & ((1 << b) - 1))
        for qs in range(g):
            bv = g - 1 - qs
            for a in range(1 << g):
                if a & (1 << bv):
                    continue
                ta = base | (a << b)
                tb = ta | (1 << (b + bv))
                j = ((ta & ((1 << (b + bv)) - 1))[:, None] << L) | lo[None, :]
                wv = twl[j << (s0 + i + qs)][None, :, :, None]
                xa, xb = x[:, ta], x[:, tb]
                x[:, ta] = bb.add64(xa, xb)
                x[:, tb] = bb.mul64(bb.sub64(xa, xb), wv)
        i += g
    x = x.reshape(n, w)
    rows = torch.arange(n, device=dst.device)
    if bitrev_out:
        rows = torch.from_numpy(bitrev_perm(log_n)).to(dst.device)
    if out_fac is not None:
        x = bb.mul64(x, out_fac.long()[rows][:, None])
    dst[rows] = x.int()


def _launch_pass(src, dst, tw, in_fac, out_fac, log_n, w, s0, k, n_in,
                 bitrev_out) -> None:
    _build.launch("ntt", "ovt_ntt_pass", dst.device, src.data_ptr(),
                  dst.data_ptr(), tw.data_ptr(),
                  None if in_fac is None else in_fac.data_ptr(),
                  None if out_fac is None else out_fac.data_ptr(),
                  log_n, w, s0, k, n_in, int(bitrev_out))


def _dif(run_pass, src, dst, log_n: int, inverse: bool, *, n_in=None,
         in_fac=None, out=None, out_fac=None, k_max: int = K_MAX) -> torch.Tensor:
    """All DIF stages of a 2^log_n-point transform as passes: the first
    reads ``src`` (rows below n_in, times in_fac) and writes ``dst``, the
    rest work on ``dst`` in place; given ``out``, the last pass stores
    bit-reversed (natural order) into ``out`` instead, times out_fac.
    Returns the tensor written last.  No stage (log_n 0) is one pass of
    k = 0: the row work alone."""
    w = int(dst.shape[1])
    tw = _device_twiddles(log_n, inverse, dst.device)
    plan = _pass_plan(log_n, k_max) or [(0, 0)]
    n_in = (1 << log_n) if n_in is None else n_in
    cur = src
    for p, (s0, k) in enumerate(plan):
        last = p == len(plan) - 1
        target = out if last and out is not None else dst
        run_pass(cur, target, tw, in_fac if p == 0 else None,
                 out_fac if last else None, log_n, w, s0, k,
                 n_in if p == 0 else 1 << log_n, last and out is not None)
        cur = target
    return cur


def _ntt_passes(x, inverse: bool, run_pass, k_max: int = K_MAX):
    """ntt (inverse False) or intt of x through the pass kernel: the last
    pass stores in natural order, the inverse's times 1/N."""
    n, w = x.shape
    log_n = _log2_exact(n)
    fac = (_device_row_factors(log_n, 1, bb.inv_int(n), x.device)
           if inverse else None)
    y = torch.empty_like(x) if len(_pass_plan(log_n, k_max)) > 1 else None
    out = torch.empty_like(x)
    return _dif(run_pass, x, x if y is None else y, log_n, inverse, out=out,
                out_fac=fac, k_max=k_max)


def _coset_lde_passes(x, log_blowup, shift, bitrev_out, in_shift,
                      return_coeffs, run_pass, k_max: int = K_MAX):
    """coset_lde through the pass kernel (or its model).

    The inverse's last pass stores the coefficients in natural order, times
    1/N (the raw coefficients) or times (1/N) (shift/in_shift)^i (straight
    into the first n rows of the LDE); the forward transform's first pass
    reads those n rows, times the shift powers when they are raw, and the
    zero rows of the padding never; its last pass stores bit-reversed only
    when ``bitrev_out`` is False.  2^20 -> 2^21 rows is four launches."""
    n, w = x.shape
    log_n = _log2_exact(n)
    big_n = n << log_blowup
    big_log = log_n + log_blowup
    dev = x.device
    eff_shift = shift * bb.inv_int(in_shift) % bb.P
    padded = torch.empty((big_n, w), dtype=torch.int32, device=dev)
    if w == 0:
        return (padded, x.clone()) if return_coeffs else padded
    if return_coeffs:
        coeffs = _ntt_passes(x, True, run_pass, k_max) if log_n else x.clone()
        src, fac = coeffs, _device_row_factors(log_n, eff_shift, 1, dev)
    elif log_n:
        tmp = torch.empty_like(x) if len(_pass_plan(log_n, k_max)) > 1 else x
        src, fac = _dif(run_pass, x, tmp, log_n, True, out=padded,
                        out_fac=_device_row_factors(log_n, eff_shift,
                                                    bb.inv_int(n), dev),
                        k_max=k_max), None
    else:
        src, fac = x, _device_row_factors(0, eff_shift, 1, dev)
    out = None if bitrev_out else torch.empty_like(padded)
    y = _dif(run_pass, src, padded, big_log, False, n_in=n, in_fac=fac,
             out=out, k_max=k_max)
    return (y, coeffs) if return_coeffs else y


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


def ntt(x: torch.Tensor) -> torch.Tensor:
    """Forward NTT along axis 0, natural in / natural out. x: (N, W) monty."""
    log_n = _log2_exact(x.shape[0])
    if _check(x, x.shape[0]).type == "cpu":
        return ntt_plain(x)
    if log_n == 0 or x.numel() == 0:
        return x.clone()
    return _ntt_passes(x, False, _launch_pass)


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT along axis 0, natural in / natural out (scaled by 1/N)."""
    log_n = _log2_exact(x.shape[0])
    if _check(x, x.shape[0]).type == "cpu":
        return intt_plain(x)
    if log_n == 0 or x.numel() == 0:
        return x.clone()
    return _ntt_passes(x, True, _launch_pass)


def coset_lde(x: torch.Tensor, log_blowup: int, shift: int = bb.GENERATOR,
              bitrev_out: bool = True, in_shift: int = 1,
              return_coeffs: bool = False):
    """Low-degree extend the columns of x onto coset shift*<g_{N<<blowup}>.

    x holds evaluations over the coset in_shift*<g_N> (natural order).
    Returns evaluations in bit-reversed row order when bitrev_out (the order
    committed to Merkle trees).  return_coeffs=True also returns the raw
    INTT coefficients (natural order, monty, before the coset-shift
    multiply), as the JAX package's coset_lde (ntt.py:117) does.

    Kernel K3 on CUDA: the inverse and forward transforms in passes of up to
    11 stages each, the bit-reversal, the scale and the zero-pad fused into
    their first and last passes (``_coset_lde_passes``): four launches for
    2^20 -> 2^21 rows.  Bound by bytes and integer issue (see csrc/ntt.cu)."""
    n, w = x.shape
    dev = _check(x, n << log_blowup)
    if dev.type == "cpu":
        return coset_lde_plain(x, log_blowup, shift, bitrev_out, in_shift,
                               return_coeffs)
    return _coset_lde_passes(x, log_blowup, shift, bitrev_out, in_shift,
                             return_coeffs, _launch_pass)


def batched_coset_ldes(mats: list, log_blowup: int, return_coeffs: bool = False):
    """``coset_lde`` over a list of matrices, all matrices of one height
    extended by one call on their column-wise concatenation, as the JAX
    prover batches them (stark/prover.py:144).  Returns the LDEs in input
    order; those of a batch are column slices of one matrix.  With
    ``return_coeffs`` returns (ldes, coeffs), the raw INTT coefficients
    sliced the same way."""
    by_h: dict[int, list] = {}
    for k, m in enumerate(mats):
        by_h.setdefault(int(m.shape[0]), []).append(k)
    ldes: list = [None] * len(mats)
    coeffs: list = [None] * len(mats)
    for idxs in by_h.values():
        joined = mats[idxs[0]] if len(idxs) == 1 else torch.cat(
            [mats[k] for k in idxs], dim=1)
        y = coset_lde(joined, log_blowup, return_coeffs=return_coeffs)
        y, c = y if return_coeffs else (y, None)
        off = 0
        for k in idxs:
            w = int(mats[k].shape[1])
            ldes[k] = y[:, off:off + w]
            if return_coeffs:
                coeffs[k] = c[:, off:off + w]
            off += w
    return (ldes, coeffs) if return_coeffs else ldes
