"""Poseidon2 permutation (width 16, BabyBear): plain PyTorch, kernel K4, host.

Port of openvm_tpu/poseidon2.py.  Parameters as there (and in the reference,
crates/circuits/poseidon2-air/src/lib.rs:37-44): WIDTH=16, 4 + 4 external
rounds, 13 internal rounds, S-box x^7, plonky3's mds_light_permutation and
the BabyBear internal diagonal.  Round constants come from the Grain LFSR
(copied from openvm_tpu/poseidon2.py:60-111) and can be replaced with
``set_round_constants``; they are this system's only "weights".

Implementations, all equal:
  * ``permute``, ``compress_pairs``, ``hash_rows_plain``: plain PyTorch in
    int64 on any device, (..., 16) int32 Montgomery words.
  * ``hash_rows``: kernel K4 (csrc/poseidon2.cu) on CUDA tensors, the plain
    version on CPU tensors.  Kernel K5 (the Merkle compress layer, same
    source) is wrapped in merkle.py.
  * ``Poseidon2Host``: numpy uint64 canonical values, for the challenger and
    the host verifier (copied from openvm_tpu/poseidon2.py:240-325).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .field import babybear as bb

WIDTH = 16
RATE = 8
OUT = 8
HALF_FULL_ROUNDS = 4
PARTIAL_ROUNDS = 13

P = bb.P


# BabyBear internal-layer diagonal (plonky3 p3-baby-bear INTERNAL_DIAG_MONTY):
# [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/4, 1/8, 1/2^27, -1/2^8, -1/16,
#  -1/2^27]
def _frac(num: int, den: int) -> int:
    return (num * pow(den, -1, P)) % P


INTERNAL_DIAG = np.array([
    P - 2, 1, 2, _frac(1, 2), 3, 4, _frac(-1, 2), P - 3, P - 4,
    _frac(1, 1 << 8), _frac(1, 4), _frac(1, 8), _frac(1, 1 << 27),
    _frac(-1, 1 << 8), _frac(-1, 16), _frac(-1, 1 << 27),
], dtype=np.uint64)


def grain_round_constants(p: int = P, t: int = WIDTH,
                          r_f: int = 2 * HALF_FULL_ROUNDS,
                          r_p: int = PARTIAL_ROUNDS) -> np.ndarray:
    """(r_f + r_p, t) canonical round constants via the Grain LFSR
    (Poseidon paper, appendix F)."""
    n = p.bit_length()  # 31 for BabyBear
    bits = []
    for val, width in ((1, 2), (0, 4), (n, 12), (t, 12), (r_f, 10), (r_p, 10)):
        bits.extend(int(b) for b in bin(val)[2:].zfill(width))
    bits.extend([1] * 30)
    if len(bits) != 80:
        raise ValueError("Grain LFSR seed must be 80 bits")
    state = bits

    def next_raw_bit():
        new = (state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13]
               ^ state[0])
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        next_raw_bit()

    def next_bit():
        # shrinking generator: first bit selects, second is the output
        while True:
            b1 = next_raw_bit()
            b2 = next_raw_bit()
            if b1 == 1:
                return b2

    def next_field_element():
        while True:
            v = 0
            for _ in range(n):
                v = (v << 1) | next_bit()
            if v < p:
                return v

    out = np.empty((r_f + r_p, t), dtype=np.uint64)
    for r in range(r_f + r_p):
        for i in range(t):
            out[r, i] = next_field_element()
    return out


# Round-constant storage (canonical uint64): beginning full | partial |
# ending full.  _RC_VERSION counts replacements, so device copies know when
# they are stale.
_RC_ALL = grain_round_constants()
BEGIN_RC = _RC_ALL[:HALF_FULL_ROUNDS]                       # (4, 16)
PARTIAL_RC = _RC_ALL[HALF_FULL_ROUNDS:
                     HALF_FULL_ROUNDS + PARTIAL_ROUNDS][:, 0]  # (13,)
END_RC = _RC_ALL[HALF_FULL_ROUNDS + PARTIAL_ROUNDS:]        # (4, 16)
_RC_VERSION = 0
_UPLOADED: dict = {}  # CUDA device -> _RC_VERSION of its __constant__ copy


def set_round_constants(begin_rc, partial_rc, end_rc) -> None:
    """Replace the round constants (canonical ints), as
    openvm_tpu.poseidon2.set_round_constants (:114) does; the kernels'
    constant memory is refreshed before their next launch."""
    global BEGIN_RC, PARTIAL_RC, END_RC, _RC_VERSION
    begin = np.asarray(begin_rc, dtype=np.uint64) % P
    partial = np.asarray(partial_rc, dtype=np.uint64) % P
    end = np.asarray(end_rc, dtype=np.uint64) % P
    if (begin.shape != (HALF_FULL_ROUNDS, WIDTH)
            or partial.shape != (PARTIAL_ROUNDS,)
            or end.shape != (HALF_FULL_ROUNDS, WIDTH)):
        raise ValueError("round constants must be (4, 16), (13,), (4, 16)")
    BEGIN_RC, PARTIAL_RC, END_RC = begin, partial, end
    _RC_VERSION += 1


def _monty_constants():
    """Round constants and diagonal as uint32 Montgomery words."""
    return (bb.to_monty_np(BEGIN_RC), bb.to_monty_np(PARTIAL_RC),
            bb.to_monty_np(END_RC), bb.to_monty_np(INTERNAL_DIAG))


@functools.lru_cache(maxsize=8)
def _plain_constants(version: int, device: torch.device):
    """Round constants and diagonal as canonical int64 values (the plain
    version computes on canonical values)."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.int64) % P)
                 .to(device) for a in (BEGIN_RC, PARTIAL_RC, END_RC, INTERNAL_DIAG))


def upload_constants(device: torch.device) -> None:
    """Copy the current constants into the kernels' __constant__ memory on
    ``device`` unless it already holds them."""
    if _UPLOADED.get(device) == _RC_VERSION:
        return
    arrays = [np.ascontiguousarray(a) for a in _monty_constants()]
    _build.call("ovt_p2_set_constants", device,
                *(a.ctypes.data for a in arrays))
    _UPLOADED[device] = _RC_VERSION


# ---------------------------------------------------------------------------
# Plain version (int64, any device)
#
# The permutation is computed on canonical values: Montgomery words go in
# and out, converted once at each end.  Every step is a field operation, so
# the words equal the Montgomery computation's; a product then takes one
# reduction instead of two, and sums are reduced once after the linear
# layers (inputs below p, so every intermediate stays below 2^63).
# ---------------------------------------------------------------------------

def _sbox(x):
    x2 = x * x % P
    x3 = x2 * x % P
    return x3.mul_(x3).remainder_(P).mul_(x).remainder_(P)


def _external_linear(state):
    """plonky3's external layer: MDSMat4 on each 4-lane block, then each
    lane plus its column's sum over the blocks; (..., 16) below p in and
    out (the sums stay below 35p)."""
    x = state.reshape(state.shape[:-1] + (4, 4))
    x0, x1, x2, x3 = x.unbind(-1)
    t01 = x0 + x1
    t23 = x2 + x3
    t0123 = t01 + t23
    t01123 = t0123 + x1
    t01233 = t0123 + x3
    s = torch.stack([t01123 + t01, t01123 + 2 * x2, t01233 + t23,
                     t01233 + 2 * x0], dim=-1)
    return s.add_(s.sum(dim=-2, keepdim=True)).remainder_(P).reshape(state.shape)


def _permute64(s, consts):
    """Poseidon2 on canonical int64 values (..., 16)."""
    begin, partial, end, diag = consts
    s = _external_linear(s)
    for r in range(HALF_FULL_ROUNDS):
        s = _external_linear(_sbox((s + begin[r]) % P))
    for r in range(PARTIAL_ROUNDS):
        # lane 0 through the S-box, then diag * s + sum(s) on every lane
        x0 = _sbox((s[..., 0] + partial[r]) % P)
        total = s[..., 1:].sum(dim=-1).add_(x0)
        s = s * diag
        s[..., 0] = x0 * diag[0]
        s.add_(total[..., None]).remainder_(P)
    for r in range(HALF_FULL_ROUNDS):
        s = _external_linear(_sbox((s + end[r]) % P))
    return s


def _canonical64(words: torch.Tensor) -> torch.Tensor:
    return words.long() * bb.RINV_MOD_P % P


def _monty32(values: torch.Tensor) -> torch.Tensor:
    return (values * bb.R_MOD_P % P).int()


def permute(state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon2, plain PyTorch: state (..., 16) int32 monty."""
    consts = _plain_constants(_RC_VERSION, state.device)
    return _monty32(_permute64(_canonical64(state), consts))


def compress_pairs(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """TruncatedPermutation 2-to-1, plain PyTorch: (N, 8)+(N, 8) -> (N, 8)."""
    return permute(torch.cat([left, right], dim=1))[:, :OUT]


def hash_rows_plain(matrix: torch.Tensor) -> torch.Tensor:
    """PaddingFreeSponge over each row, plain PyTorch: (N, W) -> (N, 8)."""
    consts = _plain_constants(_RC_VERSION, matrix.device)
    m = _canonical64(matrix)
    n, w = m.shape
    state = m.new_zeros((n, WIDTH))
    for c0 in range(0, w, RATE):
        chunk = m[:, c0:c0 + RATE]
        state = _permute64(torch.cat([chunk, state[:, chunk.shape[1]:]], dim=1),
                           consts)
    return _monty32(state[:, :OUT])


def hash_rows(matrix: torch.Tensor) -> torch.Tensor:
    """PaddingFreeSponge over each row: (N, W) monty -> (N, 8) digests.

    Overwrite-mode sponge, rate 8, exactly p3_symmetric::PaddingFreeSponge:
    the state starts at zero; each 8-wide chunk of the row overwrites
    state[:8] (a short last chunk only its own lanes), then permute; the
    digest is state[:8].

    Kernel K4 on CUDA (csrc/poseidon2.cu), replacing the JAX package's
    hash_rows (poseidon2.py:213): one thread per row, bound by integer
    operations."""
    dev = _build.kernel_device(matrix)
    if dev.type == "cpu":
        return hash_rows_plain(matrix)
    _build.check_words(matrix, "hash_rows input", dev)
    if matrix.dim() != 2:
        raise ValueError(f"hash_rows takes (N, W), got {tuple(matrix.shape)}")
    n, w = matrix.shape
    out = torch.empty((n, OUT), dtype=torch.int32, device=dev)
    if n:
        upload_constants(dev)
        _build.launch("poseidon2_hash_rows", "ovt_poseidon2_hash_rows", dev,
                      matrix.data_ptr(), out.data_ptr(), n, w)
    return out


# ---------------------------------------------------------------------------
# Host (numpy canonical) implementation: challenger and host verifier
# ---------------------------------------------------------------------------

class Poseidon2Host:
    """Single-state permutation on canonical uint64 numpy arrays."""

    def __init__(self):
        self.begin_rc = BEGIN_RC.astype(np.uint64)
        self.partial_rc = PARTIAL_RC.astype(np.uint64)
        self.end_rc = END_RC.astype(np.uint64)
        self.diag = INTERNAL_DIAG.astype(np.uint64)

    @staticmethod
    def _sbox(x):
        x2 = (x * x) % P
        x3 = (x2 * x) % P
        return (x3 * x3 % P) * x % P

    @staticmethod
    def _external(state):
        s = state.reshape(4, 4).copy()
        x0, x1, x2, x3 = s[:, 0].copy(), s[:, 1].copy(), s[:, 2].copy(), s[:, 3].copy()
        t01 = (x0 + x1) % P
        t23 = (x2 + x3) % P
        t0123 = (t01 + t23) % P
        t01123 = (t0123 + x1) % P
        t01233 = (t0123 + x3) % P
        s[:, 3] = (t01233 + 2 * x0) % P
        s[:, 1] = (t01123 + 2 * x2) % P
        s[:, 0] = (t01123 + t01) % P
        s[:, 2] = (t01233 + t23) % P
        sums = s.sum(axis=0) % P
        s = (s + sums) % P
        return s.reshape(16)

    def permute(self, state: np.ndarray) -> np.ndarray:
        state = state.astype(np.uint64) % P
        state = self._external(state)
        for r in range(HALF_FULL_ROUNDS):
            state = (state + self.begin_rc[r]) % P
            state = self._sbox(state)
            state = self._external(state)
        for r in range(PARTIAL_ROUNDS):
            state[0] = self._sbox((state[0] + self.partial_rc[r]) % P)
            full = state.sum() % P
            state = (state * self.diag + full) % P
        for r in range(HALF_FULL_ROUNDS):
            state = (state + self.end_rc[r]) % P
            state = self._sbox(state)
            state = self._external(state)
        return state

    @staticmethod
    def _external_batch(states):
        """mds_light_permutation over (B, 16) canonical uint64."""
        s = states.reshape(-1, 4, 4).copy()
        x0, x1, x2, x3 = (s[:, :, i].copy() for i in range(4))
        t01 = (x0 + x1) % P
        t23 = (x2 + x3) % P
        t0123 = (t01 + t23) % P
        t01123 = (t0123 + x1) % P
        t01233 = (t0123 + x3) % P
        s[:, :, 3] = (t01233 + 2 * x0) % P
        s[:, :, 1] = (t01123 + 2 * x2) % P
        s[:, :, 0] = (t01123 + t01) % P
        s[:, :, 2] = (t01233 + t23) % P
        sums = s.sum(axis=1) % P  # (B, 4)
        s = (s + sums[:, None, :]) % P
        return s.reshape(-1, 16)

    def permute_batch(self, states: np.ndarray) -> np.ndarray:
        """Batched permutation over (B, 16) canonical uint64 arrays (the
        grind and the batched host verification)."""
        s = states.astype(np.uint64) % P
        s = self._external_batch(s)
        for r in range(HALF_FULL_ROUNDS):
            s = self._sbox((s + self.begin_rc[r]) % P)
            s = self._external_batch(s)
        for r in range(PARTIAL_ROUNDS):
            s[:, 0] = self._sbox((s[:, 0] + self.partial_rc[r]) % P)
            full = s.sum(axis=1) % P
            s = (s * self.diag + full[:, None]) % P
        for r in range(HALF_FULL_ROUNDS):
            s = self._sbox((s + self.end_rc[r]) % P)
            s = self._external_batch(s)
        return s
