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


PLONKY3_DIAG = np.array([
    P - 2, 1, 2, _frac(1, 2), 3, 4, _frac(-1, 2), P - 3, P - 4,
    _frac(1, 1 << 8), _frac(1, 4), _frac(1, 8), _frac(1, 1 << 27),
    _frac(-1, 1 << 8), _frac(-1, 16), _frac(-1, 1 << 27),
], dtype=np.uint64)
PLONKY3_DIAG.setflags(write=False)
INTERNAL_DIAG = PLONKY3_DIAG.copy()


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
    """Round constants as uint32 Montgomery words."""
    return (bb.to_monty_np(BEGIN_RC), bb.to_monty_np(PARTIAL_RC),
            bb.to_monty_np(END_RC))


@functools.lru_cache(maxsize=8)
def _plain_constants(version: int, device: torch.device):
    """Round constants and diagonal as canonical int64 values (the plain
    version computes on canonical values)."""
    return tuple(torch.from_numpy(np.asarray(a, dtype=np.uint64).astype(np.int64) % P)
                 .to(device) for a in (BEGIN_RC, PARTIAL_RC, END_RC, INTERNAL_DIAG))


def upload_constants(device: torch.device) -> None:
    """Copy the current round constants into the kernels' __constant__
    memory on ``device`` unless it already holds them.  The kernels build the
    internal diagonal into their code (csrc/poseidon2.cu partial_round), so
    the diagonal must still be plonky3's."""
    if not np.array_equal(INTERNAL_DIAG, PLONKY3_DIAG):
        raise ValueError("the Poseidon2 kernels compute with plonky3's BabyBear "
                         "internal diagonal; INTERNAL_DIAG differs from it")
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


def _monty_reduce64(y):
    """csrc/babybear.cuh monty_reduce in int64: y 2^-32 mod p for 0 <= y <
    p 2^32, with m p split as m + 15 m 2^27 so that no sum passes 2^63."""
    lo = y & 0xFFFFFFFF
    m = (lo * bb.NPRIME) & 0xFFFFFFFF
    t = (y >> 32) + ((lo + m + ((15 * m) << 27)) >> 32)
    return torch.where(t >= P, t - P, t)


def _reduce_sum64(v):
    """csrc/poseidon2.cu reduce_sum in int64: v mod p for 0 <= v < 16p by
    2^31 = 2^27 - 1 (mod p) and two conditional subtractions."""
    v = (v & 0x7FFFFFFF) + (v >> 31) * ((1 << 27) - 1)
    v = torch.where(v >= P, v - P, v)
    return torch.where(v >= P, v - P, v)


def _diag_layer64(s, total):
    """diag * s + total on canonical (..., 16) lanes, as csrc/poseidon2.cu's
    partial_round computes it: +-1..4 as additions, 2^-k as one Montgomery
    reduction of s << (32 - k) (plonky3's diagonal, PLONKY3_DIAG)."""
    x = [s[..., i] for i in range(WIDTH)]

    def add(a, b):
        return (a + b) % P

    def sub(a, b):
        return (a - b) % P

    def div(a, k):
        return _monty_reduce64(a << (32 - k))

    def dbl(a):
        return add(a, a)

    lanes = [sub(total, dbl(x[0])), add(total, x[1]), add(total, dbl(x[2])),
             add(total, div(x[3], 1)), add(total, add(dbl(x[4]), x[4])),
             add(total, dbl(dbl(x[5]))), sub(total, div(x[6], 1)),
             sub(total, add(dbl(x[7]), x[7])), sub(total, dbl(dbl(x[8]))),
             add(total, div(x[9], 8)), add(total, div(x[10], 2)),
             add(total, div(x[11], 3)), add(total, div(x[12], 27)),
             sub(total, div(x[13], 8)), sub(total, div(x[14], 4)),
             sub(total, div(x[15], 27))]
    return torch.stack(lanes, dim=-1)


# From this many states on, the plain permutation keeps each lane in its own
# contiguous tensor (``_permute_lanes``): 16 times the operations, each on a
# contiguous column, which pays once a batch is large.  Below it the
# (..., 16) form is faster: on one thread of a Xeon, ``python -m
# openvm_tpu_torch.plain_timing`` measured it 3.7x faster for one state
# (the memory tree's hashes) and 1.2x faster at 2,048 states, and the lane
# form 1.13x faster at 4,096 and 1.35x at 2^17.
LANE_MAJOR_STATES = 4096


def _sbox_lane(x):
    """x^7 of a canonical int64 lane, computed in place."""
    x2 = x * x
    x2.remainder_(P)
    x3 = x2.mul_(x).remainder_(P)
    return x3.mul_(x3).remainder_(P).mul_(x).remainder_(P)


def _external_lanes(lanes: list) -> list:
    """``_external_linear`` on 16 lane tensors (below p in and out)."""
    out = [None] * WIDTH
    for b in range(4):
        x0, x1, x2, x3 = lanes[4 * b:4 * b + 4]
        t01, t23 = x0 + x1, x2 + x3
        t0123 = t01 + t23
        t01123, t01233 = t0123 + x1, t0123 + x3
        out[4 * b] = t01123 + t01
        out[4 * b + 2] = t01233 + t23
        out[4 * b + 1] = t01123.add_(x2).add_(x2)
        out[4 * b + 3] = t01233.add_(x0).add_(x0)
    sums = [out[k] + out[4 + k] + out[8 + k] + out[12 + k] for k in range(4)]
    return [x.add_(sums[i % 4]).remainder_(P) for i, x in enumerate(out)]


def _permute_lanes(s, consts):
    """``_permute64`` with each lane a contiguous tensor (general diagonal
    products): the same values."""
    begin, partial, end, diag = (c.tolist() for c in consts)
    lanes = _external_lanes([x.contiguous() for x in s.unbind(-1)])
    for r in range(HALF_FULL_ROUNDS):
        lanes = _external_lanes([_sbox_lane((x + begin[r][i]).remainder_(P))
                                 for i, x in enumerate(lanes)])
    for r in range(PARTIAL_ROUNDS):
        x0 = _sbox_lane((lanes[0] + partial[r]).remainder_(P))
        total = x0.clone()
        for x in lanes[1:]:
            total += x
        lanes = [x.mul_(diag[i]).add_(total).remainder_(P)
                 for i, x in enumerate([x0] + lanes[1:])]
    for r in range(HALF_FULL_ROUNDS):
        lanes = _external_lanes([_sbox_lane((x + end[r][i]).remainder_(P))
                                 for i, x in enumerate(lanes)])
    return torch.stack(lanes, dim=-1)


def _permute64(s, consts, structured_diag: bool = False):
    """Poseidon2 on canonical int64 values (..., 16).  ``structured_diag``
    computes the internal layer as the kernels do (``_diag_layer64``, lane
    sum by ``_reduce_sum64``) instead of by general products."""
    if not structured_diag and s[..., 0].numel() >= LANE_MAJOR_STATES:
        return _permute_lanes(s, consts)
    begin, partial, end, diag = consts
    s = _external_linear(s)
    for r in range(HALF_FULL_ROUNDS):
        s = _external_linear(_sbox((s + begin[r]) % P))
    for r in range(PARTIAL_ROUNDS):
        # lane 0 through the S-box, then diag * s + sum(s) on every lane
        x0 = _sbox((s[..., 0] + partial[r]) % P)
        total = s[..., 1:].sum(dim=-1).add_(x0)
        if structured_diag:
            s = s.clone()
            s[..., 0] = x0
            s = _diag_layer64(s, _reduce_sum64(total))
            continue
        s = s * diag
        s[..., 0] = x0 * diag[0]
        s.add_(total[..., None]).remainder_(P)
    for r in range(HALF_FULL_ROUNDS):
        s = _external_linear(_sbox((s + end[r]) % P))
    return s


def _permute_quad64(words: torch.Tensor) -> torch.Tensor:
    """csrc/poseidon2.cu's four-thread permutation (K5's tail) on Montgomery
    int64 words (..., 16), modelled: axis -2 is the thread q of a group,
    axis -1 its lanes 4q..4q+3 (M4 block q).  Every step is the kernel's:
    the external layer's block sums and a partial round's lane sum as the
    two xor-shuffles form them (modular adds, a thread's four lanes summed
    in 64 bits and reduced once), lane 0's S-box kept by thread 0, the
    diagonal as Montgomery products by its entries' Montgomery forms."""
    begin, partial, end = (torch.from_numpy(a.astype(np.int64)).to(words.device)
                           for a in _monty_constants())
    diag = torch.from_numpy(bb.to_monty_np(PLONKY3_DIAG).astype(np.int64)
                            ).to(words.device).reshape(4, 4)

    def add(a, b):
        return (a + b) % P

    def mul(a, b):
        return a * b % P * bb.RINV_MOD_P % P

    def sbox(v):
        v3 = mul(mul(v, v), v)
        return mul(mul(v3, v3), v)

    def shfl_xor(v, m):  # thread q reads thread q ^ m's value
        return v[..., [q ^ m for q in range(4)], :]

    def group_sum(v):
        v = add(v, shfl_xor(v, 1))
        return add(v, shfl_xor(v, 2))

    def external(x):
        x0, x1, x2, x3 = x.unbind(-1)
        t01, t23 = add(x0, x1), add(x2, x3)
        t0123 = add(t01, t23)
        t01123, t01233 = add(t0123, x1), add(t0123, x3)
        x = torch.stack([add(t01123, t01), add(t01123, add(x2, x2)),
                         add(t01233, t23), add(t01233, add(x0, x0))], dim=-1)
        return add(x, group_sum(x))

    x = external(words.reshape(words.shape[:-1] + (4, 4)))
    for r in range(HALF_FULL_ROUNDS):
        x = external(sbox(add(x, begin[r].reshape(4, 4))))
    for r in range(PARTIAL_ROUNDS):
        x0 = sbox(add(x[..., 0], partial[r]))  # every thread computes it
        x = x.clone()
        x[..., 0, 0] = x0[..., 0]  # thread 0 keeps it
        part = _reduce_sum64((x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3]))
        x = add(group_sum(part[..., None]), mul(x, diag))
    for r in range(HALF_FULL_ROUNDS):
        x = external(sbox(add(x, end[r].reshape(4, 4))))
    return x.reshape(words.shape)


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
    operations; a block's rows load through shared memory."""
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
