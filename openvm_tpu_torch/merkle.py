"""Mixed-matrix Merkle commitment (MMCS) with Poseidon2.

Port of openvm_tpu/merkle.py, plonky3 ``MerkleTreeMmcs`` semantics:

  * leaf layer: rows of all TALLEST matrices concatenated, hashed with the
    overwrite-mode Poseidon2 sponge (rate 8) -> 8-element digests
  * each next layer: compress sibling digest pairs (truncated permutation);
    matrices whose height equals the layer size are "injected" by hashing
    their rows and compressing with the layer digest
  * commitment = root digest (8 BabyBear elements)

All matrix heights must be powers of two.  On CUDA the leaf and injected
row hashes run kernel K4 (poseidon2.hash_rows), every layer of more than
TAIL_MAX digests one launch of kernel K5 (``compress_layer``), and the
layers from TAIL_MAX digests to the root one launch of K5's tail
(``compress_tail``), as ``commit_plan`` lays out; the tree keeps every
digest layer for opening proofs.  Verification is host numpy, copied from
openvm_tpu/merkle.py:182-275.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from . import poseidon2 as p2
from .field import babybear as bb

DIGEST_LEN = p2.OUT
# Layers of at most TAIL_MAX output digests are compressed in one launch:
# the most that csrc/poseidon2.cu's tail cluster holds (TAIL_BLOCKS *
# TAIL_GROUPS states), and the fastest tail measured.
TAIL_MAX = 512


@dataclass
class MerkleTree:
    """Committed forest over matrices of mixed power-of-two heights."""

    matrices: list  # (N_i, W_i) int32 Montgomery tensors, input order
    digest_layers: list  # [(H, 8), (H/2, 8), ..., (1, 8)] int32 tensors
    root: np.ndarray  # (8,) canonical uint64 (transcript form)

    def max_height(self) -> int:
        return int(self.digest_layers[0].shape[0])


def compress_layer_plain(prev: torch.Tensor, injected=None) -> torch.Tensor:
    """One tree layer, plain PyTorch: (2H, 8) [+ (H, 8)] -> (H, 8)."""
    nxt = p2.compress_pairs(prev[0::2], prev[1::2])
    return nxt if injected is None else p2.compress_pairs(nxt, injected)


def compress_layer(prev: torch.Tensor, injected=None) -> torch.Tensor:
    """One tree layer: compress prev[0::2] || prev[1::2], then, when
    ``injected`` (the row digests of the matrices of this height) is given,
    compress the result with it.  (2H, 8) [+ (H, 8)] -> (H, 8).

    Kernel K5 on CUDA (csrc/poseidon2.cu), replacing compress_pairs
    (openvm_tpu/poseidon2.py:230) as commit_layers (merkle.py:49) calls it:
    one thread per output digest, both permutations in registers, its
    digests read as 16-byte vectors; bound by integer operations."""
    operands = (prev,) if injected is None else (prev, injected)
    dev = _build.kernel_device(*operands)
    if dev.type == "cpu":
        return compress_layer_plain(prev, injected)
    if prev.dim() != 2 or prev.shape[1] != DIGEST_LEN or prev.shape[0] % 2:
        raise ValueError(f"compress_layer takes (2H, 8), got {tuple(prev.shape)}")
    h = prev.shape[0] // 2
    _build.check_words(prev, "compress_layer prev", dev)
    if injected is not None:
        _build.check_words(injected, "compress_layer injected", dev)
        if tuple(injected.shape) != (h, DIGEST_LEN):
            raise ValueError(f"injected digests must be ({h}, 8), got "
                             f"{tuple(injected.shape)}")
    out = torch.empty((h, DIGEST_LEN), dtype=torch.int32, device=dev)
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError("compress_layer operands must be 16-byte aligned")
    if h:
        p2.upload_constants(dev)
        _build.launch("poseidon2_compress_layer", "ovt_poseidon2_compress_layer",
                      dev, prev.data_ptr(),
                      None if injected is None else injected.data_ptr(),
                      out.data_ptr(), h)
    return out


def compress_tail_plain(prev: torch.Tensor, injected: list) -> list:
    """Layers of 2H -> H -> ... -> 1 digests, plain PyTorch, layer by layer;
    ``injected[t]`` the row digests compressed in at layer t, or None."""
    layers = []
    for inj in injected:
        prev = compress_layer_plain(prev, inj)
        layers.append(prev)
    return layers


def compress_tail(prev: torch.Tensor, injected: list) -> list:
    """Every layer from ``prev`` (2H digests, H a power of two of at most
    TAIL_MAX) to the root: H, H/2, ..., 1 digests, the row digests
    ``injected[t]`` (H >> t, 8) compressed in at layer t where given.

    K5's tail on CUDA (csrc/poseidon2.cu): one launch of one cluster of 8
    blocks, four threads a state so that a permutation's dependent chain is
    short, the layers passed on through distributed shared memory and all
    written out.  Bound by the latency of its permutations' chains, not by
    the card's rate."""
    operands = (prev,) + tuple(i for i in injected if i is not None)
    dev = _build.kernel_device(*operands)
    if dev.type == "cpu":
        return compress_tail_plain(prev, injected)
    n = len(injected)
    h0 = prev.shape[0] // 2
    if (prev.dim() != 2 or prev.shape[1] != DIGEST_LEN or n < 1
            or h0 != 1 << (n - 1) or h0 > TAIL_MAX):
        raise ValueError(f"compress_tail takes (2^n, 8) with n layers of at most "
                         f"{TAIL_MAX} digests, got {tuple(prev.shape)} and "
                         f"{n} layers")
    _build.check_words(prev, "compress_tail prev", dev)
    outs = [torch.empty((h0 >> t, DIGEST_LEN), dtype=torch.int32, device=dev)
            for t in range(n)]
    for t, inj in enumerate(injected):
        if inj is not None:
            _build.check_words(inj, "compress_tail injected", dev)
            if tuple(inj.shape) != (h0 >> t, DIGEST_LEN):
                raise ValueError(f"injected digests at layer {t} must be "
                                 f"({h0 >> t}, 8), got {tuple(inj.shape)}")
    for t in operands + tuple(outs):
        if t.data_ptr() % 16:
            raise ValueError("compress_tail operands must be 16-byte aligned")
    p2.upload_constants(dev)
    inj_ptrs = (ctypes.c_void_p * n)(*[None if i is None else i.data_ptr()
                                       for i in injected])
    out_ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    _build.launch("poseidon2_compress_tail", "ovt_poseidon2_compress_tail", dev,
                  prev.data_ptr(), inj_ptrs, out_ptrs, n, h0)
    return outs


def commit_plan(max_h: int, tail_max: int) -> tuple:
    """The compress launches of a tree whose leaf layer has ``max_h``
    digests: (single, tail), the output heights of the layers compressed
    one launch each, then those compressed in one tail launch (every layer
    of at most ``tail_max`` digests)."""
    if tail_max < 1 or tail_max & (tail_max - 1) or tail_max > TAIL_MAX:
        raise ValueError(f"tail_max must be a power of two up to {TAIL_MAX}")
    outs = []
    h = max_h
    while h > 1:
        h //= 2
        outs.append(h)
    return [h for h in outs if h > tail_max], [h for h in outs if h <= tail_max]


def _commit_layers(matrices, hash_rows, compress, tail=None,
                   tail_max: int = TAIL_MAX) -> list:
    if not matrices:
        raise ValueError("cannot commit to zero matrices")
    by_height: dict[int, list] = {}
    for m in matrices:
        h = int(m.shape[0])
        if h < 1 or h & (h - 1):
            raise ValueError("matrix heights must be powers of two")
        by_height.setdefault(h, []).append(m)

    def hash_height(h):
        if h not in by_height:
            return None
        mats = by_height[h]
        joined = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
        return hash_rows(joined.contiguous())

    max_h = max(by_height)
    layers = [hash_height(max_h)]
    single, rest = commit_plan(max_h, tail_max)
    if tail is None:
        single, rest = single + rest, []
    for h in single:
        layers.append(compress(layers[-1], hash_height(h)))
    if rest:
        layers += tail(layers[-1], [hash_height(h) for h in rest])
    return layers


def commit_layers(matrices, tail_max: int = TAIL_MAX) -> list:
    """All digest layers of the tree over ``matrices`` (leaf layer first):
    K4 for the leaves and the injected rows, K5 a launch for each layer of
    more than ``tail_max`` digests, K5's tail for the rest."""
    return _commit_layers(matrices, p2.hash_rows, compress_layer,
                          compress_tail, tail_max)


def commit_layers_plain(matrices) -> list:
    """``commit_layers`` through the plain PyTorch versions, any device,
    layer by layer."""
    return _commit_layers(matrices, p2.hash_rows_plain, compress_layer_plain)


def commit(matrices) -> MerkleTree:
    """Build the Merkle tree over the given matrices (Montgomery form)."""
    layers = commit_layers(list(matrices))
    return MerkleTree(matrices=list(matrices), digest_layers=layers,
                      root=bb.canonical_np(layers[-1][0]))


def open_row(tree: MerkleTree, index: int):
    """Open all matrices at `index` (of the tallest height).

    Returns (opened_rows, proof): opened_rows[i] is matrix i's row at
    index >> (log_max - log_h_i) as canonical uint64; proof is the list of
    sibling digests from the leaf layer upward, canonical uint64 (8,) each.
    """
    log_max = tree.max_height().bit_length() - 1
    opened = []
    for m in tree.matrices:
        log_h = int(m.shape[0]).bit_length() - 1
        opened.append(bb.canonical_np(m[index >> (log_max - log_h)]))
    proof = []
    idx = index
    for layer in tree.digest_layers[:-1]:
        proof.append(bb.canonical_np(layer[idx ^ 1]))
        idx >>= 1
    return opened, proof


# ---------------------------------------------------------------------------
# Batched gathers at query indices (kernel K6)
# ---------------------------------------------------------------------------

# K6's job table (csrc/gather.cu GJ_*): a job's int64 words.
GJ_PTR, GJ_STRIDE, GJ_WIDTH, GJ_SHIFT, GJ_FLIP, GJ_OUT, GJ_VEC, GJ_ROW_UNITS = range(8)
GJ_WORDS = 8
GATHER_THREADS = 256  # threads a block of csrc/gather.cu


class GatherPlan:
    """The gathers of a batched opening, run as one launch of kernel K6
    (csrc/gather.cu) and brought to the host in one copy.

    A job reads row ``(index >> shift) ^ flip`` of one (H, W) matrix for
    every query index, in canonical form.  ``run`` returns one (Q, W)
    uint32 array per job, in the order the jobs were added.  Every job's
    matrix lies on one device."""

    def __init__(self):
        self.jobs: list = []  # (matrix, shift, flip)
        self.device = None
        # [width, jobs] of consecutive jobs of one width: ``run`` splits the
        # output into one view a run, not one a job
        self._runs: list = []

    def add(self, matrix: torch.Tensor, shift: int, flip: int = 0) -> int:
        if matrix.dim() != 2:
            raise ValueError(f"gather source must be (H, W), got {tuple(matrix.shape)}")
        if matrix.device != self.device:
            if self.device is not None:
                raise ValueError(f"gather sources on {self.device} and {matrix.device}")
            self.device = _build.kernel_device(matrix)
        self.jobs.append((matrix, int(shift), int(flip)))
        w = int(matrix.shape[1])
        if self._runs and self._runs[-1][0] == w:
            self._runs[-1][1] += 1
        else:
            self._runs.append([w, 1])
        return len(self.jobs) - 1

    def add_tree(self, tree: MerkleTree, shift: int = 0, rows: bool = True):
        """The jobs of ``open_row`` at index >> shift for every index: each
        matrix's row (when ``rows``) and the sibling digest of every layer
        below the root.  Returns (row job ids, sibling job ids)."""
        log_max = tree.max_height().bit_length() - 1
        mats = [self.add(m, shift + log_max - (int(m.shape[0]).bit_length() - 1))
                for m in tree.matrices] if rows else []
        sibs = [self.add(layer, shift + k, 1)
                for k, layer in enumerate(tree.digest_layers[:-1])]
        return mats, sibs

    def table(self, indices) -> tuple:
        """K6's inputs for these query indices, with numpy: the job table
        (one ``GJ_WORDS`` row a job that has output, in job order), each
        such job's first unit and the total units after them, each block's
        first job (blocks of ``GATHER_THREADS`` units), the query indices
        and the output's words.  A job's units are 16 bytes where its
        width, row stride, address and offset are multiples of 16 bytes,
        else 4.  Raises on a source the kernel does not take and on a row
        outside its matrix."""
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        q = len(idx)
        meta = []  # a flat list into np.fromiter: the cheapest walk of the jobs
        for m, s, f in self.jobs:
            meta += (m.data_ptr(), *m.stride(), *m.shape, s, f, m.dtype == torch.int32)
        meta = np.fromiter(meta, np.int64, len(meta)).reshape(-1, 8)
        ptr, stride, col_stride, height, width, shift, flip, int32 = meta.T
        offs = np.zeros(len(meta) + 1, dtype=np.int64)
        np.cumsum(q * width, out=offs[1:])
        vec = ((width % 4 == 0) & (stride % 4 == 0) & (ptr % 16 == 0)
               & (offs[:-1] % 4 == 0))
        step = np.where(vec, 4, 1)
        live = (width > 0) & (q > 0)
        if ((col_stride != 1) & (width > 1))[live].any() or not int32[live].all():
            raise ValueError("gather sources must be int32 with unit column stride")
        if live.any():
            if idx.min() < 0:
                raise ValueError("query indices must be non-negative")
            # (y ^ f) <= (y_max | f) for a flip of 0 or 1; any other job
            # is checked row by row
            hi = ((idx.max() >> shift) | flip) >= height
            slow = live & (hi | (flip > 1))
            rows = (idx[None, :] >> shift[slow, None]) ^ flip[slow, None]
            if (rows.max(axis=1, initial=0) >= height[slow]).any():
                raise ValueError("a query index reads past a gather source's rows")
        tab = np.stack([ptr, stride, width, shift, flip, offs[:-1], step,
                        width // step], axis=1)[live]
        first = np.zeros(len(tab) + 1, dtype=np.int64)
        np.cumsum(q * tab[:, GJ_ROW_UNITS], out=first[1:])
        if first[-1] >= 1 << 31:
            raise ValueError("a gather of 2^31 units or more")
        starts = np.arange(0, first[-1], GATHER_THREADS, dtype=np.int64)
        block_job = np.searchsorted(first[:-1], starts, side="right") - 1
        return tab, first, block_job, idx, int(offs[-1])

    def run_plain(self, indices) -> torch.Tensor:
        """Every job's (Q, W) block of canonical words, flattened in job
        order, through plain PyTorch on the matrices' device."""
        if not self.jobs:
            return torch.zeros(0, dtype=torch.int32)
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64), device=self.device)
        return torch.cat([bb.from_monty_plain(m[(idx >> s) ^ f]).reshape(-1)
                          for m, s, f in self.jobs])

    def run_device(self, indices) -> torch.Tensor:
        """``run_plain``'s result: kernel K6 on CUDA matrices, the plain
        version on CPU ones.  On CUDA the job table, the jobs' first units
        and the indices go up in one non-blocking copy from pinned memory
        and one launch covers the whole output."""
        if not self.jobs:
            return torch.zeros(0, dtype=torch.int32)
        dev = self.device
        if dev.type == "cpu":
            return self.run_plain(indices)
        tab, first, block_job, idx, total = self.table(indices)
        out = torch.empty(total, dtype=torch.int32, device=dev)
        if len(tab):
            buf, offs = _build.upload([tab, first, block_job, idx], dev)
            base = buf.data_ptr()
            _build.launch("gather", "ovt_gather", dev, base + offs[0], base + offs[1],
                          base + offs[2], len(tab), base + offs[3], int(first[-1]),
                          out.data_ptr())
            # the caching allocator holds buf's block for the stream's later
            # work, so it outlives the launch
        return out

    def run(self, indices) -> list:
        """One launch, one copy to the host (pinned, non-blocking, one wait
        on the stream): per job a (Q, W) uint32 array of canonical words,
        views of one host buffer, as the reference's gathers hold them."""
        if not self.jobs:
            return []
        q = len(indices)
        flat = self.run_device(indices)
        if flat.device.type == "cuda":
            host = torch.empty(flat.shape, dtype=torch.int32, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            torch.cuda.current_stream(flat.device).synchronize()
            flat = host
        words = flat.numpy().view(np.uint32)
        out, o = [], 0
        for w, k in self._runs:
            out.extend(words[o:o + k * q * w].reshape(k, q, w))
            o += k * q * w
        return out


def _find_job(first: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              g: np.ndarray) -> np.ndarray:
    """csrc/gather.cu find_job for every unit g: the last j in [lo, hi) with
    first[j] <= g, by bisection."""
    lo, hi = lo.copy(), hi.copy()
    while True:
        act = hi - lo > 1
        if not act.any():
            return lo
        mid = (lo + hi) >> 1
        left = first[np.where(act, mid, lo)] <= g
        lo = np.where(act & left, mid, lo)
        hi = np.where(act & ~left, mid, hi)


def _gather_model(plan: GatherPlan, indices, threads: int = GATHER_THREADS) -> torch.Tensor:
    """gather_kernel modelled on the CPU in int64 over the plan's own table
    and blocks of ``threads`` units (the kernel's ``GATHER_THREADS``, or
    fewer to spread blocks across many jobs): each block's first job by a
    search over the jobs' first units, one thread a unit, its job by a
    search between its block's first job and the next block's, its (query,
    unit) in the job's rows, the row (index >> shift) ^ flip, and 4 words
    where the unit is 16 bytes (its source and output addresses asserted on
    16-byte boundaries) or 1; returns ``run_plain``'s flat result."""
    tab, first, _, idx, total = plan.table(indices)
    # the table's rows are the jobs with output, in job order
    mats = [m for m, _, _ in plan.jobs if m.shape[1] and len(idx)]
    assert [m.data_ptr() for m in mats] == tab[:, GJ_PTR].tolist()
    out = np.zeros(total, dtype=np.int64)
    n, units = len(tab), int(first[-1])
    block_job = np.searchsorted(first[:-1], np.arange(0, units, threads), side="right") - 1
    g = np.arange(units, dtype=np.int64)
    blk = g // threads
    j0 = block_job[blk]
    j1 = np.where(blk + 1 < len(block_job),
                  block_job[np.minimum(blk + 1, len(block_job) - 1)] + 1, n)
    j = _find_job(first, j0, j1, g)
    job = tab[j]
    u = g - first[j]
    qi = u // job[:, GJ_ROW_UNITS]
    c = u - qi * job[:, GJ_ROW_UNITS]
    row = (idx[qi] >> job[:, GJ_SHIFT]) ^ job[:, GJ_FLIP]
    col = c * job[:, GJ_VEC]
    dst = job[:, GJ_OUT] + qi * job[:, GJ_WIDTH] + col
    for k in np.unique(j):
        sel = j == k
        m = mats[k]
        step = int(tab[k, GJ_VEC])
        if step == 4:
            src = m.data_ptr() + (row[sel] * int(tab[k, GJ_STRIDE]) + col[sel]) * 4
            assert (src % 16 == 0).all() and (dst[sel] % 4 == 0).all()
        r, cc, d = row[sel], col[sel], dst[sel]
        for t in range(step):
            words = m[torch.from_numpy(r), torch.from_numpy(cc + t)]
            out[d + t] = bb.from_monty_plain(words).long().numpy()
    return torch.from_numpy(out).int()


def gather_rows_device(tree: MerkleTree, indices) -> dict:
    """All matrix rows and path sibling digests at ``indices``, canonical,
    as openvm_tpu/merkle.py:118 gathers them: one K6 launch and one copy to
    the host.  Returns {"mats": [(Q, w)], "sibs": [(Q, 8)]} uint32 arrays."""
    plan = GatherPlan()
    mats, sibs = plan.add_tree(tree)
    blocks = plan.run(indices)
    return {"mats": [blocks[k] for k in mats], "sibs": [blocks[k] for k in sibs]}


def format_gathered_rows(gathered, q: int):
    """[(opened_rows, proof)] per query from ``gather_rows_device``'s result,
    formats matching ``open_row`` (openvm_tpu/merkle.py:158)."""
    out = []
    for k in range(q):
        opened = [np.asarray(rows[k], dtype=np.uint64)
                  for rows in gathered["mats"]]
        proof = [np.asarray(s[k], dtype=np.uint64)
                 for s in gathered["sibs"]]
        out.append((opened, proof))
    return out


# ---------------------------------------------------------------------------
# Host verification (numpy canonical)
# ---------------------------------------------------------------------------

def verify_batch_queries(root: np.ndarray, dims, indices,
                         opened_rows_q, proofs_q) -> np.ndarray:
    """Vectorized `verify_batch` over a query axis.

    indices: (Q,) int array; opened_rows_q: per matrix an (Q, w) canonical
    uint64 array; proofs_q: per path level an (Q, 8) canonical uint64 array.
    Returns (Q,) bool, the same as Q scalar `verify_batch` calls.
    """
    host = p2.Poseidon2Host()
    q = len(indices)
    idx = np.asarray(indices, dtype=np.int64)

    def hash_rows_q(rows_list):
        flat = np.concatenate([np.asarray(r, dtype=np.uint64) % p2.P
                               for r in rows_list], axis=1)  # (Q, sum_w)
        state = np.zeros((q, p2.WIDTH), dtype=np.uint64)
        for c0 in range(0, flat.shape[1], p2.RATE):
            chunk = flat[:, c0:c0 + p2.RATE]
            k = chunk.shape[1]
            state = np.concatenate([chunk, state[:, k:]], axis=1)
            state = host.permute_batch(state)
        return state[:, :DIGEST_LEN].copy()

    def compress_q(a, b):
        return host.permute_batch(
            np.concatenate([a, b], axis=1))[:, :DIGEST_LEN].copy()

    heights = [h for (h, _) in dims]
    max_h = max(heights)
    by_height: dict[int, list] = {}
    for (h, _), rows in zip(dims, opened_rows_q):
        by_height.setdefault(h, []).append(rows)

    digest = hash_rows_q(by_height[max_h])
    size = max_h
    for sib in proofs_q:
        sib = np.asarray(sib, dtype=np.uint64)
        bit = (idx & 1)[:, None] == 1
        left = np.where(bit, sib, digest)
        right = np.where(bit, digest, sib)
        digest = compress_q(left, right)
        idx >>= 1
        size //= 2
        if size in by_height:
            digest = compress_q(digest, hash_rows_q(by_height[size]))
    return np.all(digest == np.asarray(root, dtype=np.uint64)[None, :],
                  axis=1)


def verify_batch(root: np.ndarray, dims, index: int, opened_rows, proof) -> bool:
    """Host-side verification of an opened batch (canonical uint64 arrays).

    dims: list of (height, width) per matrix, same order as opened_rows.
    Mirrors the recursive verifier's `verify_batch` semantics.
    """
    host = p2.Poseidon2Host()

    def hash_row_concat(rows):
        flat = np.concatenate([np.asarray(r, dtype=np.uint64) for r in rows])
        state = np.zeros(16, dtype=np.uint64)
        for c0 in range(0, len(flat), p2.RATE):
            chunk = flat[c0:c0 + p2.RATE]
            state[:len(chunk)] = chunk
            state = host.permute(state)
        return state[:DIGEST_LEN].copy()

    def compress(a, b):
        return host.permute(np.concatenate([a, b]))[:DIGEST_LEN].copy()

    heights = [h for (h, _) in dims]
    max_h = max(heights)

    by_height: dict[int, list] = {}
    for (h, _), row in zip(dims, opened_rows):
        by_height.setdefault(h, []).append(row)

    digest = hash_row_concat(by_height[max_h])
    idx = index
    size = max_h
    for sib in proof:
        bit = idx & 1
        idx >>= 1
        if bit:
            digest = compress(sib, digest)
        else:
            digest = compress(digest, sib)
        size //= 2
        if size in by_height:
            digest = compress(digest, hash_row_concat(by_height[size]))
    return bool(np.array_equal(digest, np.asarray(root, dtype=np.uint64)))
