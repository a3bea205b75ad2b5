"""Mixed-matrix Merkle commitment (MMCS) with Poseidon2.

Port of openvm_tpu/merkle.py, plonky3 ``MerkleTreeMmcs`` semantics:

  * leaf layer: rows of all TALLEST matrices concatenated, hashed with the
    overwrite-mode Poseidon2 sponge (rate 8) -> 8-element digests
  * each next layer: compress sibling digest pairs (truncated permutation);
    matrices whose height equals the layer size are "injected" by hashing
    their rows and compressing with the layer digest
  * commitment = root digest (8 BabyBear elements)

All matrix heights must be powers of two.  On CUDA the leaf and injected
row hashes run kernel K4 (poseidon2.hash_rows) and every layer one launch of
kernel K5 (``compress_layer``); the tree keeps every digest layer for
opening proofs.  Verification is host numpy, copied from
openvm_tpu/merkle.py:182-275.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build
from . import poseidon2 as p2
from .field import babybear as bb

DIGEST_LEN = p2.OUT


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
    one thread per output digest, both permutations in registers, bound by
    integer operations."""
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
    if h:
        p2.upload_constants(dev)
        _build.launch("poseidon2_compress_layer", "ovt_poseidon2_compress_layer",
                      dev, prev.data_ptr(),
                      None if injected is None else injected.data_ptr(),
                      out.data_ptr(), h)
    return out


def _commit_layers(matrices, hash_rows, compress) -> list:
    if not matrices:
        raise ValueError("cannot commit to zero matrices")
    by_height: dict[int, list] = {}
    for m in matrices:
        h = int(m.shape[0])
        if h < 1 or h & (h - 1):
            raise ValueError("matrix heights must be powers of two")
        by_height.setdefault(h, []).append(m)

    def hash_height(h):
        mats = by_height[h]
        joined = mats[0] if len(mats) == 1 else torch.cat(mats, dim=1)
        return hash_rows(joined.contiguous())

    max_h = max(by_height)
    layers = [hash_height(max_h)]
    size = max_h
    while size > 1:
        size //= 2
        injected = hash_height(size) if size in by_height else None
        layers.append(compress(layers[-1], injected))
    return layers


def commit_layers(matrices) -> list:
    """All digest layers of the tree over ``matrices`` (leaf layer first)."""
    return _commit_layers(matrices, p2.hash_rows, compress_layer)


def commit_layers_plain(matrices) -> list:
    """``commit_layers`` through the plain PyTorch versions, any device."""
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
