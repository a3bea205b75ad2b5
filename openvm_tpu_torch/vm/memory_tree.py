"""Sparse Poseidon2 Merkle tree over guest memory (host side).

Copy of openvm_tpu/vm/memory_tree.py:1-147 (``compress``, ``hash_leaf``,
``zero_digest``, ``leaf_index``, ``SparseMemoryTree``, ``verify_leaf``,
``pv_proof``, ``verify_pv_proof``) on the port's ``poseidon2.Poseidon2Host``.
It re-designs the reference's persistent-memory commitment (reference
crates/vm/src/system/memory/merkle/{mod.rs, tree.rs} and
merkle/public_values.rs ``UserPublicValuesProof``): memory is committed as a
Poseidon2 Merkle root so continuation segments can chain
(initial_root, final_root) through public values.

Layout (word-granular, matching this framework's memory argument): one
unified tree of depth 28 whose leaves are 8 byte-cells (2 words); the global
leaf index is (address_space - 1) * 2^26 + word_addr // 2 for address spaces
1..4.  Untouched subtrees hash to memoized all-zero digests.  ``_levels``
rebuilds every touched level at each call: O(touched * depth) host work per
``root()`` or merkle trace.

This is the host oracle; the in-circuit MemoryMerkleAir
(vm/circuit/merkle_chip.py) proves touched-path updates between roots.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import poseidon2 as p2

P = 2013265921

LEAF_WORDS = 2           # 8 byte-cells per leaf
AS_LEAF_HEIGHT = 26      # leaves per address space (2^27 words / 2)
NUM_AS_BITS = 2          # address spaces 1..4
TREE_HEIGHT = AS_LEAF_HEIGHT + NUM_AS_BITS  # 28


@functools.lru_cache(maxsize=None)
def _host():
    return p2.Poseidon2Host()


def compress(left, right) -> tuple:
    state = np.zeros(16, dtype=np.uint64)
    state[:8] = left
    state[8:] = right
    return tuple(int(x) for x in _host().permute(state)[:8])


def hash_leaf(cells8) -> tuple:
    state = np.zeros(16, dtype=np.uint64)
    state[:8] = np.asarray(cells8, dtype=np.uint64)
    return tuple(int(x) for x in _host().permute(state)[:8])


@functools.lru_cache(maxsize=None)
def zero_digest(level: int) -> tuple:
    """Digest of an all-zero subtree with 2^level leaves."""
    if level == 0:
        return hash_leaf(np.zeros(8, dtype=np.uint64))
    child = zero_digest(level - 1)
    return compress(child, child)


def leaf_index(a_s: int, wa: int) -> int:
    assert 1 <= a_s <= 4
    return ((a_s - 1) << AS_LEAF_HEIGHT) | (wa // LEAF_WORDS)


class SparseMemoryTree:
    """Sparse Merkle commitment of {(as, word_addr): [4 bytes]} memory."""

    def __init__(self, words: dict | None = None):
        self.leaves: dict = {}  # global leaf idx -> np.array(8) cells
        if words:
            for (a_s, wa), data in words.items():
                self.write_word(a_s, wa, data)

    def write_word(self, a_s: int, wa: int, data) -> None:
        li = leaf_index(a_s, wa)
        leaf = self.leaves.setdefault(li, np.zeros(8, dtype=np.uint64))
        off = (wa % LEAF_WORDS) * 4
        leaf[off:off + 4] = np.asarray(list(data)[:4], dtype=np.uint64)

    def _levels(self):
        """Digest maps per level, level 0 = leaves (touched only)."""
        levels = [{i: hash_leaf(l) for i, l in self.leaves.items()}]
        for lv in range(TREE_HEIGHT):
            cur = levels[-1]
            nxt = {}
            for i in sorted(cur):
                pi = i >> 1
                if pi in nxt:
                    continue
                nxt[pi] = compress(cur.get(2 * pi, zero_digest(lv)),
                                   cur.get(2 * pi + 1, zero_digest(lv)))
            levels.append(nxt)
        return levels

    def root(self) -> np.ndarray:
        levels = self._levels()
        top = levels[-1].get(0, zero_digest(TREE_HEIGHT))
        return np.asarray(top, dtype=np.uint64)

    def open_leaf(self, a_s: int, wa: int):
        """(cells8, [sibling digests leaf->root]) for the leaf's path."""
        li = leaf_index(a_s, wa)
        levels = self._levels()
        proof = []
        idx = li
        for lv in range(TREE_HEIGHT):
            sib = levels[lv].get(idx ^ 1, zero_digest(lv))
            proof.append(np.asarray(sib, dtype=np.uint64))
            idx >>= 1
        cells = self.leaves.get(li, np.zeros(8, dtype=np.uint64)).copy()
        return cells, proof


def verify_leaf(root, a_s: int, wa: int, cells8, proof) -> bool:
    node = hash_leaf(cells8)
    idx = leaf_index(a_s, wa)
    for sib in proof:
        sib = tuple(int(x) for x in sib)
        node = compress(sib, node) if idx & 1 else compress(node, sib)
        idx >>= 1
    return bool(np.array_equal(np.asarray(node, dtype=np.uint64),
                               np.asarray(root, dtype=np.uint64)))


def pv_proof(tree: SparseMemoryTree, num_pv_words: int = 8) -> dict:
    """UserPublicValuesProof equivalent: open the AS3 pv block."""
    assert num_pv_words % LEAF_WORDS == 0
    n_leaves = num_pv_words // LEAF_WORDS
    pvs = []
    opens = []
    for li in range(n_leaves):
        cells, proof = tree.open_leaf(3, li * LEAF_WORDS)
        pvs.extend(int(x) for x in cells)
        opens.append(proof)
    return {"public_values": pvs, "proofs": opens, "root": tree.root()}


def verify_pv_proof(proof: dict, num_pv_words: int = 8) -> bool:
    n_leaves = num_pv_words // LEAF_WORDS
    pvs = np.asarray(proof["public_values"], dtype=np.uint64)
    for li in range(n_leaves):
        if not verify_leaf(proof["root"], 3, li * LEAF_WORDS,
                           pvs[8 * li:8 * li + 8], proof["proofs"][li]):
            return False
    return True
