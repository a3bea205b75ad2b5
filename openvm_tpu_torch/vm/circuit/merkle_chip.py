"""Memory Merkle chip: in-circuit tree-path updates between two roots.

Copy of openvm_tpu/vm/circuit/merkle_chip.py:1-193: ``MemoryMerkleAir`` (its
root row binds 16 public values), its ``trace`` and ``p2_requests``.

Re-design of the reference's ``MemoryMerkleChip`` (reference
crates/vm/src/system/memory/merkle/: "persistent-memory commitment,
final/initial roots as public values"; SURVEY.md section 2.1).  One row per
touched tree node:

  * leaf updates arrive on MERKLE_BUS from the requester (the persistent
    boundary in the full VM; a test harness air here):
    message (level=0, index, old_digest[8], new_digest[8])
  * an internal row at (level, index) receives its touched children's
    updates, carries untouched children's digests as witness (constrained
    old == new), proves both compressions via the Poseidon2 chip's request
    bus, and sends its own (level, index, old, new) update upward
  * the root row (level = TREE_HEIGHT) binds (old, new) to the AIR public
    values [initial_root || final_root]

Soundness: old digests are anchored top-down from the trusted initial root;
new digests bottom-up into the final root; LogUp balance forces exactly the
touched paths to connect.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..memory_tree import TREE_HEIGHT, compress, zero_digest
from .buses import Cols
from .poseidon2_chip import POSEIDON2_BUS

P = 2013265921
MERKLE_BUS = 6


class MemoryMerkleAir(Air):
    name = "memory_merkle"

    def __init__(self, merkle_bus: int = MERKLE_BUS,
                 p2_bus: int = POSEIDON2_BUS):
        self.merkle_bus = merkle_bus
        self.p2_bus = p2_bus
        self.num_public_values = 16  # initial_root[8] || final_root[8]
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_root")
        c.alloc("level"), c.alloc("index")
        c.alloc("tl"), c.alloc("tr")  # touched child flags
        c.alloc("old_l", 8), c.alloc("old_r", 8)
        c.alloc("new_l", 8), c.alloc("new_r", 8)
        c.alloc("old_d", 8), c.alloc("new_d", 8)
        c.alloc("old_extra", 8), c.alloc("new_extra", 8)
        self.width = c.width

    def eval(self, b):
        c = self.c

        def arr(name):
            i = c.index[name]
            return [b.main(i + k) for k in range(8)]

        v = b.main(c.index["is_valid"])
        is_root = b.main(c.index["is_root"])
        level = b.main(c.index["level"])
        index = b.main(c.index["index"])
        tl = b.main(c.index["tl"])
        tr = b.main(c.index["tr"])
        old_l, old_r = arr("old_l"), arr("old_r")
        new_l, new_r = arr("new_l"), arr("new_r")
        old_d, new_d = arr("old_d"), arr("new_d")
        old_x, new_x = arr("old_extra"), arr("new_extra")

        b.assert_bool(v)
        b.assert_bool(is_root)
        b.assert_bool(tl)
        b.assert_bool(tr)
        b.assert_zero(is_root * (1 - v))
        # the first row is ALWAYS a valid root row, so the public values
        # are bound unconditionally — an all-padding trace cannot claim
        # arbitrary roots (reference MemoryMerkleAir pins root rows with
        # when_first_row, crates/vm/src/system/memory/merkle/air.rs)
        first = b.is_first_row()
        b.assert_zero(first * (1 - v))
        b.assert_zero(first * (1 - is_root))
        # at least one child touched on valid rows
        b.assert_zero(v * (1 - tl) * (1 - tr))
        # untouched children carry unchanged digests
        for i in range(8):
            b.assert_zero((1 - tl) * (old_l[i] - new_l[i]))
            b.assert_zero((1 - tr) * (old_r[i] - new_r[i]))

        # receive touched children updates (level-1)
        b.push_receive(self.merkle_bus,
                       [level - 1, 2 * index] + old_l + new_l, tl)
        b.push_receive(self.merkle_bus,
                       [level - 1, 2 * index + 1] + old_r + new_r, tr)

        # prove both compressions via the Poseidon2 request bus
        b.push_send(self.p2_bus, old_l + old_r + old_d + old_x, v)
        b.push_send(self.p2_bus, new_l + new_r + new_d + new_x, v)

        # propagate own update upward (root row terminates the chain)
        b.push_send(self.merkle_bus, [level, index] + old_d + new_d,
                    v * (1 - is_root))

        # root binds to public values and sits at the tree top
        b.assert_zero(is_root * (level - TREE_HEIGHT))
        b.assert_zero(is_root * index)
        for i in range(8):
            b.assert_zero(is_root * (old_d[i] - b.public_value(i)))
            b.assert_zero(is_root * (new_d[i] - b.public_value(8 + i)))

    # -- tracegen --------------------------------------------------------
    def trace(self, leaf_updates: dict, tree):
        """Rows for a batch of leaf updates against `tree` (pre-update).

        leaf_updates: {global_leaf_index: (old_digest8, new_digest8)}.
        tree: SparseMemoryTree in its PRE-update state (for sibling digests).
        Returns (trace, initial_root, final_root).
        """
        levels = tree._levels()
        rows = []
        cur = dict(leaf_updates)  # idx -> (old8, new8)
        for lv in range(1, TREE_HEIGHT + 1):
            nxt = {}
            for ci in sorted(cur):
                pi = ci >> 1
                if pi in nxt:
                    continue
                li, ri = 2 * pi, 2 * pi + 1
                zl = zero_digest(lv - 1)
                old_left = cur[li][0] if li in cur else \
                    levels[lv - 1].get(li, zl)
                new_left = cur[li][1] if li in cur else old_left
                old_right = cur[ri][0] if ri in cur else \
                    levels[lv - 1].get(ri, zl)
                new_right = cur[ri][1] if ri in cur else old_right
                old_d = compress(old_left, old_right)
                new_d = compress(new_left, new_right)
                rows.append({
                    "level": lv, "index": pi, "is_root": lv == TREE_HEIGHT,
                    "tl": int(li in cur), "tr": int(ri in cur),
                    "old_l": old_left, "old_r": old_right,
                    "new_l": new_left, "new_r": new_right,
                    "old_d": old_d, "new_d": new_d,
                })
                nxt[pi] = (old_d, new_d)
            cur = nxt
        assert rows, "no leaf updates"
        initial_root = rows[-1]["old_d"]
        final_root = rows[-1]["new_d"]
        # the AIR pins row 0 as the root row (unconditional PV binding)
        rows = [rows[-1]] + rows[:-1]

        from ..memory_tree import _host
        perm = _host()

        n = len(rows)
        h = 1 << max((n - 1).bit_length(), 0) if n > 1 else 1
        t = np.zeros((h, self.width), dtype=np.uint64)
        c = self.c
        for r, row in enumerate(rows):
            t[r, c.index["is_valid"]] = 1
            t[r, c.index["is_root"]] = row["is_root"]
            t[r, c.index["level"]] = row["level"]
            t[r, c.index["index"]] = row["index"]
            t[r, c.index["tl"]] = row["tl"]
            t[r, c.index["tr"]] = row["tr"]
            for nm in ("old_l", "old_r", "new_l", "new_r", "old_d", "new_d"):
                t[r, c.index[nm]:c.index[nm] + 8] = row[nm]
            # full permutation outputs for the p2 requests
            st = np.zeros(16, dtype=np.uint64)
            st[:8] = row["old_l"]
            st[8:] = row["old_r"]
            t[r, c.index["old_extra"]:c.index["old_extra"] + 8] = \
                perm.permute(st)[8:]
            st[:8] = row["new_l"]
            st[8:] = row["new_r"]
            t[r, c.index["new_extra"]:c.index["new_extra"] + 8] = \
                perm.permute(st)[8:]
        return t, initial_root, final_root

    def p2_requests(self, trace) -> np.ndarray:
        """(M, 16) permutation inputs this trace sends to the p2 chip."""
        c = self.c
        valid = trace[:, c.index["is_valid"]] == 1
        rows = trace[valid]
        old_in = np.concatenate(
            [rows[:, c.index["old_l"]:c.index["old_l"] + 8],
             rows[:, c.index["old_r"]:c.index["old_r"] + 8]], axis=1)
        new_in = np.concatenate(
            [rows[:, c.index["new_l"]:c.index["new_l"] + 8],
             rows[:, c.index["new_r"]:c.index["new_r"] + 8]], axis=1)
        return np.concatenate([old_in, new_in], axis=0)
