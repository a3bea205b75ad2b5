"""Persistent memory boundary: leaf-granular init/final states + Merkle tie.

Copy of openvm_tpu/vm/circuit/persistent_boundary.py:1-144:
``PersistentBoundaryAir``, its ``trace`` and ``p2_requests``.

Re-design of the reference's ``PersistentBoundaryAir<CHUNK=8>`` (reference
crates/vm/src/system/memory/persistent.rs; SURVEY.md section 2.1).  One row
per touched LEAF (8 byte-cells = 2 words):

  * memory bus: sends both words' initial states at t=0, receives both
    words' final states (untouched words in a touched leaf balance
    automatically: send == receive forces final == init, ts == 0)
  * Poseidon2 bus: proves init/final leaf digests
  * MERKLE_BUS: sends (level 0, global_leaf_index, init_digest,
    final_digest) consumed by the MemoryMerkleAir, which binds the roots to
    the AIR public values
  * rows strictly sorted by global leaf index (uniqueness)

Initial cell values need no range checks: they are bound through the Merkle
chip to the trusted initial root (computed from the executable's image).
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..memory_tree import AS_LEAF_HEIGHT
from . import buses as B
from .buses import Cols
from .merkle_chip import MERKLE_BUS
from .poseidon2_chip import POSEIDON2_BUS

P = 2013265921


class PersistentBoundaryAir(Air):
    name = "persistent_boundary"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("hnv")
        c.alloc("as"), c.alloc("leaf")  # address space, per-as leaf index
        c.alloc("init", 8), c.alloc("final", 8)
        c.alloc("fts0"), c.alloc("fts1")  # final ts per word
        c.alloc("init_d", 8), c.alloc("final_d", 8)
        c.alloc("init_x", 8), c.alloc("final_x", 8)  # permute extras
        c.alloc("kdlo"), c.alloc("kdhi")
        self.width = c.width

    def eval(self, b):
        c = self.c

        def arr(name):
            i = c.index[name]
            return [b.main(i + k) for k in range(8)]

        v = b.main(c.index["is_valid"])
        hnv = b.main(c.index["hnv"])
        aspace = b.main(c.index["as"])
        leaf = b.main(c.index["leaf"])
        init = arr("init")
        final = arr("final")
        fts0, fts1 = b.main(c.index["fts0"]), b.main(c.index["fts1"])
        init_d, final_d = arr("init_d"), arr("final_d")
        init_x, final_x = arr("init_x"), arr("final_x")

        b.assert_bool(v)
        nv = b.main(c.index["is_valid"], offset=1)
        b.assert_zero(b.is_transition() * nv * (1 - v))
        b.assert_bool(hnv)
        b.assert_zero(b.is_transition() * (hnv - nv))
        b.assert_zero(b.is_last_row() * hnv)

        # memory bus: word-granular init sends / final receives
        w0 = 2 * leaf
        b.push_send(B.MEMORY_BUS, [aspace, w0] + init[:4] + [0], v)
        b.push_send(B.MEMORY_BUS, [aspace, w0 + 1] + init[4:] + [0], v)
        b.push_receive(B.MEMORY_BUS, [aspace, w0] + final[:4] + [fts0], v)
        b.push_receive(B.MEMORY_BUS, [aspace, w0 + 1] + final[4:] + [fts1],
                       v)

        # leaf digests via the poseidon2 chip
        zeros = [0] * 8
        b.push_send(POSEIDON2_BUS, init + zeros + init_d + init_x, v)
        b.push_send(POSEIDON2_BUS, final + zeros + final_d + final_x, v)

        # hand the leaf update to the Merkle chip
        gidx = (aspace - 1) * (1 << AS_LEAF_HEIGHT) + leaf
        b.push_send(MERKLE_BUS, [0, gidx] + init_d + final_d, v)

        # strict ordering by global leaf index
        next_as = b.main(c.index["as"], offset=1)
        next_leaf = b.main(c.index["leaf"], offset=1)
        next_g = (next_as - 1) * (1 << AS_LEAF_HEIGHT) + next_leaf
        kdlo, kdhi = b.main(c.index["kdlo"]), b.main(c.index["kdhi"])
        b.assert_zero(b.is_transition() * hnv
                      * (next_g - gidx - 1 - kdlo - kdhi * (1 << 15)))
        B.range_check(b, kdlo, 15, hnv)
        B.range_check(b, kdhi, 13, hnv)

    # -- tracegen --------------------------------------------------------
    def trace(self, leaf_rows):
        """leaf_rows: sorted list of dicts with keys
        as, leaf, init(8), final(8), fts0, fts1."""
        from ..memory_tree import _host
        perm = _host()
        n = len(leaf_rows)
        h = 1 << max((n - 1).bit_length(), 0) if n > 1 else 1
        t = np.zeros((h, self.width), dtype=np.uint64)
        c = self.c
        for r, row in enumerate(leaf_rows):
            t[r, c.index["is_valid"]] = 1
            t[r, c.index["as"]] = row["as"]
            t[r, c.index["leaf"]] = row["leaf"]
            t[r, c.index["init"]:c.index["init"] + 8] = row["init"]
            t[r, c.index["final"]:c.index["final"] + 8] = row["final"]
            t[r, c.index["fts0"]] = row["fts0"]
            t[r, c.index["fts1"]] = row["fts1"]
            st = np.zeros(16, dtype=np.uint64)
            st[:8] = row["init"]
            out = perm.permute(st)
            t[r, c.index["init_d"]:c.index["init_d"] + 8] = out[:8]
            t[r, c.index["init_x"]:c.index["init_x"] + 8] = out[8:]
            st = np.zeros(16, dtype=np.uint64)
            st[:8] = row["final"]
            out = perm.permute(st)
            t[r, c.index["final_d"]:c.index["final_d"] + 8] = out[:8]
            t[r, c.index["final_x"]:c.index["final_x"] + 8] = out[8:]
        # ordering diffs
        gidx = [(int(r["as"]) - 1) * (1 << AS_LEAF_HEIGHT) + int(r["leaf"])
                for r in leaf_rows]
        for r in range(n - 1):
            d = gidx[r + 1] - gidx[r] - 1
            t[r, c.index["kdlo"]] = d & 0x7FFF
            t[r, c.index["kdhi"]] = d >> 15
            t[r, c.index["hnv"]] = 1
        return t

    def p2_requests(self, trace) -> np.ndarray:
        c = self.c
        rows = trace[trace[:, c.index["is_valid"]] == 1]
        zeros = np.zeros((len(rows), 8), dtype=np.uint64)
        init_in = np.concatenate(
            [rows[:, c.index["init"]:c.index["init"] + 8], zeros], axis=1)
        final_in = np.concatenate(
            [rows[:, c.index["final"]:c.index["final"] + 8], zeros], axis=1)
        return np.concatenate([init_in, final_in], axis=0)