"""Poseidon2 permutation AIR + periphery chip.

Copy of openvm_tpu/vm/circuit/poseidon2_chip.py:1-226: ``Poseidon2Air`` (494
columns: mult, inp, 8 full rounds x 32, 13 partial rounds x 17), its numpy
``trace`` and ``pad_to``.

Re-design of the reference's poseidon2 sub-AIR and periphery chip
(reference crates/circuits/poseidon2-air + crates/vm/src/system/poseidon2:
"hash/compress calls from merkle+boundary (and native ext) via direct bus",
SURVEY.md section 2.1).  One row proves one width-16 permutation:

  state -> external linear -> 4 full rounds -> 13 partial rounds
        -> 4 full rounds -> output

The x^7 s-box keeps constraint degree <= 3 via one intermediate register per
s-box (x3 = t*t*t; x7 = x3*x3*t), the SBOX_REGISTERS=1 layout of
p3-poseidon2-air.  The chip receives (input[16] || output[16]) requests on
POSEIDON2_BUS with a multiplicity column; the memory-Merkle / persistent
boundary chips (continuations) and the native extension are its senders.
"""

from __future__ import annotations

import numpy as np

from ...poseidon2 import (BEGIN_RC, END_RC, HALF_FULL_ROUNDS, INTERNAL_DIAG,
                          PARTIAL_ROUNDS, PARTIAL_RC, WIDTH)
from ...stark.symbolic import Air
from .buses import Cols

P = 2013265921
POSEIDON2_BUS = 5


def _external_linear_exprs(state):
    """mds_light over 16 Expr/int lanes (mirrors poseidon2._external_linear)."""
    out = [None] * 16
    for blk in range(4):
        x0, x1, x2, x3 = state[4 * blk:4 * blk + 4]
        t01 = x0 + x1
        t23 = x2 + x3
        t0123 = t01 + t23
        t01123 = t0123 + x1
        t01233 = t0123 + x3
        out[4 * blk + 3] = t01233 + 2 * x0
        out[4 * blk + 1] = t01123 + 2 * x2
        out[4 * blk + 0] = t01123 + t01
        out[4 * blk + 2] = t01233 + t23
    sums = [out[0 + l] + out[4 + l] + out[8 + l] + out[12 + l]
            for l in range(4)]
    return [out[i] + sums[i % 4] for i in range(16)]


def _internal_linear_exprs(state):
    total = state[0]
    for s in state[1:]:
        total = total + s
    return [int(INTERNAL_DIAG[i]) * state[i] + total for i in range(16)]


class Poseidon2Air(Air):
    """One permutation per row; receives request messages with `mult`."""

    name = "poseidon2"

    def __init__(self, bus: int = POSEIDON2_BUS):
        self.bus = bus
        c = self.c = Cols()
        c.alloc("mult")
        c.alloc("inp", 16)
        for r in range(2 * HALF_FULL_ROUNDS):
            c.alloc(f"f{r}_x3", 16)
            c.alloc(f"f{r}_out", 16)
        for r in range(PARTIAL_ROUNDS):
            c.alloc(f"p{r}_x3")
            c.alloc(f"p{r}_out", 16)
        self.width = c.width

    def eval(self, b):
        c = self.c

        def arr(name, n=16):
            i = c.index[name]
            return [b.main(i + k) for k in range(n)]

        mult = b.main(c.index["mult"])
        inp = arr("inp")
        state = _external_linear_exprs(inp)

        def full_round(r, state):
            rc = BEGIN_RC[r] if r < HALF_FULL_ROUNDS \
                else END_RC[r - HALF_FULL_ROUNDS]
            x3 = arr(f"f{r}_x3")
            out = arr(f"f{r}_out")
            x7 = []
            for i in range(16):
                t = state[i] + int(rc[i])
                b.assert_zero(x3[i] - t * t * t)
                x7.append(x3[i] * x3[i] * t)
            mixed = _external_linear_exprs(x7)
            for i in range(16):
                b.assert_zero(out[i] - mixed[i])
            return out

        for r in range(HALF_FULL_ROUNDS):
            state = full_round(r, state)

        for r in range(PARTIAL_ROUNDS):
            x3 = b.main(c.index[f"p{r}_x3"])
            out = arr(f"p{r}_out")
            t = state[0] + int(PARTIAL_RC[r])
            b.assert_zero(x3 - t * t * t)
            s0 = x3 * x3 * t
            mixed = _internal_linear_exprs([s0] + list(state[1:]))
            for i in range(16):
                b.assert_zero(out[i] - mixed[i])
            state = out

        for r in range(HALF_FULL_ROUNDS, 2 * HALF_FULL_ROUNDS):
            state = full_round(r, state)

        b.push_receive(self.bus, inp + state, mult)

    # -- tracegen --------------------------------------------------------
    def pad_to(self, trace, height: int):
        """Padding rows must be real zero-state permutations (the round
        constraints are ungated), not zero rows."""
        n = len(trace)
        assert n <= height, f"poseidon2 trace {n} exceeds fixed {height}"
        if n == height:
            return trace
        dummy = self.trace(np.zeros((1, 16), dtype=np.uint64),
                           mults=np.zeros(1, dtype=np.uint64))[0:1]
        return np.vstack([trace, np.repeat(dummy, height - n, axis=0)])

    def trace(self, inputs: np.ndarray, mults=None) -> np.ndarray:
        """inputs: (N, 16) canonical uint64; returns the full trace.

        The AIR's round constraints are ungated, so padding rows are real
        permutations of the zero state with multiplicity 0.
        """
        n0 = len(inputs)
        h = 1 << max((n0 - 1).bit_length(), 0) if n0 > 1 else 1
        if mults is None:
            mults = np.ones(n0, dtype=np.uint64)
        if h > n0:
            pad = np.zeros((h - n0, 16), dtype=np.uint64)
            inputs = np.concatenate(
                [np.asarray(inputs, dtype=np.uint64), pad], axis=0)
            mults = np.concatenate(
                [np.asarray(mults, dtype=np.uint64),
                 np.zeros(h - n0, dtype=np.uint64)])
        n = h
        c = self.c
        t = np.zeros((h, self.width), dtype=np.uint64)
        if n == 0:
            return t
        t[:n, c.index["mult"]] = mults
        state = np.asarray(inputs, dtype=np.uint64) % P
        t[:n, c.index["inp"]:c.index["inp"] + 16] = state

        def pow_mod(x, e):
            r = np.ones_like(x)
            b_ = x.copy()
            while e:
                if e & 1:
                    r = (r * b_) % P
                b_ = (b_ * b_) % P
                e >>= 1
            return r

        def sbox7(x, rc):
            tt = (x + rc) % P
            x3 = pow_mod(tt, 3)
            x7 = (pow_mod(x3, 2) * tt) % P
            return x3, x7

        def ext_lin_correct(s):
            out = np.empty_like(s)
            for blk in range(4):
                x0, x1, x2, x3 = (s[:, 4 * blk + k] for k in range(4))
                t01 = (x0 + x1) % P
                t23 = (x2 + x3) % P
                t0123 = (t01 + t23) % P
                t01123 = (t0123 + x1) % P
                t01233 = (t0123 + x3) % P
                out[:, 4 * blk + 3] = (t01233 + 2 * x0) % P
                out[:, 4 * blk + 1] = (t01123 + 2 * x2) % P
                out[:, 4 * blk + 0] = (t01123 + t01) % P
                out[:, 4 * blk + 2] = (t01233 + t23) % P
            for l in range(4):
                sums_l = (out[:, l] + out[:, 4 + l] + out[:, 8 + l]
                          + out[:, 12 + l]) % P
                for blk in range(4):
                    out[:, 4 * blk + l] = (out[:, 4 * blk + l] + sums_l) % P
            return out

        state = ext_lin_correct(state)

        def do_full(r, state):
            rc = BEGIN_RC[r] if r < HALF_FULL_ROUNDS \
                else END_RC[r - HALF_FULL_ROUNDS]
            x3m = np.empty_like(state)
            x7m = np.empty_like(state)
            for i in range(16):
                x3m[:, i], x7m[:, i] = sbox7(state[:, i], int(rc[i]))
            out = ext_lin_correct(x7m)
            t[:n, c.index[f"f{r}_x3"]:c.index[f"f{r}_x3"] + 16] = x3m
            t[:n, c.index[f"f{r}_out"]:c.index[f"f{r}_out"] + 16] = out
            return out

        for r in range(HALF_FULL_ROUNDS):
            state = do_full(r, state)
        for r in range(PARTIAL_ROUNDS):
            x3v, x7v = sbox7(state[:, 0], int(PARTIAL_RC[r]))
            t[:n, c.index[f"p{r}_x3"]] = x3v
            s = state.copy()
            s[:, 0] = x7v
            total = s.sum(axis=1) % P
            out = (s * INTERNAL_DIAG[None, :] + total[:, None]) % P
            t[:n, c.index[f"p{r}_out"]:c.index[f"p{r}_out"] + 16] = out
            state = out
        for r in range(HALF_FULL_ROUNDS, 2 * HALF_FULL_ROUNDS):
            state = do_full(r, state)
        return t

    def output_cols(self):
        last = 2 * HALF_FULL_ROUNDS - 1
        i = self.c.index[f"f{last}_out"]
        return slice(i, i + 16)
