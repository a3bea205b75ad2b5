"""Fiat-Shamir transcript: duplex-sponge challenger (host-side, serial).

Copy of openvm_tpu/challenger.py:18-111, plonky3's ``DuplexChallenger<
BabyBear, Poseidon2, WIDTH=16, RATE=8>`` semantics on numpy uint64
canonical values:
  * observe() clears the output buffer (samples never survive an observe)
  * duplex: input buffer overwrites state[0..k], permute, output = state[0..8]
  * sample() pops from the END of the output buffer
  * sample_bits(b) masks the low b bits of the canonical value
  * grinding witness: observe(w) then sample_bits(bits) == 0
"""

from __future__ import annotations

import numpy as np

from .field import babybear as bb
from .poseidon2 import RATE, WIDTH, Poseidon2Host

P = bb.P


class DuplexChallenger:
    def __init__(self):
        self._perm = Poseidon2Host()
        self.state = np.zeros(WIDTH, dtype=np.uint64)
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def clone(self) -> "DuplexChallenger":
        c = DuplexChallenger()
        c.state = self.state.copy()
        c.input_buffer = list(self.input_buffer)
        c.output_buffer = list(self.output_buffer)
        return c

    def _duplexing(self) -> None:
        for i, v in enumerate(self.input_buffer):
            self.state[i] = v
        self.input_buffer.clear()
        self.state = self._perm.permute(self.state)
        self.output_buffer = list(int(x) for x in self.state[:RATE])

    def observe(self, value: int) -> None:
        value = int(value) % P
        self.output_buffer.clear()
        self.input_buffer.append(value)
        if len(self.input_buffer) == RATE:
            self._duplexing()

    def observe_slice(self, values) -> None:
        for v in np.asarray(values, dtype=np.uint64).reshape(-1):
            self.observe(int(v))

    def observe_ext(self, coeffs) -> None:
        """Observe an extension element as its 4 base coefficients."""
        self.observe_slice(np.asarray(coeffs, dtype=np.uint64))

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplexing()
        return self.output_buffer.pop()

    def sample_ext(self) -> tuple:
        """Sample an extension element (4 base samples, coeff order a0..a3)."""
        return tuple(int(self.sample()) for _ in range(4))

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    # -- proof of work --------------------------------------------------

    def check_witness(self, bits: int, witness: int) -> bool:
        self.observe(witness)
        return self.sample_bits(bits) == 0

    def grind(self, bits: int) -> int:
        """Find (and absorb) a witness w with sample_bits(bits)==0.

        A candidate observe(w)+sample() is ONE duplex of the current state
        with the input buffer (plus w) written over the leading lanes, the
        sample at lane RATE-1, so candidates are searched in batches through
        the batched host permutation."""
        mask = (1 << bits) - 1
        k = len(self.input_buffer)  # < RATE: observe() duplexes at RATE
        base_state = self.state.astype(np.uint64).copy()
        base_state[:k] = self.input_buffer
        chunk = 1 << 14
        w0 = 0
        while True:
            states = np.broadcast_to(
                base_state, (chunk, WIDTH)).astype(np.uint64).copy()
            states[:, k] = np.arange(w0, w0 + chunk, dtype=np.uint64)
            out = self._perm.permute_batch(states)
            hits = np.nonzero((out[:, RATE - 1] & mask) == 0)[0]
            if hits.size:
                w = w0 + int(hits[0])
                break
            w0 += chunk
        if not self.check_witness(bits, w):
            raise RuntimeError("grind found a witness that does not check")
        return w
