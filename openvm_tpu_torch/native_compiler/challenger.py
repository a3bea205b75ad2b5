"""In-program duplex challenger, compiled statically.

Copy of openvm_tpu/native_compiler/challenger.py:1-109 (``ProgramChallenger``
with observe, sample, ``sample_ext``, ``sample_bits`` and ``check_witness``;
``bits_le_canonical`` and ``bits_to_index``) on the port's Builder, whose
``permute`` emits e = 4 (builder.py's docstring): each duplexing is one
PERM_POS2 that NativePoseidon2Air accepts, where the JAX package's is
e = 0.

Mirrors `openvm_tpu_torch.challenger.DuplexChallenger` (reference
extensions/native/recursion/src/challenger/duplex.rs) but exploits that
recursion programs are generated per proof shape: the observe/sample
schedule is known at codegen time, so the input/output buffer positions
are tracked by the *generator*, not the program.  Each duplexing is one
PERM_POS2 instruction; observes write straight into the sponge state's
rate cells (they are not read between observes, so early writes are
exactly the reference's overwrite-at-duplex semantics).
"""

from __future__ import annotations

from ..vm.instructions import NativePhantom, phantom
from .builder import Builder, Ext, Felt, FeltArray

P = 2013265921
RATE = 8


class ProgramChallenger:
    def __init__(self, b: Builder):
        self.b = b
        self.state = b.array(16)  # starts all-zero (volatile memory init)
        self._in = 0   # pending observes (written into state[0.._in))
        self._out = 0  # remaining output-buffer samples

    def _duplex(self):
        self._in = 0
        self.b.permute(self.state, self.state)
        self._out = RATE

    def observe(self, x):
        """x: Felt | int."""
        self._out = 0
        self.b.mov(x, self.state.felt(self._in))
        self._in += 1
        if self._in == RATE:
            self._duplex()

    def observe_arr(self, arr: FeltArray):
        for i in range(arr.n):
            self.observe(arr.felt(i))

    def sample(self) -> Felt:
        if self._in or not self._out:
            self._duplex()
        self._out -= 1
        return self.b.mov(self.state.felt(self._out))

    def sample_ext(self) -> Ext:
        e = self.b.ext()
        for i in range(4):
            if self._in or not self._out:
                self._duplex()
            self._out -= 1
            self.b.mov(self.state.felt(self._out), Felt(e.addr + i))
        return Ext(e.addr)

    def sample_bits(self, bits: int) -> FeltArray:
        """Sample a felt and return its canonical 31-bit LE decomposition;
        caller uses the low `bits` of it."""
        s = self.sample()
        return bits_le_canonical(self.b, s)

    def check_witness(self, bits: int, witness) -> None:
        """observe(witness); assert sample's low `bits` bits are zero."""
        self.observe(witness)
        dec = self.sample_bits(bits)
        for i in range(bits):
            self.b.assert_eq(dec.felt(i), 0)


def bits_le_canonical(b: Builder, x: Felt) -> FeltArray:
    """Canonical 31-bit LE decomposition of a felt.

    Hinted bits, then constrained: booleanity, recomposition == x, and
    canonicity for BabyBear p = 2^31 - 2^27 + 1 (if bits 27..30 are all
    one, bits 0..26 must be zero) so a malicious hint of x + p is
    rejected.  Mirrors the reference num2bits canonicity check
    (extensions/native/recursion, utils num2bits_v).
    """
    b.emit(phantom(NativePhantom.HINT_BITS, a=x.addr, b=31))
    bits = b.read_hints(31)
    with b.scope():
        for i in range(31):
            t = b.mul(bits.felt(i), bits.felt(i))
            b.assert_eq(t, bits.felt(i))
        acc = b.mov(0)
        for i in reversed(range(31)):
            acc = b.add(b.mul(acc, 2), bits.felt(i))
        b.assert_eq(acc, x)
        top = b.mul(bits.felt(27), bits.felt(28))
        top = b.mul(top, bits.felt(29))
        top = b.mul(top, bits.felt(30))
        for i in range(27):
            t = b.mul(top, bits.felt(i))
            b.assert_eq(t, 0)
    return bits


def bits_to_index(b: Builder, bits: FeltArray, n: int) -> Felt:
    """Recompose the low n bits into a felt index."""
    acc = b.mov(0)
    for i in reversed(range(n)):
        acc = b.add(b.mul(acc, 2), bits.felt(i))
    return acc
