"""SHA-256 extension: compression round table + sponge/memory chip.

Copy of openvm_tpu/vm/circuit/sha256.py (the whole module: Sha256Air,
Sha256VmAir, the host sha_compress and sha256).

TPU-native re-design of the reference sha256 extension
(reference crates/circuits/sha256-air — 17 rows per 512-bit block with 4
rounds per row and pipelined message-schedule helpers — plus
extensions/sha256/circuit/src/sha256_chip.rs for the VM adapter).  Here the
compression is one row per round (64 rows per block): column-heavier than
the reference's packing but with only offset-1 row references, trivially
vectorized tracegen, and every constraint at degree <= 3.

  Sha256Air     64 rows per block.  Working variables a and e are kept as
                32-bit columns for the current round and three chained
                copies (the classic trick: b,c,d / f,g,h are earlier
                rounds' a / e).  The message schedule chains w 16 rounds
                deep as u16 limbs, with bit decompositions of w_{r-2} and
                w_{r-15} for the sigma functions.  Bus protocol on
                SHA_BUS, tagged messages paired by a block-constant
                multiplicity column:
                  (0, prev_hash[16], block[32])  received on round-15 rows
                  (1, prev_hash[16], out[16])    received on round-63 rows
                Padding blocks are real compressions of the zero state
                with multiplicity 0 (no validity gates on round math).

  Sha256VmAir   one row per 64-byte block: registers, gated word reads,
                SHA padding (0x80, zeros, 64-bit big-endian bit length),
                digest writes, and the two table requests.

Instruction: SHA256 (0x320) a=4*rd b=4*rs1 c=4*rs2 d=1 e=2 (reference
extensions/sha256/transpiler/src/lib.rs; custom-0 funct3=0b100 funct7=1);
src and dst may both be byte-aligned: the chip reads/writes whole-word
WINDOWS and selects bytes in-circuit (access-adapter role, as keccak).

Timestamp schedule per block: register reads ticks 0..2 (first block),
17 gated window reads ticks 3..19, 9 digest window writes ticks 20..28
(last block, word 9 gated on doff>0); ts += 29.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..instructions import Rv32Sha256Opcode
from . import buses as B
from .buses import Cols
from .rv32im import _m, _marr, _pad_pow2

P = 2013265921
SHA_BUS = 8

BLOCK_BYTES = 64
BLOCK_WORDS = 16
W_WINDOW = BLOCK_WORDS + 1  # 17: unaligned blocks span one extra word
NUM_ROUNDS = 64
HASH_WORDS = 8
DIGEST_WORDS = 8
D_WINDOW = DIGEST_WORDS + 1  # 9: unaligned digests span one extra word
TS_PER_BLOCK = 3 + W_WINDOW + D_WINDOW  # 29

K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
]

H0 = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
      0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# host sha256 (reference semantics; E1 + preflight + tracegen)
# ---------------------------------------------------------------------------


def _rotr(v, n):
    return ((v >> n) | (v << (32 - n))) & M32


def sha_compress(state, block_words):
    """One compression: state [8] u32, block_words [16] u32 (big-endian
    words).  Returns (new_state [8], per-round (a, e) lists for tracegen,
    w [64])."""
    w = list(block_words) + [0] * 48
    for r in range(16, 64):
        s0 = _rotr(w[r - 15], 7) ^ _rotr(w[r - 15], 18) ^ (w[r - 15] >> 3)
        s1 = _rotr(w[r - 2], 17) ^ _rotr(w[r - 2], 19) ^ (w[r - 2] >> 10)
        w[r] = (w[r - 16] + s0 + w[r - 7] + s1) & M32
    a, b, c, d, e, f, g, h = state
    a_hist, e_hist = [], []
    for r in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[r] + w[r]) & M32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & M32
        h, g, f = g, f, e
        e = (d + t1) & M32
        d, c, b = c, b, a
        a = (t1 + t2) & M32
        a_hist.append(a), e_hist.append(e)
    out = [(s + v) & M32 for s, v in zip(state, [a, b, c, d, e, f, g, h])]
    return out, (a_hist, e_hist), w


def sha_pad(data: bytes):
    """SHA-256 padding; returns padded bytes (multiple of 64)."""
    bitlen = 8 * len(data)
    out = bytearray(data) + b"\x80"
    out += bytes(-(len(out) + 8) % BLOCK_BYTES)
    out += bitlen.to_bytes(8, "big")
    return bytes(out)


def sha256(data: bytes) -> bytes:
    state = list(H0)
    padded = sha_pad(data)
    for off in range(0, len(padded), BLOCK_BYTES):
        words = [int.from_bytes(padded[off + 4 * i:off + 4 * i + 4], "big")
                 for i in range(BLOCK_WORDS)]
        state, _, _ = sha_compress(state, words)
    return b"".join(v.to_bytes(4, "big") for v in state)


# ---------------------------------------------------------------------------
# compression round-table AIR
# ---------------------------------------------------------------------------


def _xor3(p, q, r):
    return (p + q + r - 2 * (p * q + p * r + q * r) + 4 * (p * q * r))


class Sha256Air(Air):
    """One row per compression round; 64 consecutive rows = one block."""

    name = "sha256"

    # chained bit copies: col "a" holds a_r (value AFTER round r);
    # a1/a2/a3 = a_{r-1..r-3}; d = a_{r-4} as limbs.  Same for e side.
    BITCOLS = ("a", "a1", "a2", "a3", "e", "e1", "e2", "e3")

    def __init__(self):
        c = self.c = Cols()
        c.alloc("flags", NUM_ROUNDS)
        c.alloc("mult")
        c.alloc("h0", 2 * HASH_WORDS)            # prev hash u16 limbs
        for nm in self.BITCOLS:
            c.alloc(f"{nm}_bits", 32)
        c.alloc("d", 2), c.alloc("h", 2)
        c.alloc("w", 2)
        for k in range(1, 17):
            c.alloc(f"w{k}", 2)
        c.alloc("w2_bits", 32), c.alloc("w15_bits", 32)
        # sigma values materialized per u16 limb so the round-16 gate stays
        # at degree <= 3 (the xor3 bit recompositions are degree 3 already)
        c.alloc("sig0", 2), c.alloc("sig1", 2)
        # two carries per 32-bit addition: all arithmetic is u16-limb-wise
        # (whole-word equations would exceed the BabyBear modulus and admit
        # spurious mod-P solutions; the reference sha256-air splits
        # identically, crates/circuits/sha256-air/src/columns.rs carry_a/e)
        c.alloc("carry_a", 2), c.alloc("carry_e", 2), c.alloc("carry_w", 2)
        c.alloc("out_bytes", 4 * HASH_WORDS)
        c.alloc("out_carry", 2 * HASH_WORDS)
        self.width = c.width

    def eval(self, b):
        c = self.c
        flags = _marr(b, c, "flags", NUM_ROUNDS)
        mult = _m(b, c, "mult")
        trans = b.is_transition()

        for r in range(NUM_ROUNDS):
            b.assert_bool(flags[r])
        b.assert_eq(sum(flags), 1)
        b.assert_zero(b.is_first_row() * (1 - flags[0]))
        for r in range(NUM_ROUNDS):
            b.assert_zero(trans * (b.main(c.index["flags"]
                                          + (r + 1) % NUM_ROUNDS, 1)
                                   - flags[r]))
        b.assert_bool(mult)
        not_last = 1 - flags[NUM_ROUNDS - 1]
        b.assert_zero(trans * not_last * (b.main(c.index["mult"], 1) - mult))

        bits = {nm: _marr(b, c, f"{nm}_bits", 32) for nm in self.BITCOLS}
        for nm in self.BITCOLS:
            for i in range(32):
                b.assert_bool(bits[nm][i])
        w2b = _marr(b, c, "w2_bits", 32)
        w15b = _marr(b, c, "w15_bits", 32)
        for i in range(32):
            b.assert_bool(w2b[i]), b.assert_bool(w15b[i])

        def lo(bs):
            return sum((1 << i) * bs[i] for i in range(16))

        def hi(bs):
            return sum((1 << (i - 16)) * bs[i] for i in range(16, 32))

        def val(bs):
            return sum((1 << i) * bs[i] for i in range(32))

        def limbs(name):
            i0 = c.index[name]
            return b.main(i0), b.main(i0 + 1)      # (lo, hi)

        def limb_val(name):
            l, h_ = limbs(name)
            return l + (1 << 16) * h_

        # chains within a block (gated off on the last round row)
        def chain_eq(dst, expr_lo, expr_hi):
            dlo = b.main(c.index[dst], 1)
            dhi = b.main(c.index[dst] + 1, 1)
            b.assert_zero(trans * not_last * (dlo - expr_lo))
            b.assert_zero(trans * not_last * (dhi - expr_hi))

        for src, dst in (("a", "a1"), ("a1", "a2"), ("a2", "a3"),
                         ("e", "e1"), ("e1", "e2"), ("e2", "e3")):
            for i in range(32):
                b.assert_zero(trans * not_last
                              * (b.main(c.index[f"{dst}_bits"] + i, 1)
                                 - bits[src][i]))
        chain_eq("d", lo(bits["a3"]), hi(bits["a3"]))
        chain_eq("h", lo(bits["e3"]), hi(bits["e3"]))
        chain_eq("w1", *limbs("w"))
        for k in range(1, 16):
            chain_eq(f"w{k + 1}", *limbs(f"w{k}"))
        for i in range(2 * HASH_WORDS):
            b.assert_zero(trans * not_last
                          * (b.main(c.index["h0"] + i, 1)
                             - b.main(c.index["h0"] + i)))

        # round 0: chained copies hold the previous hash state
        h0c = _marr(b, c, "h0", 2 * HASH_WORDS)

        def bind0(word_idx, lo_e, hi_e):
            b.assert_zero(flags[0] * (h0c[2 * word_idx] - lo_e))
            b.assert_zero(flags[0] * (h0c[2 * word_idx + 1] - hi_e))

        bind0(0, lo(bits["a1"]), hi(bits["a1"]))
        bind0(1, lo(bits["a2"]), hi(bits["a2"]))
        bind0(2, lo(bits["a3"]), hi(bits["a3"]))
        bind0(3, *limbs("d"))
        bind0(4, lo(bits["e1"]), hi(bits["e1"]))
        bind0(5, lo(bits["e2"]), hi(bits["e2"]))
        bind0(6, lo(bits["e3"]), hi(bits["e3"]))
        bind0(7, *limbs("h"))

        # sigma bit decompositions of w_{r-2} / w_{r-15}
        b.assert_zero(limb_val("w2") - val(w2b))
        b.assert_zero(limb_val("w15") - val(w15b))

        def rotr_bit(bs, i, n):
            return bs[(i + n) % 32]

        def shr_bit(bs, i, n):
            return bs[i + n] if i + n < 32 else None

        def sig_limb(bs, r1, r2, sh, half):
            acc = 0
            for i in range(16 * half, 16 * half + 16):
                p_ = rotr_bit(bs, i, r1)
                q = rotr_bit(bs, i, r2)
                r_ = shr_bit(bs, i, sh)
                x = _xor3(p_, q, r_) if r_ is not None else \
                    (p_ + q - 2 * p_ * q)
                acc = acc + (1 << (i - 16 * half)) * x
            return acc

        # materialize sigma limbs (ungated; padding blocks carry real data)
        sig0c = _marr(b, c, "sig0", 2)
        sig1c = _marr(b, c, "sig1", 2)
        b.assert_zero(sig0c[0] - sig_limb(w15b, 7, 18, 3, 0))
        b.assert_zero(sig0c[1] - sig_limb(w15b, 7, 18, 3, 1))
        b.assert_zero(sig1c[0] - sig_limb(w2b, 17, 19, 10, 0))
        b.assert_zero(sig1c[1] - sig_limb(w2b, 17, 19, 10, 1))

        # round constants / flags
        k_lo = sum(flags[r] * (K[r] & 0xFFFF) for r in range(NUM_ROUNDS))
        k_hi = sum(flags[r] * (K[r] >> 16) for r in range(NUM_ROUNDS))
        gate16 = sum(flags[r] for r in range(16, NUM_ROUNDS))

        # message schedule (rounds >= 16), u16-limb-wise
        carry_w = _marr(b, c, "carry_w", 2)
        w_lo, w_hi = limbs("w")
        w7_lo, w7_hi = limbs("w7")
        w16_lo, w16_hi = limbs("w16")
        b.assert_zero(gate16 * (w_lo + (1 << 16) * carry_w[0]
                                - sig1c[0] - w7_lo - sig0c[0] - w16_lo))
        b.assert_zero(gate16 * (w_hi + (1 << 16) * carry_w[1]
                                - sig1c[1] - w7_hi - sig0c[1] - w16_hi
                                - carry_w[0]))
        B.range_check(b, carry_w[0], 2, gate16)
        B.range_check(b, carry_w[1], 2, gate16)

        # round function, u16-limb-wise
        def bitfun_limb(expr_bit, half):
            acc = 0
            for i in range(16 * half, 16 * half + 16):
                acc = acc + (1 << (i - 16 * half)) * expr_bit(i)
            return acc

        def S1_bit(i):
            return _xor3(rotr_bit(bits["e1"], i, 6),
                         rotr_bit(bits["e1"], i, 11),
                         rotr_bit(bits["e1"], i, 25))

        def S0_bit(i):
            return _xor3(rotr_bit(bits["a1"], i, 2),
                         rotr_bit(bits["a1"], i, 13),
                         rotr_bit(bits["a1"], i, 22))

        def ch_bit(i):
            return (bits["e1"][i] * bits["e2"][i]
                    + (1 - bits["e1"][i]) * bits["e3"][i])

        def maj_bit(i):
            a1, a2, a3 = bits["a1"][i], bits["a2"][i], bits["a3"][i]
            return a1 * a2 + a1 * a3 + a2 * a3 - 2 * a1 * a2 * a3

        h_lo, h_hi = limbs("h")
        d_lo, d_hi = limbs("d")
        t1_lo = (h_lo + bitfun_limb(S1_bit, 0) + bitfun_limb(ch_bit, 0)
                 + k_lo + w_lo)
        t1_hi = (h_hi + bitfun_limb(S1_bit, 1) + bitfun_limb(ch_bit, 1)
                 + k_hi + w_hi)
        t2_lo = bitfun_limb(S0_bit, 0) + bitfun_limb(maj_bit, 0)
        t2_hi = bitfun_limb(S0_bit, 1) + bitfun_limb(maj_bit, 1)
        carry_a = _marr(b, c, "carry_a", 2)
        carry_e = _marr(b, c, "carry_e", 2)
        b.assert_zero(lo(bits["a"]) + (1 << 16) * carry_a[0]
                      - t1_lo - t2_lo)
        b.assert_zero(hi(bits["a"]) + (1 << 16) * carry_a[1]
                      - t1_hi - t2_hi - carry_a[0])
        b.assert_zero(lo(bits["e"]) + (1 << 16) * carry_e[0]
                      - d_lo - t1_lo)
        b.assert_zero(hi(bits["e"]) + (1 << 16) * carry_e[1]
                      - d_hi - t1_hi - carry_e[0])
        for cc in (carry_a[0], carry_a[1], carry_e[0], carry_e[1]):
            B.range_check(b, cc, 4, 1)

        # final hash out = h0 + post-round-63 state (on round-63 rows)
        out_bytes = _marr(b, c, "out_bytes", 4 * HASH_WORDS)
        out_carry = _marr(b, c, "out_carry", 2 * HASH_WORDS)
        last_f = flags[NUM_ROUNDS - 1]
        post = [bits["a"], bits["a1"], bits["a2"], bits["a3"],
                bits["e"], bits["e1"], bits["e2"], bits["e3"]]
        for i in range(HASH_WORDS):
            b.assert_bool(out_carry[2 * i])
            b.assert_bool(out_carry[2 * i + 1])
            o_lo = out_bytes[4 * i] + 256 * out_bytes[4 * i + 1]
            o_hi = out_bytes[4 * i + 2] + 256 * out_bytes[4 * i + 3]
            b.assert_zero(last_f * (o_lo + (1 << 16) * out_carry[2 * i]
                                    - h0c[2 * i] - lo(post[i])))
            b.assert_zero(last_f * (o_hi + (1 << 16) * out_carry[2 * i + 1]
                                    - h0c[2 * i + 1] - hi(post[i])
                                    - out_carry[2 * i]))
            B.byte_pair_check(b, out_bytes[4 * i], out_bytes[4 * i + 1],
                              mult * last_f)
            B.byte_pair_check(b, out_bytes[4 * i + 2], out_bytes[4 * i + 3],
                              mult * last_f)

        # bus: tagged request pair (0: input binding at round 15;
        # 1: output binding at round 63), same block-constant multiplicity
        w_msg = []
        for k in range(15, 0, -1):
            w_msg.extend(limbs(f"w{k}"))
        w_msg.extend(limbs("w"))
        b.push_receive(SHA_BUS, [0] + list(h0c) + w_msg,
                       mult * flags[15])
        out_limbs = []
        for i in range(HASH_WORDS):
            out_limbs.append(out_bytes[4 * i] + 256 * out_bytes[4 * i + 1])
            out_limbs.append(out_bytes[4 * i + 2]
                             + 256 * out_bytes[4 * i + 3])
        b.push_receive(SHA_BUS, [1] + list(h0c) + out_limbs,
                       mult * last_f)

    # -- tracegen --------------------------------------------------------
    def trace(self, rec) -> np.ndarray:
        states = rec["state"] if rec else []
        wordss = rec["words"] if rec else []
        n_blocks = len(states)
        rows_per = NUM_ROUNDS
        n_used = n_blocks * rows_per
        height = max(1 << max((n_used - 1).bit_length(), 0), 64) \
            if n_used else 64
        total_blocks = (height + rows_per - 1) // rows_per
        t = np.zeros((total_blocks * rows_per, self.width), dtype=np.uint64)
        c = self.c
        for blk in range(total_blocks):
            if blk < n_blocks:
                state = [int(v) for v in states[blk]]
                words = [int(v) for v in wordss[blk]]
            else:
                state, words = [0] * 8, [0] * 16
            out, (a_h, e_h), w = sha_compress(state, words)
            r0 = blk * rows_per
            a_seq = list(state[2::-1]) + a_h     # a_{-3}..a_{63} shifted
            e_seq = list(state[6:3:-1]) + e_h
            # a_seq[k+3] = a_k; pre-pends give chained copies at row 0
            for r in range(rows_per):
                row = r0 + r
                t[row, c.index["flags"] + r] = 1
                if blk < n_blocks:
                    t[row, c.index["mult"]] = 1
                for i in range(HASH_WORDS):
                    t[row, c.index["h0"] + 2 * i] = state[i] & 0xFFFF
                    t[row, c.index["h0"] + 2 * i + 1] = state[i] >> 16

                def put_bits(nm, v):
                    for i in range(32):
                        t[row, c.index[f"{nm}_bits"] + i] = (v >> i) & 1

                put_bits("a", a_seq[r + 3])
                put_bits("a1", a_seq[r + 2])
                put_bits("a2", a_seq[r + 1])
                put_bits("a3", a_seq[r])
                put_bits("e", e_seq[r + 3])
                put_bits("e1", e_seq[r + 2])
                put_bits("e2", e_seq[r + 1])
                put_bits("e3", e_seq[r])
                d_v = a_seq[r - 1] if r >= 1 else state[3]
                h_v = e_seq[r - 1] if r >= 1 else state[7]
                t[row, c.index["d"]] = d_v & 0xFFFF
                t[row, c.index["d"] + 1] = d_v >> 16
                t[row, c.index["h"]] = h_v & 0xFFFF
                t[row, c.index["h"] + 1] = h_v >> 16
                t[row, c.index["w"]] = w[r] & 0xFFFF
                t[row, c.index["w"] + 1] = w[r] >> 16
                for k in range(1, 17):
                    wv = w[r - k] if r - k >= 0 else 0
                    t[row, c.index[f"w{k}"]] = wv & 0xFFFF
                    t[row, c.index[f"w{k}"] + 1] = wv >> 16
                w2v = w[r - 2] if r >= 2 else 0
                w15v = w[r - 15] if r >= 15 else 0
                for i in range(32):
                    t[row, c.index["w2_bits"] + i] = (w2v >> i) & 1
                    t[row, c.index["w15_bits"] + i] = (w15v >> i) & 1
                # carries (u16-limb-wise, matching the AIR equations)
                e1v, e2v, e3v = e_seq[r + 2], e_seq[r + 1], e_seq[r]
                a1v, a2v, a3v = a_seq[r + 2], a_seq[r + 1], a_seq[r]
                S1 = _rotr(e1v, 6) ^ _rotr(e1v, 11) ^ _rotr(e1v, 25)
                chv = (e1v & e2v) ^ ((~e1v & e3v) & M32)
                S0 = _rotr(a1v, 2) ^ _rotr(a1v, 13) ^ _rotr(a1v, 22)
                majv = (a1v & a2v) ^ (a1v & a3v) ^ (a2v & a3v)
                t1_lo = ((h_v & 0xFFFF) + (S1 & 0xFFFF) + (chv & 0xFFFF)
                         + (K[r] & 0xFFFF) + (w[r] & 0xFFFF))
                t1_hi = ((h_v >> 16) + (S1 >> 16) + (chv >> 16)
                         + (K[r] >> 16) + (w[r] >> 16))
                t2_lo = (S0 & 0xFFFF) + (majv & 0xFFFF)
                t2_hi = (S0 >> 16) + (majv >> 16)
                a_new, e_new = a_seq[r + 3], e_seq[r + 3]
                ca0 = (t1_lo + t2_lo - (a_new & 0xFFFF)) >> 16
                ca1 = (t1_hi + t2_hi + ca0 - (a_new >> 16)) >> 16
                ce0 = ((d_v & 0xFFFF) + t1_lo - (e_new & 0xFFFF)) >> 16
                ce1 = ((d_v >> 16) + t1_hi + ce0 - (e_new >> 16)) >> 16
                t[row, c.index["carry_a"]] = ca0
                t[row, c.index["carry_a"] + 1] = ca1
                t[row, c.index["carry_e"]] = ce0
                t[row, c.index["carry_e"] + 1] = ce1
                s0v = _rotr(w15v, 7) ^ _rotr(w15v, 18) ^ (w15v >> 3)
                s1v = _rotr(w2v, 17) ^ _rotr(w2v, 19) ^ (w2v >> 10)
                t[row, c.index["sig0"]] = s0v & 0xFFFF
                t[row, c.index["sig0"] + 1] = s0v >> 16
                t[row, c.index["sig1"]] = s1v & 0xFFFF
                t[row, c.index["sig1"] + 1] = s1v >> 16
                if r >= 16:
                    w7v = w[r - 7]
                    w16v = w[r - 16]
                    cw0 = ((s1v & 0xFFFF) + (w7v & 0xFFFF) + (s0v & 0xFFFF)
                           + (w16v & 0xFFFF) - (w[r] & 0xFFFF)) >> 16
                    cw1 = ((s1v >> 16) + (w7v >> 16) + (s0v >> 16)
                           + (w16v >> 16) + cw0 - (w[r] >> 16)) >> 16
                    t[row, c.index["carry_w"]] = cw0
                    t[row, c.index["carry_w"] + 1] = cw1
                if r == rows_per - 1:
                    postv = [a_seq[66], a_seq[65], a_seq[64], a_seq[63],
                             e_seq[66], e_seq[65], e_seq[64], e_seq[63]]
                    for i in range(HASH_WORDS):
                        for j in range(4):
                            t[row, c.index["out_bytes"] + 4 * i + j] = \
                                (out[i] >> (8 * j)) & 0xFF
                        oc0 = ((state[i] & 0xFFFF) + (postv[i] & 0xFFFF)
                               - (out[i] & 0xFFFF)) >> 16
                        oc1 = ((state[i] >> 16) + (postv[i] >> 16) + oc0
                               - (out[i] >> 16)) >> 16
                        t[row, c.index["out_carry"] + 2 * i] = oc0
                        t[row, c.index["out_carry"] + 2 * i + 1] = oc1
        return _pad_pow2(t[:height])


# ---------------------------------------------------------------------------
# sponge / memory VM chip
# ---------------------------------------------------------------------------


class Sha256VmAir(Air):
    """One row per 64-byte block of a SHA256 instruction.

    Block kinds (driven by rem = bytes remaining at block start):
      full:  rem >= 64 — 64 data bytes;           next.rem = rem - 64
      C:     56 <= rem <= 63 — data + 0x80 + zeros (length does not fit);
             the next block is a pure-padding last block (pad80prev=1)
      last:  rem <= 55 (or pad80prev: rem = 0) — data, 0x80 unless already
             emitted, zeros, 8-byte big-endian bit length; digest written.
    """

    name = "sha256_sponge"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_first"), c.alloc("is_last")
        c.alloc("is_c"), c.alloc("pad80prev")
        c.alloc("pc"), c.alloc("ts")
        c.alloc("a_idx"), c.alloc("b_idx"), c.alloc("c_idx")
        c.alloc("dstp", 4), c.alloc("srcp", 4), c.alloc("lenp", 4)
        for tag in ("rdst", "rsrc", "rlen"):
            c.alloc(f"pts_{tag}"), c.alloc(f"dlo_{tag}"), \
                c.alloc(f"dhi_{tag}")
        c.alloc("wa_dst_lo"), c.alloc("wa_dst_hi")
        c.alloc("wa_src_lo"), c.alloc("wa_src_hi")
        c.alloc("src_cur"), c.alloc("rem"), c.alloc("total_len")
        c.alloc("rem_lo"), c.alloc("rem_hi")
        c.alloc("mem_bytes", BLOCK_BYTES)
        c.alloc("block_bytes", BLOCK_BYTES)
        c.alloc("is_pad", BLOCK_BYTES)
        c.alloc("bl", 4)                      # bit-length bytes (BE order)
        # unaligned-source window (same access-adapter role as the keccak
        # sponge: whole-word reads + one-hot byte-offset selection)
        c.alloc("off_f", 4)
        c.alloc("win_bytes", 4 * W_WINDOW)
        c.alloc("rdw", W_WINDOW)
        c.alloc("pts_w", W_WINDOW)
        c.alloc("dlo_w", W_WINDOW), c.alloc("dhi_w", W_WINDOW)
        c.alloc("h0", 2 * HASH_WORDS)
        c.alloc("out", 2 * HASH_WORDS)
        c.alloc("dig_hi", 2 * HASH_WORDS)     # high byte of each out limb
        c.alloc("doff_f", 4)
        c.alloc("wrb", 4 * D_WINDOW)
        c.alloc("wr8")
        c.alloc("prevw", 4 * D_WINDOW)
        c.alloc("pts_wr", D_WINDOW)
        c.alloc("dlo_wr", D_WINDOW), c.alloc("dhi_wr", D_WINDOW)
        self.width = c.width

    def eval(self, b):
        c = self.c
        v = _m(b, c, "is_valid")
        first = _m(b, c, "is_first")
        last = _m(b, c, "is_last")
        is_c = _m(b, c, "is_c")
        p80 = _m(b, c, "pad80prev")
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        for col in (v, first, last, is_c, p80):
            b.assert_bool(col)
        b.assert_zero(first * (1 - v))
        b.assert_zero(last * (1 - v))
        b.assert_zero(is_c * (1 - v))
        b.assert_zero(is_c * last)
        b.assert_zero(p80 * (1 - last))        # pure-length block is last
        full = v - last - is_c                 # bool by the above
        b.assert_bool(full)

        a_idx, b_idx, c_idx = (_m(b, c, "a_idx"), _m(b, c, "b_idx"),
                               _m(b, c, "c_idx"))
        dstp = _marr(b, c, "dstp", 4)
        srcp = _marr(b, c, "srcp", 4)
        lenp = _marr(b, c, "lenp", 4)
        vf = v * first

        B.fetch(b, pc, Rv32Sha256Opcode.SHA256,
                [4 * a_idx, 4 * b_idx, 4 * c_idx, 1, 2, 0, 0], vf)
        B.exec_receive(b, pc, ts, vf)
        B.exec_send(b, pc + 4, ts + TS_PER_BLOCK, v * last)

        for tag, idx, limbs_, tick in (("rdst", a_idx, dstp, 0),
                                       ("rsrc", b_idx, srcp, 1),
                                       ("rlen", c_idx, lenp, 2)):
            B.mem_read(b, B.AS_REGISTER, idx, limbs_,
                       _m(b, c, f"pts_{tag}"), ts + tick,
                       _m(b, c, f"dlo_{tag}"), _m(b, c, f"dhi_{tag}"), vf)
        for limbs_ in (dstp, srcp, lenp):
            B.range_check(b, limbs_[3], 5, vf)

        def u32(limbs_):
            return (limbs_[0] + 256 * limbs_[1] + 65536 * limbs_[2]
                    + (1 << 24) * limbs_[3])

        src_cur = _m(b, c, "src_cur")
        rem = _m(b, c, "rem")
        total_len = _m(b, c, "total_len")
        b.assert_zero(vf * (src_cur - u32(srcp)))
        b.assert_zero(vf * (rem - u32(lenp)))
        b.assert_zero(vf * (total_len - u32(lenp)))

        off_f = _marr(b, c, "off_f", 4)
        for k in range(4):
            b.assert_bool(off_f[k])
        b.assert_zero(v * (1 - sum(off_f)))
        off = sum(k * off_f[k] for k in range(1, 4))
        wsl, wsh = _m(b, c, "wa_src_lo"), _m(b, c, "wa_src_hi")
        b.assert_zero(v * (src_cur - off - 4 * (wsl + (1 << 15) * wsh)))
        B.range_check(b, wsl, 15, v)
        B.range_check(b, wsh, 12, v)
        wa_src = wsl + (1 << 15) * wsh
        rem_lo, rem_hi = _m(b, c, "rem_lo"), _m(b, c, "rem_hi")
        b.assert_zero(v * (rem - rem_lo - (1 << 15) * rem_hi))
        B.range_check(b, rem_lo, 15, v)
        B.range_check(b, rem_hi, 14, v)
        # kind ranges: C needs 56 <= rem <= 63; last (without pad80prev)
        # needs rem <= 55; pad80prev needs rem = 0.  full needs rem >= 64,
        # enforced transitively: next.rem = rem - 64 is 29-bit range
        # checked every row, so an underfull "full" block wraps to ~P and
        # fails the next row's decomposition.
        B.range_check(b, rem - 56, 3, is_c)
        B.range_check(b, 63 - rem, 3, is_c)
        B.range_check(b, 55 - rem, 6, last * (1 - p80))
        b.assert_zero(p80 * rem)

        # padding structure
        is_pad = _marr(b, c, "is_pad", BLOCK_BYTES)
        mem_bytes = _marr(b, c, "mem_bytes", BLOCK_BYTES)
        block_bytes = _marr(b, c, "block_bytes", BLOCK_BYTES)
        bl = _marr(b, c, "bl", 4)
        for j in range(BLOCK_BYTES):
            b.assert_bool(is_pad[j])
        for j in range(BLOCK_BYTES - 1):
            b.assert_zero(is_pad[j] * (1 - is_pad[j + 1]))
        # bit length = 8 * total_len, big-endian bytes bl[0..3] at 60..63
        B.byte_pair_check(b, bl[0], bl[1], v * last)
        B.byte_pair_check(b, bl[2], bl[3], v * last)
        b.assert_zero(v * last * (8 * total_len - (1 << 24) * bl[0]
                                  - (1 << 16) * bl[1] - (1 << 8) * bl[2]
                                  - bl[3]))
        for j in range(BLOCK_BYTES):
            fp = is_pad[j] - (is_pad[j - 1] if j else 0)
            pad_val = 0x80 * fp * (1 - p80)
            if j >= 60:
                pad_val = pad_val + last * bl[j - 60]
            b.assert_zero(is_pad[j] * (block_bytes[j] - pad_val))
            b.assert_zero((1 - is_pad[j]) * (mem_bytes[j] - block_bytes[j]))
        real = sum(1 - is_pad[j] for j in range(BLOCK_BYTES))
        b.assert_zero(full * (BLOCK_BYTES - real))
        b.assert_zero((last + is_c) * (real - rem))

        # window word reads: word w is read iff it holds a real byte
        # (see the keccak sponge for the derivation of the gate)
        win = _marr(b, c, "win_bytes", 4 * W_WINDOW)
        rdw = _marr(b, c, "rdw", W_WINDOW)
        for w in range(W_WINDOW):
            sel = 0
            for k in range(4):
                idx = 4 * w - k
                if idx > BLOCK_BYTES - 1:
                    continue
                sel = sel + off_f[k] * (1 - is_pad[max(idx, 0)])
            b.assert_zero(rdw[w] - sel)
            B.mem_read(b, B.AS_MEMORY, wa_src + w,
                       win[4 * w:4 * w + 4],
                       b.main(c.index["pts_w"] + w), ts + 3 + w,
                       b.main(c.index["dlo_w"] + w),
                       b.main(c.index["dhi_w"] + w), v * rdw[w])
        # real block bytes come from the window at offset off
        for j in range(BLOCK_BYTES):
            pick = sum(off_f[k] * win[j + k] for k in range(4))
            b.assert_zero((1 - is_pad[j]) * (mem_bytes[j] - pick))

        # state: first block starts from the SHA-256 IV
        h0c = _marr(b, c, "h0", 2 * HASH_WORDS)
        outc = _marr(b, c, "out", 2 * HASH_WORDS)
        for i in range(HASH_WORDS):
            b.assert_zero(vf * (h0c[2 * i] - (H0[i] & 0xFFFF)))
            b.assert_zero(vf * (h0c[2 * i + 1] - (H0[i] >> 16)))

        # table requests: block words are big-endian byte compositions
        w_msg = []
        for w in range(BLOCK_WORDS):
            w_msg.append(256 * block_bytes[4 * w + 2]
                         + block_bytes[4 * w + 3])   # lo limb
            w_msg.append(256 * block_bytes[4 * w]
                         + block_bytes[4 * w + 1])   # hi limb
        b.push_send(SHA_BUS, [0] + list(h0c) + w_msg, v)
        b.push_send(SHA_BUS, [1] + list(h0c) + list(outc), v)

        # chaining
        cont = v * (1 - last)

        def nxt(name, i=0):
            return b.main(c.index[name] + i, 1)

        b.assert_zero(cont * (1 - nxt("is_valid")))
        b.assert_zero(cont * nxt("is_first"))
        b.assert_zero(cont * (nxt("pc") - pc))
        b.assert_zero(cont * (nxt("ts") - ts - TS_PER_BLOCK))
        b.assert_zero(cont * (nxt("src_cur") - src_cur - BLOCK_BYTES))
        b.assert_zero(cont * (nxt("total_len") - total_len))
        # rem chain: full -> rem - 64; C -> 0 and next is the pure-length
        # last block
        b.assert_zero(full * (1 - last) * (nxt("rem") - rem + BLOCK_BYTES))
        b.assert_zero(is_c * nxt("rem"))
        b.assert_zero(is_c * (1 - nxt("pad80prev")))
        b.assert_zero(full * nxt("pad80prev"))
        for i in range(4):
            b.assert_zero(cont * (nxt("dstp", i) - dstp[i]))
        for i in range(2 * HASH_WORDS):
            b.assert_zero(cont * (nxt("h0", i) - outc[i]))
        b.assert_zero(b.is_first_row() * v * (1 - first))
        b.assert_zero(b.is_transition()
                      * (nxt("is_first") - (nxt("is_valid") - cont)))
        b.assert_zero(b.is_transition() * (1 - v) * nxt("is_valid"))

        # digest writes (big-endian bytes of out words) at ticks 20..28:
        # dst = 4*wa_dst + doff may be byte-aligned — read-modify-write a
        # DIGEST_WORDS+1 word window, preserving previous memory bytes
        # outside [doff, doff+32) (write-side access-adapter role,
        # reference system/memory/adapter/mod.rs:45-51; same scheme as
        # keccak.py).
        wdl, wdh = _m(b, c, "wa_dst_lo"), _m(b, c, "wa_dst_hi")
        vl = v * last
        doff_f = _marr(b, c, "doff_f", 4)
        for k in range(4):
            b.assert_bool(doff_f[k])
        b.assert_zero(sum(doff_f) - vl)  # one-hot exactly on last rows
        doff = sum(k * doff_f[k] for k in range(1, 4))
        b.assert_zero(vl * (u32(dstp) - doff
                            - 4 * (wdl + (1 << 15) * wdh)))
        B.range_check(b, wdl, 15, vl)
        B.range_check(b, wdh, 12, vl)
        wa_dst = wdl + (1 << 15) * wdh
        dig_hi = _marr(b, c, "dig_hi", 2 * HASH_WORDS)
        prevw = _marr(b, c, "prevw", 4 * D_WINDOW)
        wrb = _marr(b, c, "wrb", 4 * D_WINDOW)
        for m in range(2 * HASH_WORDS):
            B.byte_pair_check(b, outc[m] - 256 * dig_hi[m], dig_hi[m], vl)
        # digest byte stream: big-endian bytes of each out word
        dig_bytes = []
        for w in range(DIGEST_WORDS):
            lo0 = outc[2 * w] - 256 * dig_hi[2 * w]        # lo limb bytes
            lo1 = outc[2 * w + 1] - 256 * dig_hi[2 * w + 1]  # hi limb
            dig_bytes += [dig_hi[2 * w + 1], lo1, dig_hi[2 * w], lo0]
        for j in range(4 * D_WINDOW):
            b.assert_zero(sum(
                doff_f[o] * (wrb[j] - (dig_bytes[j - o]
                                       if 0 <= j - o < 4 * DIGEST_WORDS
                                       else prevw[j]))
                for o in range(4)))
        wr8 = _m(b, c, "wr8")
        b.assert_bool(wr8)
        b.assert_zero(wr8 - vl * (1 - doff_f[0]))
        for w in range(D_WINDOW):
            B.mem_write(b, B.AS_MEMORY, wa_dst + w, wrb[4 * w:4 * w + 4],
                        prevw[4 * w:4 * w + 4],
                        b.main(c.index["pts_wr"] + w),
                        ts + 3 + W_WINDOW + w,
                        b.main(c.index["dlo_wr"] + w),
                        b.main(c.index["dhi_wr"] + w),
                        wr8 if w == DIGEST_WORDS else vl,
                        check_bytes=False)

    # -- tracegen --------------------------------------------------------
    def trace(self, rec) -> np.ndarray:
        n = len(rec["pc"]) if rec else 0
        c = self.c
        t = np.zeros((max(n, 1), self.width), dtype=np.uint64)
        if n == 0:
            return _pad_pow2(t)

        ts = np.asarray(rec["ts"], dtype=np.uint64)
        t[:n, c.index["is_valid"]] = 1
        for nm in ("is_first", "is_last", "is_c", "pad80prev"):
            t[:n, c.index[nm]] = rec[nm]
        t[:n, c.index["pc"]] = rec["pc"]
        t[:n, c.index["ts"]] = ts
        for nm in ("a_idx", "b_idx", "c_idx"):
            t[:n, c.index[nm]] = np.asarray(rec[nm])
        isf = np.asarray(rec["is_first"], dtype=np.uint64)
        isl = np.asarray(rec["is_last"], dtype=np.uint64)
        for nm in ("dstp", "srcp", "lenp"):
            t[:n, c.index[nm]:c.index[nm] + 4] = \
                np.asarray(rec[nm], dtype=np.uint64)
        pts_regs = np.asarray(rec["pts_regs"], dtype=np.uint64)
        for k, tag in enumerate(("rdst", "rsrc", "rlen")):
            t[:n, c.index[f"pts_{tag}"]] = pts_regs[:, k]
            d = np.where(isf != 0, (ts + k - pts_regs[:, k] - 1) % P, 0)
            t[:n, c.index[f"dlo_{tag}"]] = d & 0x7FFF
            t[:n, c.index[f"dhi_{tag}"]] = d >> 15
        src_cur = np.asarray(rec["src_cur"], dtype=np.uint64)
        rem = np.asarray(rec["rem"], dtype=np.uint64)
        t[:n, c.index["src_cur"]] = src_cur
        t[:n, c.index["rem"]] = rem
        t[:n, c.index["total_len"]] = rec["total_len"]
        t[:n, c.index["rem_lo"]] = rem & 0x7FFF
        t[:n, c.index["rem_hi"]] = rem >> 15
        t[:n, c.index["wa_src_lo"]] = (src_cur // 4) & 0x7FFF
        t[:n, c.index["wa_src_hi"]] = (src_cur // 4) >> 15
        off = (src_cur & 3).astype(np.int64)
        for k in range(4):
            t[:n, c.index["off_f"] + k] = (off == k)
        dstp = np.asarray(rec["dstp"], dtype=np.uint64)
        dst_u32 = sum(dstp[:, i] << np.uint64(8 * i) for i in range(4))
        t[:n, c.index["wa_dst_lo"]] = np.where(isl != 0,
                                               (dst_u32 // 4) & 0x7FFF, 0)
        t[:n, c.index["wa_dst_hi"]] = np.where(isl != 0,
                                               (dst_u32 // 4) >> 15, 0)
        mem_bytes = np.asarray(rec["mem_bytes"], dtype=np.uint64)
        blockb = np.asarray(rec["block_bytes"], dtype=np.uint64)
        pad_start = np.asarray(rec["pad_start"])
        t[:n, c.index["mem_bytes"]:c.index["mem_bytes"] + BLOCK_BYTES] = \
            mem_bytes
        t[:n, c.index["block_bytes"]:c.index["block_bytes"] + BLOCK_BYTES] \
            = blockb
        js = np.arange(BLOCK_BYTES)
        is_pad = (js[None, :] >= pad_start[:, None]).astype(np.uint64)
        t[:n, c.index["is_pad"]:c.index["is_pad"] + BLOCK_BYTES] = is_pad
        tl = np.asarray(rec["total_len"], dtype=np.uint64)
        for k in range(4):
            t[:n, c.index["bl"] + k] = np.where(
                isl != 0, (8 * tl >> np.uint64(8 * (3 - k))) & 0xFF, 0)
        win_bytes = np.asarray(rec["win_bytes"], dtype=np.uint64)
        t[:n, c.index["win_bytes"]:c.index["win_bytes"] + 4 * W_WINDOW] = \
            win_bytes
        pts_w = np.asarray(rec["pts_w"], dtype=np.uint64)
        for w in range(W_WINDOW):
            idx = np.maximum(4 * w - off, 0)
            gates = (4 * w - off <= BLOCK_BYTES - 1) & (idx < pad_start)
            t[:n, c.index["rdw"] + w] = gates
            t[:n, c.index["pts_w"] + w] = pts_w[:, w]
            d = np.where(gates, (ts + 3 + w - pts_w[:, w] - 1) % P, 0)
            t[:n, c.index["dlo_w"] + w] = d & 0x7FFF
            t[:n, c.index["dhi_w"] + w] = d >> 15
        st_in = np.asarray(rec["state_in"], dtype=np.uint64)   # (n, 8)
        st_out = np.asarray(rec["state_out"], dtype=np.uint64)
        for i in range(HASH_WORDS):
            t[:n, c.index["h0"] + 2 * i] = st_in[:, i] & 0xFFFF
            t[:n, c.index["h0"] + 2 * i + 1] = st_in[:, i] >> 16
            t[:n, c.index["out"] + 2 * i] = st_out[:, i] & 0xFFFF
            t[:n, c.index["out"] + 2 * i + 1] = st_out[:, i] >> 16
        outl = t[:n, c.index["out"]:c.index["out"] + 2 * HASH_WORDS]
        t[:n, c.index["dig_hi"]:c.index["dig_hi"] + 2 * HASH_WORDS] = \
            np.where(isl[:, None] != 0, outl >> 8, 0)
        doff = (dst_u32 & 3).astype(np.int64)
        for k in range(4):
            t[:n, c.index["doff_f"] + k] = (doff == k) & (isl != 0)
        t[:n, c.index["wr8"]] = (doff > 0) & (isl != 0)
        t[:n, c.index["wrb"]:c.index["wrb"] + 4 * D_WINDOW] = \
            np.asarray(rec["wrb"], dtype=np.uint64).reshape(n, -1)
        prevw = np.asarray(rec["prevw"], dtype=np.uint64).reshape(n, -1)
        t[:n, c.index["prevw"]:c.index["prevw"] + 4 * D_WINDOW] = prevw
        pts_wr = np.asarray(rec["pts_wr"], dtype=np.uint64)
        wr_gate = [(isl != 0) if w < DIGEST_WORDS
                   else ((isl != 0) & (doff > 0)) for w in range(D_WINDOW)]
        for w in range(D_WINDOW):
            t[:n, c.index["pts_wr"] + w] = pts_wr[:, w]
            d = np.where(wr_gate[w],
                         (ts + 3 + W_WINDOW + w - pts_wr[:, w] - 1) % P,
                         0)
            t[:n, c.index["dlo_wr"] + w] = d & 0x7FFF
            t[:n, c.index["dhi_wr"] + w] = d >> 15
        return _pad_pow2(t)


SHA256_AIRS = {"sha256_sponge": Sha256VmAir, "sha256": Sha256Air}
