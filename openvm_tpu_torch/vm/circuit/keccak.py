"""Keccak256 extension: keccak-f[1600] round table + sponge/memory chip.

Copy of openvm_tpu/vm/circuit/keccak.py (the whole module: KeccakfAir,
KeccakVmAir, the host keccak_f, keccak256 and pad_blocks).

TPU-native re-design of the reference keccak256 extension
(reference extensions/keccak256/circuit/src/air.rs — a single fused trace of
24 rows per 136-byte block carrying both the p3-keccak-air permutation
columns and the sponge/memory columns).  Here the two roles are separate
chips connected by KECCAK_BUS, the same periphery pattern as the system
Poseidon2 chip:

  KeccakfAir    24 rows per permutation, one row per round, p3-keccak-air
                style bit decomposition (theta parity bits c/c', post-theta
                bits a', post-chi limbs a''); receives
                (state_in[100] || state_out[100]) u16-limb requests on
                KECCAK_BUS on each round-23 row with a multiplicity column.
                The whole trace is permutation rounds — padding blocks are
                real permutations of the zero state with multiplicity 0, so
                none of the round math needs a validity gate (keeps every
                constraint at degree <= 3).

  KeccakVmAir   one row per 136-byte rate block: instruction + register
                reads (first block), gated absorb word-reads, keccak
                pad10*1 padding byte constraints, byte-level absorb XOR via
                the bitwise lookup bus, digest word-writes (last block),
                and the permutation request send.

This split vectorizes tracegen cleanly (all blocks' rounds computed in one
numpy pass) instead of the reference's row-serial sponge fill.

Instruction: KECCAK256 (0x310) a=4*rd b=4*rs1 c=4*rs2 d=1 e=2
  dst = u32 regs[rd], src = u32 regs[rs1], len = u32 regs[rs2];
  digest = keccak256(mem[src .. src+len]); mem[dst .. dst+32] = digest.
src and dst may be byte-aligned: memory stays word-granular (no
byte-level bus traffic) and the chip reads/writes whole-word WINDOWS,
selecting bytes in-circuit — the access-adapter role of reference
system/memory/adapter/mod.rs covered for both sides.

Timestamp schedule per block: register reads at ticks 0..2 (first block),
35 window word reads at ticks 3..37 (gated), 9 digest window writes at
ticks 38..46 (last block, word 9 gated on doff>0); ts advances 47 per
block row.
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..instructions import Rv32KeccakOpcode
from . import buses as B
from .buses import Cols
from .rv32im import _m, _marr, _pad_pow2

P = 2013265921
KECCAK_BUS = 7

RATE_BYTES = 136
RATE_U16S = RATE_BYTES // 2          # 68
RATE_WORDS = RATE_BYTES // 4         # 34
W_WINDOW = RATE_WORDS + 1            # 35: unaligned blocks span one extra word
NUM_ROUNDS = 24
U64_LIMBS = 4                        # u16 limbs per lane
NUM_LANES = 25
STATE_U16S = NUM_LANES * U64_LIMBS   # 100
DIGEST_WORDS = 8
D_WINDOW = DIGEST_WORDS + 1          # 9: unaligned digests span one extra word
TS_PER_BLOCK = 3 + W_WINDOW + D_WINDOW  # 47

ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y] (keccak rho)
_R = [[0, 36, 3, 41, 18],
      [1, 44, 10, 45, 2],
      [62, 6, 43, 15, 61],
      [28, 55, 25, 21, 56],
      [27, 20, 39, 8, 14]]
ROT = [[_R[x][y] % 64 for y in range(5)] for x in range(5)]


# ---------------------------------------------------------------------------
# host keccak (reference semantics; also used by E1 + preflight + tracegen)
# ---------------------------------------------------------------------------


def _rotl(v, r):
    r %= 64
    m = (1 << 64) - 1
    return ((v << r) | (v >> (64 - r))) & m


def keccak_round(lanes, rc):
    """One keccak-f round on a flat [25] lane list (index = x + 5*y)."""
    a = [[lanes[x + 5 * y] for y in range(5)] for x in range(5)]
    c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
    d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
    ap = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
    # rho + pi: B[y][(2x+3y)%5] = rot(A'[x][y], r[x][y])
    bm = [[0] * 5 for _ in range(5)]
    for x in range(5):
        for y in range(5):
            bm[y][(2 * x + 3 * y) % 5] = _rotl(ap[x][y], ROT[x][y])
    m = (1 << 64) - 1
    out = [[bm[x][y] ^ ((~bm[(x + 1) % 5][y] & m) & bm[(x + 2) % 5][y])
            for y in range(5)] for x in range(5)]
    out[0][0] ^= rc
    return [out[x][y] for y in range(5) for x in range(5)]


def keccak_f(lanes):
    for rc in ROUND_CONSTANTS:
        lanes = keccak_round(lanes, rc)
    return lanes


def keccak256(data: bytes) -> bytes:
    """keccak-256 (pad10*1, rate 136) of a byte string."""
    lanes = [0] * NUM_LANES
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(data) % RATE_BYTES)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len > 1 \
        else b"\x81"
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off:off + RATE_BYTES]
        for i in range(RATE_BYTES // 8):
            lanes[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        lanes = keccak_f(lanes)
    out = b"".join(lanes[i].to_bytes(8, "little") for i in range(4))
    return out


def pad_blocks(data: bytes):
    """Split input into rate blocks with pad10*1; returns
    [(block_bytes(136), pad_start)] — pad_start = index of first padding
    byte in this block (136 if none)."""
    n = len(data)
    nblocks = n // RATE_BYTES + 1
    out = []
    for bi in range(nblocks):
        chunk = data[bi * RATE_BYTES:(bi + 1) * RATE_BYTES]
        real = len(chunk)
        blk = bytearray(chunk) + bytearray(RATE_BYTES - real)
        if real < RATE_BYTES:
            blk[real] ^= 0x01
            blk[RATE_BYTES - 1] ^= 0x80
        out.append((bytes(blk), real))
    return out


def _xyz_pi_inv(xo, yo):
    """(x, y) such that rho/pi maps a'[x][y] -> b[xo][yo]."""
    y = xo
    x = (3 * (yo - 3 * y)) % 5
    return x, y


# ---------------------------------------------------------------------------
# keccak-f round-table AIR
# ---------------------------------------------------------------------------


def _xor2(p, q):
    return p + q - 2 * (p * q)


def _xor3(p, q, r):
    return (p + q + r - 2 * (p * q + p * r + q * r) + 4 * (p * q * r))


class KeccakfAir(Air):
    """One row per round; 24 consecutive rows prove one permutation.

    Column groups (p3-keccak-air structure, reference CUDA mirror
    extensions/keccak256/circuit/cuda/include/keccak256/columns.cuh):
      flags[24]      one-hot round counter, rotating through the trace
      mult           bus multiplicity on round-23 rows
      preimage[100]  block input state u16 limbs (constant through block)
      a[100]         round input state u16 limbs
      c[5][64], c_prime[5][64]   theta parity bits
      a_prime[5][5][64]          post-theta state bits
      a_pp[100]                  post-chi state u16 limbs
      a_pp_00_bits[64], a_ppp_00[4]   iota on lane (0,0)
    """

    name = "keccakf"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("flags", NUM_ROUNDS)
        c.alloc("mult")
        c.alloc("preimage", STATE_U16S)
        c.alloc("a", STATE_U16S)
        c.alloc("c", 5 * 64)
        c.alloc("c_prime", 5 * 64)
        c.alloc("a_prime", NUM_LANES * 64)
        c.alloc("a_pp", STATE_U16S)
        c.alloc("a_pp_00_bits", 64)
        c.alloc("a_ppp_00", U64_LIMBS)
        self.width = c.width

    # column accessors (flat lane index = x + 5*y)
    def _lane_limbs(self, b, base, x, y):
        i0 = self.c.index[base] + U64_LIMBS * (x + 5 * y)
        return [b.main(i0 + l) for l in range(U64_LIMBS)]

    def _cbit(self, b, base, x, z):
        return b.main(self.c.index[base] + 64 * x + z)

    def _abit(self, b, x, y, z):
        return b.main(self.c.index["a_prime"] + 64 * (x + 5 * y) + z)

    def eval(self, b):
        c = self.c
        flags = _marr(b, c, "flags", NUM_ROUNDS)
        mult = _m(b, c, "mult")

        for r in range(NUM_ROUNDS):
            b.assert_bool(flags[r])
        b.assert_eq(sum(flags), 1)
        b.assert_zero(b.is_first_row() * (1 - flags[0]))
        for r in range(NUM_ROUNDS):
            b.assert_zero(b.is_transition()
                          * (b.main(c.index["flags"]
                                    + (r + 1) % NUM_ROUNDS, 1) - flags[r]))
        b.assert_bool(mult)
        b.assert_zero(mult * (1 - flags[NUM_ROUNDS - 1]))

        # booleanity
        for x in range(5):
            for z in range(64):
                b.assert_bool(self._cbit(b, "c", x, z))
                b.assert_bool(self._cbit(b, "c_prime", x, z))
        for x in range(5):
            for y in range(5):
                for z in range(64):
                    b.assert_bool(self._abit(b, x, y, z))
        bits00 = _marr(b, c, "a_pp_00_bits", 64)
        for z in range(64):
            b.assert_bool(bits00[z])

        # c' definition: c'[x,z] = xor3(c[x,z], c[x-1,z], c[x+1,z-1])
        for x in range(5):
            for z in range(64):
                b.assert_zero(self._cbit(b, "c_prime", x, z) - _xor3(
                    self._cbit(b, "c", x, z),
                    self._cbit(b, "c", (x - 1) % 5, z),
                    self._cbit(b, "c", (x + 1) % 5, (z - 1) % 64)))

        # parity: xor_y a'[x,y,z] = c'[x,z]  (sum - c' in {0, 2, 4})
        for x in range(5):
            for z in range(64):
                s = sum(self._abit(b, x, y, z) for y in range(5))
                diff = s - self._cbit(b, "c_prime", x, z)
                b.assert_zero(diff * (diff - 2) * (diff - 4))

        # theta limb reconstruction:
        #   a[x,y] = recompose(xor3(a'[x,y,z], c[x,z], c'[x,z]))
        for x in range(5):
            for y in range(5):
                limbs = self._lane_limbs(b, "a", x, y)
                for l in range(U64_LIMBS):
                    acc = 0
                    for zl in range(16):
                        z = 16 * l + zl
                        acc = acc + (1 << zl) * _xor3(
                            self._abit(b, x, y, z),
                            self._cbit(b, "c", x, z),
                            self._cbit(b, "c_prime", x, z))
                    b.assert_zero(limbs[l] - acc)

        # chi: a''[x,y] = recompose(b ^ (~b1 & b2)) with b = rho/pi(a')
        def bbit(xo, yo, z):
            x, y = _xyz_pi_inv(xo, yo)
            return self._abit(b, x, y, (z - ROT[x][y]) % 64)

        for x in range(5):
            for y in range(5):
                limbs = self._lane_limbs(b, "a_pp", x, y)
                for l in range(U64_LIMBS):
                    acc = 0
                    for zl in range(16):
                        z = 16 * l + zl
                        b0 = bbit(x, y, z)
                        b1 = bbit((x + 1) % 5, y, z)
                        b2 = bbit((x + 2) % 5, y, z)
                        term = b0 + b2 - b1 * b2 - 2 * (b0 * b2) \
                            + 2 * (b0 * b1 * b2)
                        acc = acc + (1 << zl) * term
                    b.assert_zero(limbs[l] - acc)

        # iota on lane (0,0): bits match a'' limbs, output adds RC
        l00 = self._lane_limbs(b, "a_pp", 0, 0)
        for l in range(U64_LIMBS):
            acc = 0
            for zl in range(16):
                acc = acc + (1 << zl) * bits00[16 * l + zl]
            b.assert_zero(l00[l] - acc)
        out00 = _marr(b, c, "a_ppp_00", U64_LIMBS)
        for l in range(U64_LIMBS):
            acc = 0
            for zl in range(16):
                z = 16 * l + zl
                rc_bit = sum(flags[r] * ((ROUND_CONSTANTS[r] >> z) & 1)
                             for r in range(NUM_ROUNDS))
                acc = acc + (1 << zl) * _xor2(bits00[z], rc_bit)
            b.assert_zero(out00[l] - acc)

        # preimage constant within a block; round output chains to next row
        not_last_round = 1 - flags[NUM_ROUNDS - 1]
        trans = b.is_transition()
        for i in range(STATE_U16S):
            pre = b.main(c.index["preimage"] + i)
            b.assert_zero(trans * not_last_round
                          * (b.main(c.index["preimage"] + i, 1) - pre))
            # round 0 input is the preimage
            b.assert_zero(flags[0] * (b.main(c.index["a"] + i) - pre))

        def out_limb(i):
            lane, l = divmod(i, U64_LIMBS)
            if lane == 0:
                return out00[l]
            return b.main(c.index["a_pp"] + i)

        for i in range(STATE_U16S):
            b.assert_zero(trans * not_last_round
                          * (b.main(c.index["a"] + i, 1) - out_limb(i)))

        # bus: prove (preimage, output) pairs for the sponge chip
        msg = ([b.main(c.index["preimage"] + i) for i in range(STATE_U16S)]
               + [out_limb(i) for i in range(STATE_U16S)])
        b.push_receive(KECCAK_BUS, msg, mult)

    # -- tracegen --------------------------------------------------------
    def trace(self, rec) -> np.ndarray:
        states = rec["state_in"] if rec else []
        n_blocks = len(states)
        rows_per = NUM_ROUNDS
        n_used = n_blocks * rows_per
        height = max(1 << max((n_used - 1).bit_length(), 0), 32) \
            if n_used else 32
        total_blocks = (height + rows_per - 1) // rows_per
        lanes = np.zeros((total_blocks, NUM_LANES), dtype=np.uint64)
        for i, st in enumerate(states):
            lanes[i] = st
        t = np.zeros((total_blocks * rows_per, self.width), dtype=np.uint64)
        c = self.c

        cur = lanes.copy()
        for r in range(NUM_ROUNDS):
            rows = slice(r, total_blocks * rows_per, rows_per)
            t[rows, c.index["flags"] + r] = 1
            # per-lane limbs of preimage / round input
            for i in range(NUM_LANES):
                for l in range(U64_LIMBS):
                    t[rows, c.index["preimage"] + U64_LIMBS * i + l] = \
                        (lanes[:, i] >> np.uint64(16 * l)) & np.uint64(0xFFFF)
                    t[rows, c.index["a"] + U64_LIMBS * i + l] = \
                        (cur[:, i] >> np.uint64(16 * l)) & np.uint64(0xFFFF)
            ax = np.transpose(
                cur.reshape(total_blocks, 5, 5), (0, 2, 1))  # [b][x][y]
            cpar = ax[:, :, 0]
            for y in range(1, 5):
                cpar = cpar ^ ax[:, :, y]            # (B, 5)
            crot = ((cpar << np.uint64(1)) | (cpar >> np.uint64(63)))
            d = np.roll(cpar, 1, axis=1) ^ np.roll(crot, -1, axis=1)
            ap = ax ^ d[:, :, None]                  # (B, 5, 5) [b][x][y]
            cprime = d ^ cpar
            for x in range(5):
                for z in range(64):
                    t[rows, c.index["c"] + 64 * x + z] = \
                        (cpar[:, x] >> np.uint64(z)) & np.uint64(1)
                    t[rows, c.index["c_prime"] + 64 * x + z] = \
                        (cprime[:, x] >> np.uint64(z)) & np.uint64(1)
            for x in range(5):
                for y in range(5):
                    for z in range(64):
                        t[rows, c.index["a_prime"] + 64 * (x + 5 * y) + z] \
                            = (ap[:, x, y] >> np.uint64(z)) & np.uint64(1)
            # rho/pi
            bm = np.zeros_like(ap)
            for x in range(5):
                for y in range(5):
                    rr = np.uint64(ROT[x][y])
                    v = ap[:, x, y]
                    rot = v if ROT[x][y] == 0 else (
                        (v << rr) | (v >> np.uint64(64 - ROT[x][y])))
                    bm[:, y, (2 * x + 3 * y) % 5] = rot
            chi = np.zeros_like(bm)
            for x in range(5):
                for y in range(5):
                    chi[:, x, y] = bm[:, x, y] ^ (
                        ~bm[:, (x + 1) % 5, y] & bm[:, (x + 2) % 5, y])
            for x in range(5):
                for y in range(5):
                    for l in range(U64_LIMBS):
                        t[rows, c.index["a_pp"] + U64_LIMBS * (x + 5 * y)
                          + l] = (chi[:, x, y] >> np.uint64(16 * l)) \
                            & np.uint64(0xFFFF)
            out00 = chi[:, 0, 0] ^ np.uint64(ROUND_CONSTANTS[r])
            for z in range(64):
                t[rows, c.index["a_pp_00_bits"] + z] = \
                    (chi[:, 0, 0] >> np.uint64(z)) & np.uint64(1)
            for l in range(U64_LIMBS):
                t[rows, c.index["a_ppp_00"] + l] = \
                    (out00 >> np.uint64(16 * l)) & np.uint64(0xFFFF)
            nxt = chi.copy()
            nxt[:, 0, 0] = out00
            cur = np.transpose(nxt, (0, 2, 1)).reshape(
                total_blocks, NUM_LANES)
        t[:n_used, c.index["mult"]] = np.tile(
            np.eye(1, rows_per, rows_per - 1, dtype=np.uint64)[0], n_blocks)
        return _pad_pow2(t[:height])


# ---------------------------------------------------------------------------
# sponge / memory VM chip
# ---------------------------------------------------------------------------


class KeccakVmAir(Air):
    """One row per 136-byte rate block of a KECCAK256 instruction.

    Reference equivalent: the sponge/instruction/memory column groups of
    extensions/keccak256/circuit/src/air.rs (constrain_absorb,
    eval_instruction, constrain_input_read, constrain_output_write) —
    re-cut so the permutation lives in KeccakfAir behind KECCAK_BUS.

    Row chaining (valid rows of one instruction):
      is_first: register reads bind dst/src/len; state_in = 0;
                rem = len, src_cur = src.
      middle:   next.state_in = state_out, next.rem = rem - 136,
                next.src_cur = src_cur + 136, dstp chained down.
      is_last:  byte 135 is padding (so rem <= 135), digest written.
    Padding rows (is_valid = 0) are all-zero.
    """

    name = "keccak_sponge"

    def __init__(self):
        c = self.c = Cols()
        c.alloc("is_valid"), c.alloc("is_first"), c.alloc("is_last")
        c.alloc("pc"), c.alloc("ts")
        c.alloc("a_idx"), c.alloc("b_idx"), c.alloc("c_idx")
        c.alloc("dstp", 4), c.alloc("srcp", 4), c.alloc("lenp", 4)
        for tag in ("rdst", "rsrc", "rlen"):
            c.alloc(f"pts_{tag}"), c.alloc(f"dlo_{tag}"), \
                c.alloc(f"dhi_{tag}")
        c.alloc("wa_dst_lo"), c.alloc("wa_dst_hi")
        c.alloc("wa_src_lo"), c.alloc("wa_src_hi")
        c.alloc("src_cur"), c.alloc("rem")
        c.alloc("rem_lo"), c.alloc("rem_hi")
        c.alloc("mem_bytes", RATE_BYTES)
        c.alloc("block_bytes", RATE_BYTES)
        c.alloc("is_pad", RATE_BYTES)
        # unaligned-source window (access-adapter role, SURVEY 2.1:
        # reference system/memory/adapter/mod.rs reconciles sub-word
        # access widths with split/merge AIRs; here the consuming chip
        # reads a WINDOW of RATE_WORDS+1 whole words and selects the
        # block's bytes at offset src_cur % 4 via one-hot flags —
        # word-granular memory everywhere, no byte-level bus traffic)
        c.alloc("off_f", 4)
        c.alloc("win_bytes", 4 * W_WINDOW)
        c.alloc("rdw", W_WINDOW)
        c.alloc("pts_w", W_WINDOW)
        c.alloc("dlo_w", W_WINDOW), c.alloc("dhi_w", W_WINDOW)
        c.alloc("state_in", STATE_U16S)
        c.alloc("in_hi", RATE_U16S)
        c.alloc("absorbed", RATE_U16S)
        c.alloc("abs_hi", RATE_U16S)
        c.alloc("state_out", STATE_U16S)
        c.alloc("dig_hi", 2 * DIGEST_WORDS)
        # write window (unaligned digests): doff one-hot, written bytes,
        # word-9 write gate, prev values + timestamps per window word
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
        pc, ts = _m(b, c, "pc"), _m(b, c, "ts")
        b.assert_bool(v), b.assert_bool(first), b.assert_bool(last)
        b.assert_zero(first * (1 - v))
        b.assert_zero(last * (1 - v))

        a_idx, b_idx, c_idx = (_m(b, c, "a_idx"), _m(b, c, "b_idx"),
                               _m(b, c, "c_idx"))
        dstp = _marr(b, c, "dstp", 4)
        srcp = _marr(b, c, "srcp", 4)
        lenp = _marr(b, c, "lenp", 4)
        vf = v * first

        # instruction interface (first block row)
        B.fetch(b, pc, Rv32KeccakOpcode.KECCAK256,
                [4 * a_idx, 4 * b_idx, 4 * c_idx, 1, 2, 0, 0], vf)
        B.exec_receive(b, pc, ts, vf)
        B.exec_send(b, pc + 4, ts + TS_PER_BLOCK, v * last)

        for tag, idx, limbs, tick in (("rdst", a_idx, dstp, 0),
                                      ("rsrc", b_idx, srcp, 1),
                                      ("rlen", c_idx, lenp, 2)):
            B.mem_read(b, B.AS_REGISTER, idx, limbs,
                       _m(b, c, f"pts_{tag}"), ts + tick,
                       _m(b, c, f"dlo_{tag}"), _m(b, c, f"dhi_{tag}"), vf)
        # pointer/len bounds (< 2^29)
        for limbs in (dstp, srcp, lenp):
            B.range_check(b, limbs[3], 5, vf)

        def u32(limbs):
            return (limbs[0] + 256 * limbs[1] + 65536 * limbs[2]
                    + (1 << 24) * limbs[3])

        src_cur = _m(b, c, "src_cur")
        rem = _m(b, c, "rem")
        b.assert_zero(vf * (src_cur - u32(srcp)))
        b.assert_zero(vf * (rem - u32(lenp)))

        # src_cur word + byte-offset decomposition (every valid row):
        # src_cur = 4*wa_src + off, off in 0..3 one-hot — unaligned
        # sources are read through a word window (see rdw below)
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
        # rem range (< 2^29)
        rem_lo, rem_hi = _m(b, c, "rem_lo"), _m(b, c, "rem_hi")
        b.assert_zero(v * (rem - rem_lo - (1 << 15) * rem_hi))
        B.range_check(b, rem_lo, 15, v)
        B.range_check(b, rem_hi, 14, v)

        # padding structure
        is_pad = _marr(b, c, "is_pad", RATE_BYTES)
        mem_bytes = _marr(b, c, "mem_bytes", RATE_BYTES)
        block_bytes = _marr(b, c, "block_bytes", RATE_BYTES)
        for j in range(RATE_BYTES):
            b.assert_bool(is_pad[j])
        for j in range(RATE_BYTES - 1):
            b.assert_zero(is_pad[j] * (1 - is_pad[j + 1]))  # monotone
        # pad byte values: first pad byte 0x01 (+0x80 at byte 135)
        for j in range(RATE_BYTES):
            fp = is_pad[j] - (is_pad[j - 1] if j else 0)
            extra = 0x80 if j == RATE_BYTES - 1 else 0
            b.assert_zero(is_pad[j] * (block_bytes[j] - fp - extra))
            # real bytes come from memory
            b.assert_zero((1 - is_pad[j]) * (mem_bytes[j] - block_bytes[j]))
        # non-last blocks are fully real; last block ends with padding
        real = sum(1 - is_pad[j] for j in range(RATE_BYTES))
        b.assert_zero(v * (1 - last) * (RATE_BYTES - real))
        b.assert_zero(v * last * (1 - is_pad[RATE_BYTES - 1]))
        b.assert_zero(v * last * (real - rem))

        # window word reads at ticks 3..37: word w of the window is read
        # iff it holds at least one real (non-pad) block byte.  Block byte
        # j lives at window byte j+off, so word w covers block bytes
        # [4w-off, 4w+3-off]; padding is a suffix, so "has a real byte" is
        # 1 - is_pad[max(4w - off, 0)] (clamped; beyond the block: none).
        win = _marr(b, c, "win_bytes", 4 * W_WINDOW)
        rdw = _marr(b, c, "rdw", W_WINDOW)
        for w in range(W_WINDOW):
            sel = 0
            for k in range(4):
                idx = 4 * w - k
                if idx > RATE_BYTES - 1:
                    continue  # window byte beyond the block: no real byte
                sel = sel + off_f[k] * (1 - is_pad[max(idx, 0)])
            b.assert_zero(rdw[w] - sel)
            B.mem_read(b, B.AS_MEMORY, wa_src + w, win[4 * w:4 * w + 4],
                       b.main(c.index["pts_w"] + w), ts + 3 + w,
                       b.main(c.index["dlo_w"] + w),
                       b.main(c.index["dhi_w"] + w), v * rdw[w])
        # real block bytes come from the window at offset off
        for j in range(RATE_BYTES):
            pick = sum(off_f[k] * win[j + k] for k in range(4))
            b.assert_zero((1 - is_pad[j]) * (mem_bytes[j] - pick))

        # absorb xor: rate limbs, byte-split via bitwise lookups
        state_in = _marr(b, c, "state_in", STATE_U16S)
        in_hi = _marr(b, c, "in_hi", RATE_U16S)
        absorbed = _marr(b, c, "absorbed", RATE_U16S)
        abs_hi = _marr(b, c, "abs_hi", RATE_U16S)
        for k in range(RATE_U16S):
            in_lo = state_in[k] - 256 * in_hi[k]
            B.byte_pair_check(b, in_lo, in_hi[k], v)
            abs_lo = absorbed[k] - 256 * abs_hi[k]
            B.xor_lookup(b, in_lo, block_bytes[2 * k], abs_lo, v)
            B.xor_lookup(b, in_hi[k], block_bytes[2 * k + 1], abs_hi[k], v)
        # first block: state_in = 0
        for m in range(STATE_U16S):
            b.assert_zero(vf * state_in[m])

        # permutation request: (absorbed || state_out)
        state_out = _marr(b, c, "state_out", STATE_U16S)
        msg = (list(absorbed) + list(state_in[RATE_U16S:])
               + list(state_out))
        b.push_send(KECCAK_BUS, msg, v)

        # chaining to next block row of the same instruction
        cont = v * (1 - last)

        def nxt(name, i=0):
            return b.main(c.index[name] + i, 1)

        b.assert_zero(cont * (1 - nxt("is_valid")))
        b.assert_zero(cont * nxt("is_first"))
        b.assert_zero(cont * (nxt("pc") - pc))
        b.assert_zero(cont * (nxt("ts") - ts - TS_PER_BLOCK))
        b.assert_zero(cont * (nxt("rem") - rem + RATE_BYTES))
        b.assert_zero(cont * (nxt("src_cur") - src_cur - RATE_BYTES))
        for i in range(4):
            b.assert_zero(cont * (nxt("dstp", i) - dstp[i]))
        for m in range(STATE_U16S):
            b.assert_zero(cont * (nxt("state_in", m) - state_out[m]))
        # a valid row is first iff it does not continue the previous row;
        # validity is a prefix of the trace
        b.assert_zero(b.is_first_row() * v * (1 - first))
        # next valid row is first iff it does not continue this row
        # (cont=1 also forces next.is_valid=1: booleans make -1 impossible)
        b.assert_zero(b.is_transition()
                      * (nxt("is_first") - (nxt("is_valid") - cont)))
        b.assert_zero(b.is_transition() * (1 - v) * nxt("is_valid"))

        # digest writes (last block) at ticks 38..46: the 32 digest bytes
        # land at BYTE address dst = 4*wa_dst + doff (doff in 0..3,
        # one-hot) — the write side of the word-window technique (access-
        # adapter role, reference system/memory/adapter/mod.rs:45-51): a
        # window of DIGEST_WORDS+1 whole words is read-modify-written;
        # window bytes outside [doff, doff+32) keep their previous value.
        wdl, wdh = _m(b, c, "wa_dst_lo"), _m(b, c, "wa_dst_hi")
        vl = v * last
        doff_f = _marr(b, c, "doff_f", 4)
        for k in range(4):
            b.assert_bool(doff_f[k])
        # exactly one flag set on last rows, none elsewhere -> every
        # selection constraint below is automatically vl-gated at deg 2
        b.assert_zero(sum(doff_f) - vl)
        doff = sum(k * doff_f[k] for k in range(1, 4))
        b.assert_zero(vl * (u32(dstp) - doff
                            - 4 * (wdl + (1 << 15) * wdh)))
        B.range_check(b, wdl, 15, vl)
        B.range_check(b, wdh, 12, vl)
        wa_dst = wdl + (1 << 15) * wdh
        dig_hi = _marr(b, c, "dig_hi", 2 * DIGEST_WORDS)
        prevw = _marr(b, c, "prevw", 4 * D_WINDOW)
        wrb = _marr(b, c, "wrb", 4 * D_WINDOW)
        for m in range(2 * DIGEST_WORDS):
            B.byte_pair_check(b, state_out[m] - 256 * dig_hi[m],
                              dig_hi[m], vl)
        # digest byte stream (little-endian u16 limbs of state_out)
        dig_bytes = []
        for m in range(2 * DIGEST_WORDS):
            dig_bytes.append(state_out[m] - 256 * dig_hi[m])
            dig_bytes.append(dig_hi[m])
        # written window bytes: digest where the window overlaps it,
        # previous memory content at the edges
        for j in range(4 * D_WINDOW):
            b.assert_zero(sum(
                doff_f[o] * (wrb[j] - (dig_bytes[j - o]
                                       if 0 <= j - o < 4 * DIGEST_WORDS
                                       else prevw[j]))
                for o in range(4)))
        # window word 9 holds digest bytes iff doff > 0
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
        from .rv32im import _ts_diff

        ts = np.asarray(rec["ts"], dtype=np.uint64)
        t[:n, c.index["is_valid"]] = 1
        t[:n, c.index["is_first"]] = rec["is_first"]
        t[:n, c.index["is_last"]] = rec["is_last"]
        t[:n, c.index["pc"]] = rec["pc"]
        t[:n, c.index["ts"]] = ts
        for k, nm in ((0, "a_idx"), (1, "b_idx"), (2, "c_idx")):
            t[:n, c.index[nm]] = np.asarray(rec[nm])
        isf = np.asarray(rec["is_first"], dtype=np.uint64)
        isl = np.asarray(rec["is_last"], dtype=np.uint64)
        for nm in ("dstp", "srcp", "lenp"):
            arr = np.asarray(rec[nm], dtype=np.uint64)
            t[:n, c.index[nm]:c.index[nm] + 4] = arr
        pts_regs = np.asarray(rec["pts_regs"], dtype=np.uint64)
        for k, tag in enumerate(("rdst", "rsrc", "rlen")):
            t[:n, c.index[f"pts_{tag}"]] = pts_regs[:, k]
            d = np.where(isf != 0, (ts + k - pts_regs[:, k] - 1)
                         % P, 0)
            t[:n, c.index[f"dlo_{tag}"]] = d & 0x7FFF
            t[:n, c.index[f"dhi_{tag}"]] = d >> 15
        src_cur = np.asarray(rec["src_cur"], dtype=np.uint64)
        rem = np.asarray(rec["rem"], dtype=np.uint64)
        t[:n, c.index["src_cur"]] = src_cur
        t[:n, c.index["rem"]] = rem
        t[:n, c.index["rem_lo"]] = rem & 0x7FFF
        t[:n, c.index["rem_hi"]] = rem >> 15
        t[:n, c.index["wa_src_lo"]] = (src_cur // 4) & 0x7FFF
        t[:n, c.index["wa_src_hi"]] = (src_cur // 4) >> 15
        off = (src_cur & 3).astype(np.int64)
        for k in range(4):
            t[:n, c.index["off_f"] + k] = (off == k)
        dst_u32 = np.zeros(n, dtype=np.uint64)
        dstp = np.asarray(rec["dstp"], dtype=np.uint64)
        for i in range(4):
            dst_u32 += dstp[:, i] << np.uint64(8 * i)
        t[:n, c.index["wa_dst_lo"]] = np.where(isl != 0,
                                               (dst_u32 // 4) & 0x7FFF, 0)
        t[:n, c.index["wa_dst_hi"]] = np.where(isl != 0,
                                               (dst_u32 // 4) >> 15, 0)

        mem_bytes = np.asarray(rec["mem_bytes"], dtype=np.uint64)
        pad_start = np.asarray(rec["pad_start"])
        t[:n, c.index["mem_bytes"]:c.index["mem_bytes"] + RATE_BYTES] = \
            mem_bytes
        js = np.arange(RATE_BYTES)
        is_pad = (js[None, :] >= pad_start[:, None]).astype(np.uint64)
        t[:n, c.index["is_pad"]:c.index["is_pad"] + RATE_BYTES] = is_pad
        blockb = np.where(is_pad != 0, 0, mem_bytes)
        fp = (js[None, :] == pad_start[:, None])
        blockb = blockb + fp
        blockb[:, RATE_BYTES - 1] += 0x80 * is_pad[:, RATE_BYTES - 1]
        t[:n, c.index["block_bytes"]:c.index["block_bytes"] + RATE_BYTES] \
            = blockb
        win_bytes = np.asarray(rec["win_bytes"], dtype=np.uint64)
        t[:n, c.index["win_bytes"]:c.index["win_bytes"] + 4 * W_WINDOW] = \
            win_bytes
        pts_w = np.asarray(rec["pts_w"], dtype=np.uint64)
        for w in range(W_WINDOW):
            # word w read iff its first in-block byte is real
            idx = np.maximum(4 * w - off, 0)
            gates = (4 * w - off <= RATE_BYTES - 1) & (idx < pad_start)
            t[:n, c.index["rdw"] + w] = gates
            t[:n, c.index["pts_w"] + w] = pts_w[:, w]
            d = np.where(gates, (ts + 3 + w - pts_w[:, w] - 1) % P, 0)
            t[:n, c.index["dlo_w"] + w] = d & 0x7FFF
            t[:n, c.index["dhi_w"] + w] = d >> 15

        st_in = np.asarray(rec["state_in"], dtype=np.uint64)   # (n, 25)
        st_out = np.asarray(rec["state_out"], dtype=np.uint64)
        for i in range(NUM_LANES):
            for l in range(U64_LIMBS):
                t[:n, c.index["state_in"] + 4 * i + l] = \
                    (st_in[:, i] >> np.uint64(16 * l)) & np.uint64(0xFFFF)
                t[:n, c.index["state_out"] + 4 * i + l] = \
                    (st_out[:, i] >> np.uint64(16 * l)) & np.uint64(0xFFFF)
        in_u16 = t[:n, c.index["state_in"]:c.index["state_in"] + RATE_U16S]
        t[:n, c.index["in_hi"]:c.index["in_hi"] + RATE_U16S] = in_u16 >> 8
        babs = in_u16 ^ (blockb[:, 0::2] + 256 * blockb[:, 1::2])
        t[:n, c.index["absorbed"]:c.index["absorbed"] + RATE_U16S] = babs
        t[:n, c.index["abs_hi"]:c.index["abs_hi"] + RATE_U16S] = babs >> 8
        dig = t[:n, c.index["state_out"]:c.index["state_out"]
                + 2 * DIGEST_WORDS]
        t[:n, c.index["dig_hi"]:c.index["dig_hi"] + 2 * DIGEST_WORDS] = \
            np.where(isl[:, None] != 0, dig >> 8, 0)
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
                         (ts + 3 + W_WINDOW + w - pts_wr[:, w] - 1) % P, 0)
            t[:n, c.index["dlo_wr"] + w] = d & 0x7FFF
            t[:n, c.index["dhi_wr"] + w] = d >> 15
        del _ts_diff
        return _pad_pow2(t)


KECCAK_AIRS = {"keccak_sponge": KeccakVmAir, "keccakf": KeccakfAir}
