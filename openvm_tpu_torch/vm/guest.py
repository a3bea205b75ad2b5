"""The hand-assembled guests: fibonacci, keccak256 and sha256.

Copy of tests/test_vm_prove.py:20-96 (``build_fib_program``, the ``asm_*``
encoders, ``fib``, ``FIB_EXECUTORS``), tests/test_vm_keccak.py:23-56
(``build_keccak_program``, ``keccak_r``, ``hint_storew``, ``SRC``, ``DST``)
and tests/test_vm_sha256.py:23-52 (``build_sha_program``, ``sha_r``), so
that chip_smoke.py and the tests reach the repo's VM workloads without
importing the JAX package.  ``build_keccak_iter_program(n)`` and
``build_sha256_iter_program(n)`` are this package's own: the reference's
``keccak256_iter`` and ``sha256_iter`` benchmark guests (SURVEY.md:337)
reduced to a loop that hashes its own 32-byte buffer in place n times.
``build_fib_program(n)`` runs about 5n + 20 instructions.  The original
loads the loop count n with one addi, whose immediate is 12 bits signed:
from n = 2048 on, the count wraps negative and the loop runs about 2^32
times.  Here a count that does not fit is loaded with lui + addi instead;
below 2048 the words are the original's, instruction for instruction.
"""

from __future__ import annotations

from .instructions import Program, VmExe
from .transpiler import Transpiler


def asm_r(op, rd, rs1, rs2, f3, f7):
    return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def asm_i(op, rd, rs1, imm, f3):
    return ((imm & 0xFFF) << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op


def asm_b(f3, rs1, rs2, imm):
    imm &= 0x1FFF
    return (((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25) \
        | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (((imm >> 1) & 0xF) << 8) \
        | (((imm >> 11) & 1) << 7) | 0x63


def asm_s(f3, rs1, rs2, imm):
    imm &= 0xFFF
    return ((imm >> 5) << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) \
        | ((imm & 0x1F) << 7) | 0x23


def asm_jal(rd, imm):
    imm &= 0x1FFFFF
    return (((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21) \
        | (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12) \
        | (rd << 7) | 0x6F


def reveal(rs1, rd, imm):
    return ((imm & 0xFFF) << 20) | (rs1 << 15) | (0b010 << 12) | (rd << 7) \
        | 0x0B


TERMINATE = 0x0000000B


def load_imm(rd: int, value: int) -> list:
    """Words that set register rd to ``value`` (0 <= value < 2^31): one
    addi from x0 when it fits 12 signed bits, else lui + addi."""
    if not 0 <= value < 1 << 31:
        raise ValueError(f"{value} is not a non-negative 31-bit value")
    if value < 2048:
        return [asm_i(0x13, rd, 0, value, 0)]
    hi = (value + 0x800) >> 12  # addi sign-extends the low 12 bits
    return [(hi << 12) | (rd << 7) | 0x37,  # lui rd, hi
            asm_i(0x13, rd, rd, value - (hi << 12), 0)]


def build_fib_program(n=10):
    words = [
        asm_i(0x13, 1, 0, 0, 0),    # x1 = 0 (a)
        asm_i(0x13, 2, 0, 1, 0),    # x2 = 1 (b)
        *load_imm(3, n),            # x3 = n
        # loop:
        asm_r(0x33, 4, 1, 2, 0, 0),  # x4 = a + b
        asm_i(0x13, 1, 2, 0, 0),     # a = b
        asm_i(0x13, 2, 4, 0, 0),     # b = x4
        asm_i(0x13, 3, 3, -1, 0),    # n -= 1
        asm_b(1, 3, 0, -16),         # bne n, x0, loop
        # memory + misc op coverage
        asm_s(2, 0, 2, 100),         # sw x2, 100(x0)
        asm_i(0x03, 6, 0, 100, 2),   # lw x6, 100(x0)
        asm_s(0, 0, 2, 104),         # sb x2, 104(x0)
        asm_i(0x03, 7, 0, 104, 4),   # lbu x7, 104(x0)
        asm_r(0x33, 8, 1, 2, 3, 0),  # sltu x8, x1, x2
        asm_b(6, 1, 2, 8),           # bltu x1, x2, +8 (taken)
        asm_i(0x13, 2, 2, 77, 0),    # (skipped)
        0x000012B7,                  # lui x5, 1
        asm_jal(9, 8),               # jal x9, +8
        asm_i(0x13, 2, 2, 99, 0),    # (skipped)
        0x00000617,                  # auipc x12, 0
        asm_i(0x67, 11, 12, 12, 0),  # jalr x11, x12, 12 -> auipc_pc+12
        asm_i(0x13, 2, 2, 55, 0),    # (skipped by jalr)
        reveal(6, 0, 0),             # reveal x6 at pv index 0
        reveal(7, 0, 4),             # reveal x7 at pv index 1
        TERMINATE,
    ]
    prog = Program(instructions=Transpiler().transpile(words), pc_base=0)
    return VmExe(program=prog, pc_start=0)


def fib(n):
    a, b = 0, 1
    for _ in range(n):
        a, b = b, a + b
    return a


FIB_EXECUTORS = ("alu", "lt", "beq", "blt", "jal_lui", "jalr", "auipc",
                 "loadstore")


# ADDI immediates are 12-bit signed: the copied guests keep their addresses
# below 2^11 (tests/test_vm_keccak.py:25-27)
SRC = 0x400
DST = 0x7C0


def keccak_r(rd, rs1, rs2):
    return ((0 << 25) | (rs2 << 20) | (rs1 << 15) | (0b100 << 12)
            | (rd << 7) | 0x0B)


def sha_r(rd, rs1, rs2):
    return ((1 << 25) | (rs2 << 20) | (rs1 << 15) | (0b100 << 12)
            | (rd << 7) | 0x0B)


def hint_storew(rd):
    return (0b001 << 12) | (rd << 7) | 0x0B


def hinted_input_words(n_bytes):
    """Words that read the hinted input of n_bytes into memory at SRC."""
    words = [(0 << 20) | (0b011 << 12) | 0x0B]          # phantom hint_input
    words += [asm_i(0x13, 1, 0, SRC - 4, 0), hint_storew(1)]  # len header
    for k in range(0, n_bytes, 4):
        words += [asm_i(0x13, 1, 0, SRC + k, 0), hint_storew(1)]
    return words


def _program(words):
    prog = Program(instructions=Transpiler().transpile(words), pc_base=0)
    return VmExe(program=prog, pc_start=0)


def build_keccak_program(n_bytes):
    """keccak256 of the n_bytes of hinted input; reveals digest words 0
    and 7.  Executors: alu, loadstore, hintstore."""
    words = hinted_input_words(n_bytes) + [
        asm_i(0x13, 5, 0, DST, 0),     # x5 = dst
        asm_i(0x13, 6, 0, SRC, 0),     # x6 = src
        asm_i(0x13, 7, 0, n_bytes, 0),  # x7 = len
        keccak_r(5, 6, 7),
        asm_i(0x03, 8, 5, 0, 2),       # lw x8, 0(x5): digest word 0
        asm_i(0x03, 9, 5, 28, 2),      # lw x9, 28(x5): digest word 7
        reveal(8, 0, 0),
        reveal(9, 0, 4),
        TERMINATE,
    ]
    return _program(words)


def build_sha_program(n_bytes):
    """sha256 of the n_bytes of hinted input; reveals digest word 0.
    Executors: alu, loadstore, hintstore."""
    words = hinted_input_words(n_bytes) + [
        asm_i(0x13, 5, 0, DST, 0),
        asm_i(0x13, 6, 0, SRC, 0),
        asm_i(0x13, 7, 0, n_bytes, 0),
        sha_r(5, 6, 7),
        asm_i(0x03, 8, 5, 0, 2),
        reveal(8, 0, 0),
        TERMINATE,
    ]
    return _program(words)


def hint_inputs(data: bytes) -> list:
    """The input stream of the hinted guests: data padded to whole words."""
    return [list(data + bytes(-len(data) % 4))]


# The iterated guests' buffer: past 12 bits, so loaded with lui + addi.
ITER_BUF = 0x10000


def iter_words(kind, n):
    """The words of the iterated guest: kind "keccak" or "sha256"."""
    if n < 1:
        raise ValueError("the loop runs at least once")
    hash_r = {"keccak": keccak_r, "sha256": sha_r}[kind]
    return [
        *load_imm(5, ITER_BUF),      # x5 = buf
        *load_imm(7, 32),            # x7 = 32
        *load_imm(3, n),             # x3 = n
        # loop:
        hash_r(5, 5, 7),             # buf = hash(buf[0..32))
        asm_i(0x13, 3, 3, -1, 0),    # n -= 1
        asm_b(1, 3, 0, -8),          # bne n, x0, loop
        asm_i(0x03, 8, 5, 0, 2),     # lw x8, 0(x5): digest word 0
        asm_i(0x03, 9, 5, 28, 2),    # lw x9, 28(x5): digest word 7
        reveal(8, 0, 0),
        reveal(9, 0, 4),
        TERMINATE,
    ]


def build_keccak_iter_program(n):
    """Hashes a 32-byte buffer, zero at the start, in place n times with
    keccak256 (one block a hash) and reveals digest words 0 and 7.  Needs
    only FIB_EXECUTORS and the keccak extension; runs iter_insns(n)
    instructions."""
    return _program(iter_words("keccak", n))


def build_sha256_iter_program(n):
    """build_keccak_iter_program with sha256 (one 64-byte block a hash)."""
    return _program(iter_words("sha256", n))


def iter_insns(n):
    """The instructions an iterated guest runs: 3 a hash, 4 to 5 to load
    its registers (n past 2047 takes lui + addi), 4 after the loop."""
    return 3 * n + 4 + (n >= 2048) + 4
