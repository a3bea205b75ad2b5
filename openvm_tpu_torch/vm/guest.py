"""The hand-assembled guests: fibonacci, keccak256, sha256, int256 and
modular arithmetic, ECC, pairing, and the native VM's programs.

Copy of tests/test_vm_prove.py:20-96 (``build_fib_program``, the ``asm_*``
encoders, ``fib``, ``FIB_EXECUTORS``), tests/test_vm_keccak.py:23-56
(``build_keccak_program``, ``keccak_r``, ``hint_storew``, ``SRC``, ``DST``),
tests/test_vm_sha256.py:23-52 (``build_sha_program``, ``sha_r``),
tests/test_vm_bigint.py:25-116 (``int256_r``, ``beq256``,
``build_bigint_program``, ``hint_input_for``, ``A_VAL``, ``B_VAL``, the
``PTR_*`` blocks) and tests/test_vm_modular.py:20-63 (``modular_r``,
``build_modular_program``, its operands ``MOD_A_VAL`` and ``MOD_B_VAL``),
so that chip_smoke.py and the tests reach the repo's VM workloads without
importing the JAX package.  ``build_keccak_iter_program(n)``,
``build_sha256_iter_program(n)`` and ``build_u256_iter_program(n)`` are
this package's own: the reference's ``keccak256_iter`` and ``sha256_iter``
benchmark guests (SURVEY.md:337) reduced to a loop that hashes its own
32-byte buffer in place n times, and that loop mixed with 256-bit integer
and modular arithmetic over secp256k1's two moduli (the reference's ruint
and U256 guests, SURVEY.md:325).  ``build_native_program`` copies
tests/test_native_vm.py:35-74; ``build_native_query_program`` (path 10,
the FRI query phase of a leaf verifier) is written with the port's
native Builder.
``build_fib_program(n)`` runs about 5n + 20 instructions.  The original
loads the loop count n with one addi, whose immediate is 12 bits signed:
from n = 2048 on, the count wraps negative and the loop runs about 2^32
times.  Here a count that does not fit is loaded with lui + addi instead;
below 2048 the words are the original's, instruction for instruction.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from ..pairing.curve import BN254, PairingCurveParams
from ..pairing.final_exp import final_exp_hint, final_exp_product
from ..pairing.miller import (g1_fracs, miller_add_step, miller_double_step,
                              multi_miller_loop)
from ..pairing.tower import F2_ONE, F2_ZERO, F12_ONE, Tower
from .circuit.keccak import keccak256
from ..field.babybear import canonical_np, ext_inv_int, ext_mul_int, to_monty_np
from ..native_compiler.builder import Builder, Ext, FeltArray
from ..poseidon2 import permute as permute_plain
from .instructions import (BranchEqual256Opcode, BranchLessThan256Opcode,
                           FieldArithmeticOpcode as FA,
                           FieldExtensionOpcode as FE, FriOpcode, Instruction,
                           NativeBranchEqOpcode as NB, NativeJalOpcode,
                           NativeLoadStore4Opcode as NL4,
                           NativeLoadStoreOpcode as NL, NativePhantom,
                           NativeRangeCheckOpcode, P as P_NATIVE,
                           Poseidon2Opcode, Program, SystemOpcode,
                           VerifyBatchOpcode, VmExe, phantom)
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


def phantom_hint_input():
    return (0 << 20) | (0b011 << 12) | 0x0B


def hinted_input_words(n_bytes):
    """Words that read the hinted input of n_bytes into memory at SRC."""
    words = [phantom_hint_input()]
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


# -- int256 and modular arithmetic (tests/test_vm_bigint.py:25-116,
# tests/test_vm_modular.py:20-63) ------------------------------------------

M256 = (1 << 256) - 1

# Int256 funct7 encodings (reference Int256Funct7)
ADD, SUB, XOR, OR, AND, SLL, SRL, SRA, SLT, SLTU, MUL = range(11)
# modular base funct7s (reference ModArithBaseFunct7)
ADD_F7, SUB_F7, MUL_F7, DIV_F7, ISEQ_F7, SETUP_F7 = range(6)

SECP256K1_P = (1 << 256) - (1 << 32) - 977
SECP256K1_N = 0xFFFFFFFF_FFFFFFFF_FFFFFFFF_FFFFFFFE_BAAEDCE6_AF48A03B_BFD25E8C_D0364141


def int256_r(funct7, rd, rs1, rs2):
    return ((funct7 << 25) | (rs2 << 20) | (rs1 << 15) | (0b101 << 12)
            | (rd << 7) | 0x0B)


def beq256(rs1, rs2, imm):
    imm &= 0x1FFF
    return ((((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25)
            | (rs2 << 20) | (rs1 << 15) | (0b110 << 12)
            | (((imm >> 1) & 0xF) << 8) | (((imm >> 11) & 1) << 7) | 0x0B)


def modular_r(base_f7, rd, rs1, rs2, mod_idx=0):
    return (((mod_idx * 8 + base_f7) << 25) | (rs2 << 20) | (rs1 << 15)
            | (0b000 << 12) | (rd << 7) | 0x2B)


A_VAL = 0xF1EE_0000_DDCC_BBAA_9988_7766_5544_3322_1100_FFEE_DDCC_BBAA_9988_7766_5544_3322
B_VAL = 0x0000_0001_0000_0000_0000_0000_0000_0000_FEDC_BA98_7654_3210_0123_4567_89AB_CDEF
MOD_A_VAL = 0x3A1E_55D1_9F83_7C2B_11DD_0123_4567_89AB_CDEF_FEDC_BA98_7654_3210_0F0F_1E1E_2D2D % SECP256K1_P
MOD_B_VAL = 0x0101_55D1_0000_7C2B_9F83_4567_0123_89AB_1234_5678_9ABC_DEF0_AAAA_BBBB_CCCC_0007 % SECP256K1_P

PTR_A, PTR_B, PTR_C, PTR_D = 0x100, 0x140, 0x180, 0x1C0


def _operand_words():
    """Hint the two 32-byte operands into [PTR_A] and [PTR_B] and point
    x1-x4 at the four blocks."""
    words = [phantom_hint_input()]
    words += [asm_i(0x13, 1, 0, PTR_A, 0), hint_storew(1)]  # length word
    for k in range(8):
        words += [asm_i(0x13, 1, 0, PTR_A + 4 * k, 0), hint_storew(1)]
    for k in range(8):
        words += [asm_i(0x13, 1, 0, PTR_B + 4 * k, 0), hint_storew(1)]
    return words + [
        asm_i(0x13, 1, 0, PTR_A, 0),   # x1 = &a
        asm_i(0x13, 2, 0, PTR_B, 0),   # x2 = &b
        asm_i(0x13, 3, 0, PTR_C, 0),   # x3 = &c
        asm_i(0x13, 4, 0, PTR_D, 0),   # x4 = &d
    ]


def build_bigint_program(ops):
    """Operands arrive through the hint stream, then the given custom
    instructions run, then the low and high result words of [PTR_C] are
    revealed.  Executors: alu, loadstore, hintstore and int256."""
    return _program(_operand_words() + list(ops) + [
        asm_i(0x03, 6, 3, 0, 2),       # lw x6, 0(x3)
        reveal(6, 0, 0),
        asm_i(0x03, 7, 3, 28, 2),      # lw x7, 28(x3)
        reveal(7, 0, 4),
        TERMINATE,
    ])


def hint_input_for(a, b):
    """One input: 64 bytes = a || b little-endian."""
    return [list(a.to_bytes(32, "little") + b.to_bytes(32, "little"))]


def build_modular_program():
    """c = a + b, d = c - b, c = a * b, d = c / b, x28 = (d == a) over
    secp256k1's prime (modulus index 0); reveals c's low word and x28."""
    return _program(_operand_words() + [
        modular_r(SETUP_F7, 3, 1, 2),      # setup -> nop
        modular_r(ADD_F7, 3, 1, 2),        # c = a + b
        modular_r(SUB_F7, 4, 3, 2),        # d = c - b = a
        modular_r(MUL_F7, 3, 4, 2),        # c = a * b
        modular_r(DIV_F7, 4, 3, 2),        # d = c / b = a
        modular_r(ISEQ_F7, 28, 4, 1),      # x28 = (d == a) = 1
        asm_i(0x03, 6, 3, 0, 2),           # lw x6, 0(x3)
        reveal(6, 0, 0),
        reveal(28, 0, 4),
        TERMINATE,
    ])


# -- the u256 iteration guest ------------------------------------------------

# Its 32-byte blocks after the hashed buffer at ITER_BUF, each behind its
# own pointer register: the accumulator, four temporaries, the two
# comparison results, the constants 1 and 2^255 - 1, the two reduced
# operands of the modular ops and four modular results.
U256_BLOCKS = ("acc", "t", "u", "v", "w", "l1", "l2", "one", "mask", "x",
               "y", "r1", "r2", "r3", "r4")
U256_REG = {name: 8 + i for i, name in enumerate(U256_BLOCKS)}
U256_REG["d"] = 5   # the hashed buffer, its digest after each sha256
U256_FLAGS = (23, 24)  # the IS_EQ results of modulus 0 and 1
U256_MODULI = (SECP256K1_P, SECP256K1_N)
# The int256 body of an iteration, run U256_PASSES times: (funct7, rd,
# rs1, rs2) by block name; every ALU-type funct7 once.
U256_BODY = ((XOR, "t", "acc", "d"), (SLL, "u", "t", "d"),
             (SRL, "v", "t", "acc"), (SRA, "w", "d", "t"),
             (OR, "u", "u", "v"), (AND, "v", "w", "t"),
             (SLT, "l1", "u", "v"), (SUB, "w", "w", "l1"),
             (SLTU, "l2", "u", "w"), (MUL, "t", "u", "v"),
             (ADD, "acc", "t", "w"))
U256_PASSES = 4
# The six 256-bit branches, each to the next instruction: (opcode, rs1,
# rs2).  Only BEQ256 has a RISC-V encoding (the transpiler lowers custom-0
# funct3 0b110 to it, as the JAX package's does); the other five are set
# as VM instructions, as tests/test_vm_bigint.py's BLT256 is.
U256_BRANCHES = ((BranchEqual256Opcode.BEQ, "l1", "one"),
                 (BranchEqual256Opcode.BNE, "l2", "one"),
                 (BranchLessThan256Opcode.BLT, "acc", "d"),
                 (BranchLessThan256Opcode.BGE, "acc", "d"),
                 (BranchLessThan256Opcode.BLTU, "d", "acc"),
                 (BranchLessThan256Opcode.BGEU, "d", "acc"))


def _branch(opcode, rs1, rs2):
    return Instruction(opcode, a=4 * U256_REG[rs1], b=4 * U256_REG[rs2],
                       c=4, d=1, e=2)


def _modular_words(k):
    """Modulus k's five ops on the reduced operands x, y: r1 = x + y,
    r2 = r1 - x, r3 = r1 * r2, then r1 again as r3 / y (into r4 for
    modulus 0, into the hashed buffer for modulus 1, so the next sha256
    reads it) and an IS_EQ into U256_FLAGS[k] (r4 == r1 for modulus 0,
    r3 == x for modulus 1)."""
    r = U256_REG
    out = "r4" if k == 0 else "d"
    eq = ("r4", "r1") if k == 0 else ("r3", "x")
    return [modular_r(ADD_F7, r["r1"], r["x"], r["y"], k),
            modular_r(SUB_F7, r["r2"], r["r1"], r["x"], k),
            modular_r(MUL_F7, r["r3"], r["r1"], r["r2"], k),
            modular_r(DIV_F7, r[out], r["r3"], r["y"], k),
            modular_r(ISEQ_F7, U256_FLAGS[k], r[eq[0]], r[eq[1]], k)]


def u256_iter_items(n):
    """The guest's program as words, and as VM instructions where a
    branch has no encoding; the loop's first and last item indices."""
    if n < 1:
        raise ValueError("the loop runs at least once")
    r = U256_REG
    items = [*load_imm(5, ITER_BUF), *load_imm(7, 32), *load_imm(3, n)]
    for i, name in enumerate(U256_BLOCKS):
        items += load_imm(r[name], ITER_BUF + 32 * (i + 1))
    items += [asm_i(0x13, 1, 0, 1, 0),                   # x1 = 1
              asm_s(2, r["one"], 1, 0),                  # [one] = 1
              int256_r(SUB, r["mask"], r["mask"], r["one"]),  # 2^256 - 1
              int256_r(SRL, r["mask"], r["mask"], r["one"])]  # 2^255 - 1
    loop = len(items)
    items.append(sha_r(5, 5, 7))                         # d = sha256(d)
    for _ in range(U256_PASSES):
        items += [int256_r(f7, r[rd], r[a], r[b]) for f7, rd, a, b in U256_BODY]
    items += [_branch(*br) for br in U256_BRANCHES]
    items += [int256_r(AND, r["x"], r["acc"], r["mask"]),  # x < 2^255
              int256_r(AND, r["y"], r["d"], r["mask"]),
              int256_r(OR, r["y"], r["y"], r["one"])]      # y odd, y < 2^255
    for k in range(len(U256_MODULI)):
        items += _modular_words(k)
    items.append(asm_i(0x13, 3, 3, -1, 0))               # n -= 1
    items.append(asm_b(1, 3, 0, -4 * (len(items) - loop)))  # bne n, x0, loop
    last = len(items) - 1
    items += [asm_i(0x03, 1, r["acc"], 0, 2), reveal(1, 0, 0),   # acc word 0
              asm_i(0x03, 2, r["acc"], 28, 2), reveal(2, 0, 4),  # acc word 7
              asm_i(0x03, 4, 5, 0, 2), reveal(4, 0, 8),          # buffer word 0
              reveal(U256_FLAGS[0], 0, 12), reveal(U256_FLAGS[1], 0, 16),
              TERMINATE]
    return items, loop, last


def u256_iter_program(items):
    """The VmExe of ``u256_iter_items``: the words transpiled, a branch
    without an encoding in its place."""
    words = [it if isinstance(it, int) else TERMINATE for it in items]
    insns = Transpiler().transpile(words)
    if len(insns) != len(items):
        raise ValueError("a word of the guest transpiled to more than one instruction")
    for i, it in enumerate(items):
        if not isinstance(it, int):
            insns[i] = it
    return VmExe(program=Program(instructions=insns, pc_base=0), pc_start=0)


def build_u256_iter_program(n):
    """n iterations of: sha256 of the 32-byte buffer at ITER_BUF in place
    (one block); U256_PASSES passes of U256_BODY over the digest and the
    accumulator (every int256 ALU-type op); the six 256-bit branches,
    taken or not by the data; the accumulator and the digest masked below
    2^255 (the digest also made odd), then ADD, SUB, MUL, DIV and IS_EQ
    modulo each of secp256k1's two moduli.  Reveals the accumulator's words
    0 and 7, the buffer's word 0 and the two IS_EQ results (public values
    ``u256_iter_reference(n)``).  Config: FIB_EXECUTORS, bigint, sha256 and
    moduli U256_MODULI."""
    return u256_iter_program(u256_iter_items(n)[0])


def _is_int256(item):
    """An int256 op: a custom-0 int256 or BEQ256 word, or a branch set as
    an instruction."""
    return not isinstance(item, int) or (
        (item & 0x7F) == 0x0B and (item >> 12) & 7 in (0b101, 0b110))


def _is_modular(item):
    return isinstance(item, int) and (item & 0x7F) == 0x2B


def u256_iter_counts(n):
    """Instructions the guest runs, its int256 and modular ops and sha256
    blocks."""
    items, loop, last = u256_iter_items(n)
    setup, body, tail = items[:loop], items[loop:last + 1], items[last + 1:-1]
    return {"insns": len(setup) + n * len(body) + len(tail),   # TERMINATE not run
            "int256_ops": sum(map(_is_int256, setup)) + n * sum(map(_is_int256, body)),
            "modular_ops": n * sum(map(_is_modular, body)), "sha256_blocks": n}


def _signed(v):
    return v - (1 << 256) if v >> 255 else v


def u256_iter_reference(n):
    """The 32 public-value bytes of build_u256_iter_program(n), computed
    with Python ints and hashlib."""
    mem = {name: 0 for name in U256_BLOCKS}
    mem["d"] = 0
    mem["one"] = 1
    mem["mask"] = ((0 - 1) & M256) >> 1
    flags = [0, 0]
    ops = {ADD: lambda x, y: (x + y) & M256, SUB: lambda x, y: (x - y) & M256,
           XOR: lambda x, y: x ^ y, OR: lambda x, y: x | y,
           AND: lambda x, y: x & y,
           SLL: lambda x, y: (x << (y & 255)) & M256,
           SRL: lambda x, y: x >> (y & 255),
           SRA: lambda x, y: (_signed(x) >> (y & 255)) & M256,
           SLT: lambda x, y: int(_signed(x) < _signed(y)),
           SLTU: lambda x, y: int(x < y), MUL: lambda x, y: (x * y) & M256}
    for _ in range(n):
        digest = hashlib.sha256(mem["d"].to_bytes(32, "little")).digest()
        mem["d"] = int.from_bytes(digest, "little")
        for _ in range(U256_PASSES):
            for f7, rd, a, b in U256_BODY:
                mem[rd] = ops[f7](mem[a], mem[b])
        mem["x"] = mem["acc"] & mem["mask"]
        mem["y"] = (mem["d"] & mem["mask"]) | 1
        for k, m in enumerate(U256_MODULI):
            x, y = mem["x"], mem["y"]
            r1 = (x + y) % m
            r2 = (r1 - x) % m
            r3 = (r1 * r2) % m
            q = (r3 * pow(y, -1, m)) % m
            mem["r1"], mem["r2"], mem["r3"] = r1, r2, r3
            mem["r4" if k == 0 else "d"] = q
            flags[k] = int(q == r1) if k == 0 else int(r3 == x)
    pv = (mem["acc"].to_bytes(32, "little")[:4] + mem["acc"].to_bytes(32, "little")[28:]
          + mem["d"].to_bytes(32, "little")[:4]
          + bytes([flags[0], 0, 0, 0, flags[1], 0, 0, 0]))
    return list(pv + bytes(32 - len(pv)))


# -- the full RV32IM opcode mix (tests/test_vm_full_ops.py:23-63) -----------

def build_full_ops_program():
    """Every shift, MUL/MULH/MULHSU/MULHU, DIV/DIVU/REM/REMU (and a division
    by zero), a hinted word loaded back by lw and lh; reveals the mul result
    and the hinted word.  Input ``FULL_OPS_INPUTS``; the default executors.
    (The original's comments call the two loads lb and lh: funct3 2 and 1
    are lw and lh.)"""
    return _program([
        asm_i(0x13, 1, 0, 0x355, 0),     # x1 = 0x355
        asm_i(0x13, 2, 0, 7, 0),         # x2 = 7
        asm_r(0x33, 3, 1, 2, 1, 0),      # sll x3, x1, x2
        asm_i(0x13, 4, 1, 3, 1),         # slli x4, x1, 3
        asm_r(0x33, 5, 1, 2, 5, 0),      # srl x5, x1, x2
        asm_i(0x13, 6, 1, 2, 5),         # srli
        asm_r(0x33, 7, 1, 2, 5, 0x20),   # sra
        asm_i(0x13, 8, 0, -100, 0),      # x8 = -100
        asm_i(0x13, 9, 8, 4, 5) | (0x20 << 25),  # srai x9, x8, 4
        asm_r(0x33, 10, 1, 2, 0, 1),     # mul x10, x1, x2
        asm_r(0x33, 11, 8, 2, 1, 1),     # mulh x11, x8, x2
        asm_r(0x33, 12, 8, 2, 2, 1),     # mulhsu
        asm_r(0x33, 13, 1, 2, 3, 1),     # mulhu
        asm_r(0x33, 14, 8, 2, 4, 1),     # div x14, x8, x2
        asm_r(0x33, 15, 1, 2, 5, 1),     # divu
        asm_r(0x33, 16, 8, 2, 6, 1),     # rem
        asm_r(0x33, 17, 1, 2, 7, 1),     # remu
        asm_r(0x33, 18, 1, 0, 4, 1),     # div by zero
        phantom_hint_input(),
        asm_i(0x13, 20, 0, 0x100, 0),    # x20 = 0x100 (ptr)
        hint_storew(20),                 # writes length word
        hint_storew(20),                 # writes first data word
        asm_i(0x03, 21, 20, 0, 2),       # lw x21, 0(x20)
        asm_i(0x03, 22, 20, 0, 1),       # lh x22, 0(x20)
        reveal(10, 0, 0),                # reveal mul result
        reveal(21, 0, 4),                # reveal the hinted word
        TERMINATE,
    ])


FULL_OPS_INPUTS = [[0xAB, 0xCD, 0x12, 0x99]]


# -- short-Weierstrass ECC (tests/test_vm_ecc.py:20-64,
# tests/test_real_elf_breadth.py:116-165) -----------------------------------

SECP256K1_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
SECP256K1_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
SECP256K1_G = (SECP256K1_GX, SECP256K1_GY)
# (modulus, a) of secp256k1: y^2 = x^3 + 7
SECP256K1_CURVE = (SECP256K1_P, 0)
# EC base funct7s (reference SwBaseFunct7)
EC_ADD_NE_F7, EC_DOUBLE_F7, EC_SETUP_F7 = range(3)

PT_A, PT_C, PT_D = 0x200, 0x280, 0x300


def ec_r(base_f7, rd, rs1, rs2, curve_idx=0):
    return (((curve_idx * 8 + base_f7) << 25) | (rs2 << 20) | (rs1 << 15)
            | (0b001 << 12) | (rd << 7) | 0x2B)


def build_ecc_program():
    """G hinted into [PT_A]; [PT_C] = 2G by EC_DOUBLE, [PT_D] = G + 2G by
    EC_ADD_NE (after a SETUP, a nop); reveals 3G.x's low word.  Input
    ``ecc_inputs()``; executors alu, loadstore, hintstore."""
    words = [phantom_hint_input()]
    words += [asm_i(0x13, 1, 0, PT_A, 0), hint_storew(1)]   # length scratch
    for k in range(16):
        words += [asm_i(0x13, 1, 0, PT_A + 4 * k, 0), hint_storew(1)]
    return _program(words + [
        asm_i(0x13, 1, 0, PT_A, 0),    # x1 = &G
        asm_i(0x13, 3, 0, PT_C, 0),    # x3 = &2G
        asm_i(0x13, 4, 0, PT_D, 0),    # x4 = &3G
        ec_r(EC_SETUP_F7, 0, 0, 0),    # setup -> nop
        ec_r(EC_DOUBLE_F7, 3, 1, 0),   # [x3] = double([x1]) = 2G
        ec_r(EC_ADD_NE_F7, 4, 1, 3),   # [x4] = [x1] + [x3] = 3G
        asm_i(0x03, 6, 4, 0, 2),       # lw x6, 0(x4): 3G.x low word
        reveal(6, 0, 0),
        TERMINATE,
    ])


def ecc_inputs():
    return [list(SECP256K1_GX.to_bytes(32, "little") + SECP256K1_GY.to_bytes(32, "little"))]


def ec_add(p1, p2):
    """Affine addition on secp256k1, None the point at infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    p = SECP256K1_P
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def ec_mul(k, pt):
    acc = None
    while k:
        if k & 1:
            acc = ec_add(acc, pt)
        pt = ec_add(pt, pt)
        k >>= 1
    return acc


def ecdsa_sign_recoverable(z: int, d: int, k: int):
    """(r, s, recid) with low-s normalization (what k256 recovery expects;
    EVM precompile input format v = 27 + recid)."""
    n = SECP256K1_N
    rx, ry = ec_mul(k, SECP256K1_G)
    r = rx % n
    assert r != 0 and rx < n
    s = pow(k, -1, n) * (z + r * d) % n
    assert s != 0
    recid = ry & 1
    if s > n // 2:
        s = n - s
        recid ^= 1
    return r, s, recid


# -- the ecrecover guest -----------------------------------------------------

# Heap layout: every block below 2^11, so that addi from x0 and lw/sw
# offsets from x0 reach it.  IN holds the 148 hinted bytes of a signature
# (the 128-byte precompile input z || v || r || s, big-endian, and the
# expected 20-byte address); the 32-byte blocks are little-endian.  TABLE +
# 64k is the point of Shamir's table for the bit pair k = b1 + 2 b2 of
# (u1, u2): G, R, G + R.
ER_LEN, ER_IN = 0x0FC, 0x100
ER_ZERO, ER_ONE, ER_SEVEN = 0x1A0, 0x1C0, 0x1E0
ER_Z, ER_S, ER_T1, ER_T2, ER_RHS = 0x200, 0x220, 0x240, 0x260, 0x280
ER_W, ER_U1, ER_U2, ER_OK = 0x2A0, 0x2C0, 0x2E0, 0x300
ER_TABLE = 0x340
ER_G, ER_R, ER_GR = ER_TABLE + 64, ER_TABLE + 128, ER_TABLE + 192
ER_RY = ER_R + 32
ER_ACC, ER_BUF, ER_HASH = 0x440, 0x480, 0x4C0
ER_INPUT_BYTES = 148
# public values: the matched count, then the XOR of the recovered
# addresses' five words
ER_ADDR_WORDS = 5
ER_REGS = {"count": 9, "xor": (10, 11, 12, 13, 14), "n": 8, "bit": 15, "pair": 16,
           "acc": 20, "table": 21, "entry": 22, "c64": 18, "c32": 19}


def hint_buffer(rd, rs1):
    """HINT_BUFFER: rs1 words of the hint stream to [rd]."""
    return (1 << 20) | (rs1 << 15) | (0b001 << 12) | (rd << 7) | 0x0B


def _imm32(rd, value):
    """Words that set rd to any 32-bit value: lui + addi."""
    value &= 0xFFFFFFFF
    hi = ((value + 0x800) >> 12) & 0xFFFFF
    lo = (value - (hi << 12)) & 0xFFF
    return [(hi << 12) | (rd << 7) | 0x37, asm_i(0x13, rd, rd, lo, 0)]


class _Asm:
    """A word list with labels; branches, jumps and calls resolved at the
    end, each offset checked against its immediate's reach."""

    def __init__(self):
        self.words, self.labels, self._fix = [], {}, []

    def label(self, name):
        self.labels[name] = len(self.words)

    def emit(self, *words):
        self.words.extend(words)

    def _later(self, target, bits, enc, base=None):
        at = len(self.words)
        self._fix.append((at, at if base is None else base, target, bits, enc))
        self.words.append(None)

    def branch(self, f3, rs1, rs2, target):
        self._later(target, 13, lambda off: asm_b(f3, rs1, rs2, off))

    def jal(self, rd, target):
        self._later(target, 21, lambda off: asm_jal(rd, off))

    def call(self, target):
        """auipc x1, 0; jalr x1, x1, target - auipc's pc."""
        self.emit((1 << 7) | 0x17)
        self._later(target, 12, lambda off: asm_i(0x67, 1, 1, off, 0),
                    base=len(self.words) - 1)

    def resolve(self):
        for at, base, target, bits, enc in self._fix:
            off = 4 * (self.labels[target] - base)
            if not -(1 << (bits - 1)) <= off < 1 << (bits - 1):
                raise ValueError(f"{target} is out of reach at word {at}")
            self.words[at] = enc(off)
        return self.words


def _mod(f7, rd_addr, rs1_addr, rs2_addr, k):
    """A modular op on the blocks at those addresses (pointers in x25-x27)."""
    return [asm_i(0x13, 25, 0, rd_addr, 0), asm_i(0x13, 26, 0, rs1_addr, 0),
            asm_i(0x13, 27, 0, rs2_addr, 0), modular_r(f7, 25, 26, 27, k)]


def _rev32_call(a, src, dst, auipc=False):
    """rev32 from src to dst, called by jal, or by auipc + jalr."""
    a.emit(asm_i(0x13, 2, 0, src, 0), asm_i(0x13, 3, 0, dst, 0))
    if auipc:
        a.call("rev32")
    else:
        a.jal(1, "rev32")


def _pair_words(r):
    """The bit pair of step x15: bit x15 of u1 plus twice that of u2, read
    from the guest's own words (divu/remu by 32, loads, shifts, masks)."""
    return [asm_r(0x33, 17, r["bit"], r["c32"], 5, 1),   # divu x17 = word index
            asm_r(0x33, r["pair"], r["bit"], r["c32"], 7, 1),  # remu: bit index
            asm_i(0x13, 17, 17, 2, 1),                   # slli x17, 2
            asm_i(0x13, 4, 17, ER_U1, 0),                # x4 = &u1 word
            asm_i(0x03, 5, 4, 0, 2),                     # lw u1 word
            asm_r(0x33, 5, 5, r["pair"], 5, 0),          # srl
            asm_i(0x13, 5, 5, 1, 7),                     # andi 1
            asm_i(0x03, 6, 4, ER_U2 - ER_U1, 2),         # lw u2 word
            asm_r(0x33, 6, 6, r["pair"], 5, 0),          # srl
            asm_i(0x13, 6, 6, 1, 7),                     # andi 1
            asm_i(0x13, 6, 6, 1, 1),                     # slli 1
            asm_r(0x33, r["pair"], 5, 6, 6, 0)]          # or: the pair


def ecrecover_asm(n):
    """The guest's assembled words and labels (``build_ecrecover_program``)."""
    if n < 1:
        raise ValueError("at least one signature")
    r = ER_REGS
    a = _Asm()
    for k in range(16):                                  # G into the table
        a.emit(*_imm32(5, (SECP256K1_G[k // 8] >> (32 * (k % 8))) & 0xFFFFFFFF),
               asm_s(2, 0, 5, ER_G + 4 * k))
    a.emit(asm_i(0x13, 5, 0, 1, 0), asm_s(2, 0, 5, ER_ONE),
           asm_i(0x13, 5, 0, 7, 0), asm_s(2, 0, 5, ER_SEVEN),
           *load_imm(r["n"], n), asm_i(0x13, r["c64"], 0, 64, 0),
           asm_i(0x13, r["c32"], 0, 32, 0), asm_i(0x13, r["table"], 0, ER_TABLE, 0),
           asm_i(0x13, r["acc"], 0, ER_ACC, 0))
    a.jal(0, "sig")
    # rev32: 32 bytes from x2 to x3, reversed; returns to x1
    a.label("rev32")
    a.emit(asm_i(0x13, 4, 2, 31, 0), asm_i(0x13, 5, 3, 32, 0))
    a.label("rev32_loop")
    a.emit(asm_i(0x03, 6, 4, 0, 4),                      # lbu
           asm_s(0, 3, 6, 0),                            # sb
           asm_i(0x13, 4, 4, -1, 0), asm_i(0x13, 3, 3, 1, 0))
    a.branch(6, 3, 5, "rev32_loop")                      # bltu x3, x5
    a.emit(asm_i(0x67, 0, 1, 0, 0))                      # ret
    # -- one signature --
    a.label("sig")
    a.emit(phantom_hint_input(),
           asm_i(0x13, 2, 0, ER_LEN, 0), hint_storew(2),
           asm_i(0x13, 2, 0, ER_IN, 0), asm_i(0x13, 3, 0, ER_INPUT_BYTES // 4, 0),
           hint_buffer(2, 3))
    _rev32_call(a, ER_IN, ER_Z)                          # z
    _rev32_call(a, ER_IN + 64, ER_R, auipc=True)           # R.x = r
    _rev32_call(a, ER_IN + 96, ER_S)                     # s
    # R.y: sqrt(r^3 + 7) over p, hinted and checked
    a.emit(*_mod(MUL_F7, ER_T1, ER_R, ER_R, 0), *_mod(MUL_F7, ER_T2, ER_T1, ER_R, 0),
           *_mod(ADD_F7, ER_RHS, ER_T2, ER_SEVEN, 0),
           modular_r(7, 0, 25, 0, 0),                    # HintSqrt [x25]
           asm_i(0x13, 2, 0, ER_OK, 0), hint_storew(2),
           asm_i(0x13, 2, 0, ER_RY, 0), asm_i(0x13, 3, 0, 8, 0), hint_buffer(2, 3),
           *_mod(MUL_F7, ER_T1, ER_RY, ER_RY, 0),
           asm_i(0x13, 26, 0, ER_T1, 0), asm_i(0x13, 27, 0, ER_RHS, 0),
           modular_r(ISEQ_F7, 6, 26, 27, 0),             # x6 = (y^2 == rhs)
           asm_i(0x03, 5, 0, ER_OK, 2),                  # lw x5 = hint ok
           asm_r(0x33, 7, 5, 6, 7, 0))                   # and
    a.branch(0, 7, 0, "fail")                            # beq x7, x0
    a.emit(asm_i(0x03, 5, 0, ER_RY, 4), asm_i(0x13, 5, 5, 1, 7),   # y parity
           asm_i(0x03, 6, 0, ER_IN + 63, 4), asm_i(0x13, 6, 6, -27, 0))  # v - 27
    a.branch(0, 5, 6, "parity_ok")
    a.emit(*_mod(SUB_F7, ER_RY, ER_ZERO, ER_RY, 0))      # y = p - y
    a.label("parity_ok")
    # over n: w = 1/r, u1 = -z w, u2 = s w
    a.emit(*_mod(DIV_F7, ER_W, ER_ONE, ER_R, 1), *_mod(MUL_F7, ER_U1, ER_Z, ER_W, 1),
           *_mod(SUB_F7, ER_U1, ER_ZERO, ER_U1, 1), *_mod(MUL_F7, ER_U2, ER_S, ER_W, 1),
           asm_i(0x13, 25, 0, ER_GR, 0), asm_i(0x13, 26, 0, ER_G, 0),
           asm_i(0x13, 27, 0, ER_R, 0),
           ec_r(EC_ADD_NE_F7, 25, 26, 27),               # G + R
           asm_i(0x13, r["bit"], 0, 255, 0))
    # Shamir's ladder: skip the leading zero pairs
    a.label("skip")
    a.emit(*_pair_words(r))
    a.branch(1, r["pair"], 0, "found")                   # bne pair, x0
    a.emit(asm_i(0x13, r["bit"], r["bit"], -1, 0))
    a.jal(0, "skip")
    a.label("found")                                     # acc = table[pair]
    a.emit(asm_r(0x33, 17, r["pair"], r["c64"], 0, 1),   # mul: pair * 64
           asm_r(0x33, r["entry"], r["table"], 17, 0, 0))
    for k in range(16):
        a.emit(asm_i(0x03, 5, r["entry"], 4 * k, 2), asm_s(2, r["acc"], 5, 4 * k))
    a.jal(0, "next")
    a.label("step")
    a.emit(ec_r(EC_DOUBLE_F7, r["acc"], r["acc"], 0), *_pair_words(r))
    a.branch(0, r["pair"], 0, "next")                    # beq pair, x0
    a.emit(asm_r(0x33, 17, r["pair"], r["c64"], 0, 1),
           asm_r(0x33, r["entry"], r["table"], 17, 0, 0),
           ec_r(EC_ADD_NE_F7, r["acc"], r["acc"], r["entry"]))
    a.label("next")
    a.emit(asm_i(0x13, r["bit"], r["bit"], -1, 0))
    a.branch(5, r["bit"], 0, "step")                     # bge bit, x0
    # keccak256(Qx || Qy, big-endian) against the expected address
    a.label("ladder_done")
    _rev32_call(a, ER_ACC, ER_BUF)
    _rev32_call(a, ER_ACC + 32, ER_BUF + 32, auipc=True)
    a.emit(asm_i(0x13, 2, 0, ER_HASH, 0), asm_i(0x13, 3, 0, ER_BUF, 0),
           asm_i(0x13, 4, 0, 64, 0), keccak_r(2, 3, 4), asm_i(0x13, 7, 0, 0, 0))
    for k, xr in enumerate(r["xor"]):
        a.emit(asm_i(0x03, 5, 0, ER_HASH + 12 + 4 * k, 2),
               asm_i(0x03, 6, 0, ER_IN + 128 + 4 * k, 2),
               asm_r(0x33, 6, 5, 6, 4, 0), asm_r(0x33, 7, 7, 6, 6, 0),    # xor, or
               asm_r(0x33, xr, xr, 5, 4, 0))
    a.emit(asm_r(0x33, 7, 0, 7, 3, 0), asm_i(0x13, 7, 7, 1, 4),   # sltu, xori
           asm_r(0x33, r["count"], r["count"], 7, 0, 0),
           asm_i(0x13, r["n"], r["n"], -1, 0))
    a.branch(1, r["n"], 0, "sig")                        # bne n, x0
    a.label("end")
    a.emit(reveal(r["count"], 0, 0),
           *(reveal(xr, 0, 4 + 4 * k) for k, xr in enumerate(r["xor"])), TERMINATE)
    a.label("fail")
    a.emit((1 << 20) | 0x0B)                             # terminate, exit code 1
    return a.resolve(), a.labels


def build_ecrecover_program(n):
    """Recovers n secp256k1 signers' addresses, as the EVM's ecrecover
    precompile does, and counts those equal to the expected ones.  A
    signature's 148 hinted bytes (``ecrecover_stream``) are read with
    hint_storew and hint_buffer; z, r and s are byte-reversed into
    little-endian blocks; R.y = sqrt(r^3 + 7) comes from the HintSqrt
    phantom, checked by MUL and IS_EQ (exit code 1 if it fails), and is
    negated mod p when its parity is not v - 27; over n, w = 1/r, u1 = -z w,
    u2 = s w; Q = u1 G + u2 R by Shamir's ladder over the table {G, R,
    G + R} (one EC_ADD_NE), its bit pairs read from the guest's own u1 and
    u2 from the top, leading zero pairs skipped, then EC_DOUBLE in place
    and EC_ADD_NE for each nonzero pair; keccak256 of Q big-endian and its
    bytes 12-31 compared with the expected address.  Reveals the number
    matched and the XOR of the recovered addresses' five words
    (``ecrecover_reference``).  Config: the default executors, keccak,
    moduli (secp256k1's p, n) and curves (SECP256K1_CURVE,)."""
    return _program(ecrecover_asm(n)[0])


ECRECOVER_MODULI = (SECP256K1_P, SECP256K1_N)


def _shamir(u1, u2, table):
    """The guest's ladder on the host: (Q, top bit index, adds after the
    first entry), or None where it would meet an EC_ADD_NE of equal x or a
    point at infinity."""
    pair = lambda i: ((u1 >> i) & 1) | (((u2 >> i) & 1) << 1)
    i = 255
    while pair(i) == 0:
        i -= 1
    top, acc, adds = i, table[pair(i)], 0
    for i in range(top - 1, -1, -1):
        acc = ec_add(acc, acc)
        if acc is None:
            return None
        if pair(i):
            if acc[0] == table[pair(i)][0]:
                return None
            acc, adds = ec_add(acc, table[pair(i)]), adds + 1
    return acc, top, adds


@functools.lru_cache(maxsize=None)
def _ecrecover_signatures(n, seed):
    """n signatures from seeded keys, messages and nonces: per signature
    (the 128-byte precompile input, the expected 20-byte address, whether
    R.y was negated, the ladder's top bit and its adds)."""
    rng = np.random.default_rng(seed)
    big = lambda: int.from_bytes(rng.bytes(32), "big")
    N, p = SECP256K1_N, SECP256K1_P
    out = []
    while len(out) < n:
        d = big() % N
        msg = rng.bytes(32)
        z = int.from_bytes(keccak256(msg), "big")
        k = big() % N
        if d == 0 or k == 0 or z >= N:
            continue
        rx, _ = ec_mul(k, SECP256K1_G)
        if rx >= N or rx == SECP256K1_GX:
            continue
        r, s, recid = ecdsa_sign_recoverable(z, d, k)
        y = pow(r ** 3 + 7, (p + 1) // 4, p)
        negated = (y & 1) != recid
        R = (r, p - y if negated else y)
        w = pow(r, -1, N)
        u1, u2 = (-z * w) % N, (s * w) % N
        ladder = _shamir(u1, u2, (None, SECP256K1_G, R, ec_add(SECP256K1_G, R)))
        qx, qy = ec_mul(d, SECP256K1_G)
        if ladder is None or ladder[0] != (qx, qy):
            continue
        addr = keccak256(qx.to_bytes(32, "big") + qy.to_bytes(32, "big"))[12:]
        inp = (z.to_bytes(32, "big") + (27 + recid).to_bytes(32, "big")
               + r.to_bytes(32, "big") + s.to_bytes(32, "big"))
        out.append((inp, addr, negated, ladder[1], ladder[2]))
    return tuple(out)


def ecrecover_inputs(n, seed=0):
    """[(128-byte precompile input, expected 20-byte address)] for n
    signatures, each from its own key (seeded by ``seed``)."""
    return [(inp, addr) for inp, addr, *_ in _ecrecover_signatures(n, seed)]


def ecrecover_stream(n, seed=0):
    """The guest's input stream: a signature's 148 bytes an input."""
    return [list(inp + addr) for inp, addr in ecrecover_inputs(n, seed)]


def ecrecover_reference(n, seed=0):
    """The 32 public-value bytes: n (every signature matched) and the XOR
    of the expected addresses' five little-endian words, from Python ints."""
    xor = [0] * ER_ADDR_WORDS
    for _, addr in ecrecover_inputs(n, seed):
        for k in range(ER_ADDR_WORDS):
            xor[k] ^= int.from_bytes(addr[4 * k:4 * k + 4], "little")
    pv = n.to_bytes(4, "little") + b"".join(v.to_bytes(4, "little") for v in xor)
    return list(pv + bytes(32 - len(pv)))


def ecrecover_counts(n, seed=0):
    """Instructions the guest runs (its label distances over the host
    ladder's control flow), EC adds and doubles, modular ops by chip and
    keccak blocks."""
    _, lab = ecrecover_asm(n)
    loop = lab["sig"] - 1 - lab["rev32_loop"]              # lbu, sb, addi, addi, bltu
    rev = (lab["rev32_loop"] - lab["rev32"]) + 32 * loop + 1
    skip_iter = lab["found"] - lab["skip"]               # pair, bne, addi, jal
    step_add = lab["ladder_done"] - lab["step"]          # double, pair, beq, mul, add,
    step_zero = step_add - 3                             # add_ne; addi, bge
    insns = lab["rev32"] + (lab["fail"] - 1 - lab["end"])   # prologue; reveals
    adds = doubles = negs = 0
    for _, _, negated, top, n_add in _ecrecover_signatures(n, seed):
        insns += (lab["skip"] - lab["sig"]) - 4 * (not negated) + 3 * rev
        insns += (255 - top) * skip_iter + skip_iter - 2
        insns += (lab["step"] - lab["found"]) + 2 + top * step_zero + n_add * 3
        insns += (lab["end"] - lab["ladder_done"]) + 2 * rev
        adds, doubles, negs = adds + 1 + n_add, doubles + top, negs + negated
    return {"insns": insns, "ec_add_ne": adds, "ec_double": doubles,
            "modular_muldiv_0": 3 * n, "modular_addsub_0": n + negs, "modular_iseq_0": n,
            "modular_muldiv_1": 3 * n, "modular_addsub_1": n, "keccak_blocks": n}


# -- Fp2 and the pairing hint (tests/test_vm_fp2.py:19-63,
# tests/test_pairing.py:138-194) ---------------------------------------------

BN254_P = BN254.p
# Fp2 base funct7s (reference ComplexExtFieldBaseFunct7)
FP2_ADD_F7, FP2_SUB_F7, FP2_MUL_F7, FP2_DIV_F7, FP2_SETUP_F7 = range(5)

FP2_A0 = 0x1234_5678_9ABC_DEF0_1111_2222_3333_4444_5555_6666_7777_8888_9999_AAAA_BBBB_CCCC % BN254_P
FP2_A1 = 0x0FED_CBA9_8765_4321_AAAA_BBBB_CCCC_DDDD_EEEE_FFFF_0000_1111_2222_3333_4444_5555 % BN254_P
FP2_B0 = 0x0101_0202_0303_0404_0505_0606_0707_0808_0909_0A0A_0B0B_0C0C_0D0D_0E0E_0F0F_1010 % BN254_P
FP2_B1 = 0x1111_2222_0000_0001_0000_0000_0000_0000_0000_0000_0000_0000_0000_0000_0000_0007 % BN254_P
FP2_PT_A, FP2_PT_B, FP2_PT_C = 0x200, 0x280, 0x300


def fp2_r(base_f7, rd, rs1, rs2, fp2_idx=0):
    return (((fp2_idx * 8 + base_f7) << 25) | (rs2 << 20) | (rs1 << 15)
            | (0b010 << 12) | (rd << 7) | 0x2B)


def build_fp2_program():
    """a and b hinted into [FP2_PT_A] and [FP2_PT_B]; c = a + b, c = c * b,
    c = c / b, c = c - b (so c = a) over BN254's prime after a SETUP (a
    nop); reveals c's low word.  Input ``fp2_hint_input()``; executors alu,
    loadstore, hintstore; ``fp2=(BN254_P,)``."""
    words = [phantom_hint_input()]
    words += [asm_i(0x13, 1, 0, FP2_PT_A, 0), hint_storew(1)]
    for k in range(16):
        words += [asm_i(0x13, 1, 0, FP2_PT_A + 4 * k, 0), hint_storew(1)]
    for k in range(16):
        words += [asm_i(0x13, 1, 0, FP2_PT_B + 4 * k, 0), hint_storew(1)]
    return _program(words + [
        asm_i(0x13, 1, 0, FP2_PT_A, 0),
        asm_i(0x13, 2, 0, FP2_PT_B, 0),
        asm_i(0x13, 3, 0, FP2_PT_C, 0),
        fp2_r(FP2_SETUP_F7, 3, 1, 2),    # setup -> nop
        fp2_r(FP2_ADD_F7, 3, 1, 2),      # c = a + b
        fp2_r(FP2_MUL_F7, 3, 3, 2),      # c = (a+b) * b
        fp2_r(FP2_DIV_F7, 3, 3, 2),      # c = c / b = a + b
        fp2_r(FP2_SUB_F7, 3, 3, 2),      # c = c - b = a
        asm_i(0x03, 6, 3, 0, 2),
        reveal(6, 0, 0),
        TERMINATE,
    ])


def fp2_hint_input():
    blob = (FP2_A0.to_bytes(32, "little") + FP2_A1.to_bytes(32, "little")
            + FP2_B0.to_bytes(32, "little") + FP2_B1.to_bytes(32, "little"))
    return [list(blob)]


PH_BUF = 0x400     # hinted P||Q bytes land here
PH_DESC_P = 0x600  # (p_ptr, p_len)
PH_DESC_Q = 0x608  # (q_ptr, q_len)
PH_OUT = 0x700     # hint readback (768 bytes for BN254)


def pairing_hint_insn(rs1, rs2, pairing_idx=0):
    """The HintFinalExp phantom over the descriptors at [rs1] and [rs2]."""
    return ((pairing_idx * 16) << 25) | (rs2 << 20) | (rs1 << 15) \
        | (0b011 << 12) | 0x2B


def build_pairing_hint_program(n_points=2):
    """n_points BN254 pairs hinted into [PH_BUF] with one HINT_BUFFER, their
    descriptors written, HintFinalExp issued, its (c, u) read back into
    [PH_OUT] with another; reveals c's low word.  Input
    ``pairing_hint_stream()``; executors alu, loadstore, hintstore."""
    n = BN254.num_limbs
    p_bytes = n_points * 2 * n
    q_bytes = n_points * 4 * n
    hint_words = 2 * 12 * n // 4  # c + u
    return _program([
        phantom_hint_input(),
        asm_i(0x13, 1, 0, PH_BUF - 4, 0),        # x1 = PH_BUF-4 (len header)
        asm_i(0x13, 2, 0, (p_bytes + q_bytes + 4) // 4, 0),
        hint_buffer(1, 2),                       # read len + P||Q
        # descriptors
        asm_i(0x13, 3, 0, PH_BUF, 0),            # p_ptr
        asm_i(0x13, 4, 0, n_points, 0),          # p_len (count)
        asm_i(0x13, 10, 0, PH_DESC_P, 0),
        asm_s(2, 10, 3, 0),                      # sw x3, 0(x10)
        asm_s(2, 10, 4, 4),                      # sw x4, 4(x10)
        asm_i(0x13, 3, 0, PH_BUF + p_bytes, 0),  # q_ptr
        asm_i(0x13, 11, 0, PH_DESC_Q, 0),
        asm_s(2, 11, 3, 0),
        asm_s(2, 11, 4, 4),
        pairing_hint_insn(10, 11, pairing_idx=0),
        # read the hint back into PH_OUT
        asm_i(0x13, 1, 0, PH_OUT, 0),
        asm_i(0x13, 2, 0, hint_words, 0),
        hint_buffer(1, 2),
        asm_i(0x03, 8, 1, 0, 2),                 # lw x8, 0(PH_OUT)
        reveal(8, 0, 0),
        TERMINATE,
    ])


def g1_neg(p):
    return (p[0], (-p[1]) % BN254_P)


def pairing_bytes(ps, qs) -> bytes:
    """The descriptors' layout: each P's x || y, then each Q's x0 || x1 ||
    y0 || y1, 32 bytes little-endian apiece."""
    out = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little") for x, y in ps)
    return out + b"".join(c.to_bytes(32, "little") for q in qs for xy in q for c in xy)


def pairing_hint_stream():
    """``build_pairing_hint_program()``'s input: (G1, -G1) and (G2, G2)."""
    return [list(pairing_bytes([BN254.g1, g1_neg(BN254.g1)], [BN254.g2, BN254.g2]))]


# -- the pairing guest ---------------------------------------------------------

# The guest's heap: 64-byte slots from PG_REGION (the hinted pairs at
# PG_IN, the hint's c and u, the descriptors and the public-value
# accumulators, then G1's fractions, the constants and the value pool).
# A pointer reaches its slot by one addi from a base register: base k
# holds PG_REGION + 2048 + 4096 k.
PG_REGION = 0x10000
PG_IN = PG_REGION + 64
PG_REGS = {"n": 8, "held": 9, "eq": 5, "all": 6, "tmp": 7}
PG_PTR_REGS = tuple(range(10, 28))   # the pointer cache, least recently used first out
PG_BASE_REGS = (28, 29, 30, 31)
PG_PV_WORDS = 7  # public values after the count: the XOR of c's first seven Fp words


class _Val:
    """A value of the recording tower: an Fp2 element in a 64-byte slot."""

    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n


class _Body:
    """The pairing guest's Fp2 ops as the recording tower makes them: each
    value numbered, as an input or constant slot or the output of one op
    ("add", "sub", "mul", "div" on the Fp2 chips; "conj" on the modular
    ones)."""

    def __init__(self):
        self.slots = {}    # value -> fixed address (inputs and fractions)
        self.consts = {}   # (c0, c1) -> value
        self.ops = []      # (name, out, a, b)
        self.count = 0

    def fixed(self, addr):
        v = _Val(self.count)
        self.count += 1
        self.slots[v.n] = addr
        return v

    def ref(self, x):
        if isinstance(x, _Val):
            return x.n
        key = (x[0] % BN254_P, x[1] % BN254_P)
        if key not in self.consts:
            self.consts[key] = self.count
            self.count += 1
        return self.consts[key]

    def op(self, name, a, b=None):
        out = _Val(self.count)
        self.count += 1
        self.ops.append((name, out.n, self.ref(a), None if b is None else self.ref(b)))
        return out


@dataclass(frozen=True)
class _RecordingTower(Tower):
    """``Tower`` whose Fp2 ops on ``_Val``s append ops to ``body``; on
    constants they compute as ``Tower``'s do.  Adds of zero and products
    by zero or one make no op."""

    body: object = field(default=None, compare=False, hash=False)

    def _is(self, x, v):
        return isinstance(x, tuple) and (x[0] % self.p, x[1] % self.p) == v

    def f2_add(self, a, b):
        if isinstance(a, tuple) and isinstance(b, tuple):
            return super().f2_add(a, b)
        if self._is(a, F2_ZERO):
            return b
        return a if self._is(b, F2_ZERO) else self.body.op("add", a, b)

    def f2_sub(self, a, b):
        if isinstance(a, tuple) and isinstance(b, tuple):
            return super().f2_sub(a, b)
        return a if self._is(b, F2_ZERO) else self.body.op("sub", a, b)

    def f2_neg(self, a):
        return super().f2_neg(a) if isinstance(a, tuple) else self.body.op("sub", F2_ZERO, a)

    def f2_mul(self, a, b):
        if isinstance(a, tuple) and isinstance(b, tuple):
            return super().f2_mul(a, b)
        if self._is(a, F2_ZERO) or self._is(b, F2_ZERO):
            return F2_ZERO
        if self._is(a, F2_ONE):
            return b
        return a if self._is(b, F2_ONE) else self.body.op("mul", a, b)

    def f2_sq(self, a):
        return super().f2_sq(a) if isinstance(a, tuple) else self.body.op("mul", a, a)

    def f2_smul(self, a, k):
        return super().f2_smul(a, k) if isinstance(a, tuple) else self.f2_mul(a, (k, 0))

    def f2_conj(self, a):
        return super().f2_conj(a) if isinstance(a, tuple) else self.body.op("conj", a)

    def f2_inv(self, a):
        return super().f2_inv(a) if isinstance(a, tuple) else self.body.op("div", F2_ONE, a)

    def f2_embed(self, x):
        # a fraction's slot already holds (x, 0)
        return x if isinstance(x, _Val) else super().f2_embed(x)


@dataclass(frozen=True)
class _RecordingCurve(PairingCurveParams):
    """A curve's parameters whose ``tower`` is a ``_RecordingTower`` that
    appends to ``body``."""

    body: object = field(default=None, compare=False, hash=False)

    @functools.cached_property
    def tower(self) -> Tower:
        return _RecordingTower(self.p, self.xi, body=self.body)


def _slot(k):
    return PG_REGION + 64 * k


@functools.lru_cache(maxsize=None)
def _pairing_plan(pairs):
    """The pairing guest's straight-line check, its slots and op counts:
    ``final_exp_product`` run over the recording tower on the hinted
    pairs, c and u, then dead ops dropped and each op's output given the
    lowest pool slot free at that op (its operands freed first when it is
    their last use, so that an op may write over its input)."""
    if pairs < 1:
        raise ValueError("at least one pair")
    body = _Body()
    out_slot = 1 + 3 * pairs                  # slot 0 ends in the length header
    ps = [(_slot(1 + k), _slot(1 + k) + 32) for k in range(pairs)]
    qs = [(body.fixed(_slot(1 + pairs + 2 * k)), body.fixed(_slot(2 + pairs + 2 * k)))
          for k in range(pairs)]
    c = tuple(body.fixed(_slot(out_slot + k)) for k in range(6))
    u = tuple(body.fixed(_slot(out_slot + 6 + k)) for k in range(6))
    misc = out_slot + 12                      # descriptors, then the accumulators
    fracs_at = misc + 1
    fracs = [(body.fixed(_slot(fracs_at + 2 * k)), body.fixed(_slot(fracs_at + 2 * k + 1)))
             for k in range(pairs)]
    cv = _RecordingCurve(**{f.name: getattr(BN254, f.name)
                            for f in dataclasses.fields(BN254)}, body=body)
    product = final_exp_product(cv, c, u, fracs, qs)
    body.ref(F2_ZERO), body.ref(F2_ONE)       # the check's and the conjugates' operands
    outs = [body.ref(x) for x in product]
    # constants after the fractions, the pool after the constants
    const_at = fracs_at + 2 * pairs
    for k, (value, n) in enumerate(sorted(body.consts.items(), key=lambda kv: kv[1])):
        body.slots[n] = _slot(const_at + k)
    pool_at = const_at + len(body.consts)
    needed = {n for n in outs if n not in body.slots}
    kept = []
    for op in reversed(body.ops):
        if op[1] in needed:
            kept.append(op)
            needed.update(x for x in op[2:] if x is not None and x not in body.slots)
    kept.reverse()
    last = {}
    for i, (_, _, a, b) in enumerate(kept):
        last[a] = last[b] = i
    for n in outs:
        last[n] = len(kept)
    free, top, slots = [], pool_at, dict(body.slots)
    for i, (_, out, a, b) in enumerate(kept):
        for x in {a, b}:
            if x is not None and x not in body.slots and last[x] == i:
                heapq.heappush(free, slots[x])
        if free:
            slots[out] = heapq.heappop(free)
        else:
            slots[out], top = _slot(top), top + 1
    names = [op[0] for op in kept]
    return {"ops": [(name, slots[out], slots[a], None if b is None else slots[b])
                    for name, out, a, b in kept],
            "outs": [slots[n] for n in outs], "ps": ps,
            "fracs": [(slots[x.n], slots[y.n]) for x, y in fracs],
            "desc": _slot(misc), "acc": _slot(misc) + 16, "out": _slot(out_slot),
            "zero": slots[body.consts[F2_ZERO]], "one": slots[body.consts[F2_ONE]],
            "consts": {slots[n]: value for value, n in body.consts.items()},
            "end": _slot(top), "counts": {k: names.count(k) for k in
                                          ("add", "sub", "mul", "div", "conj")}}


class _PtrCache:
    """Pointer registers: an address in a register is used again; one that
    is not gets the least recently used register not named by the same
    instruction, set by one addi from its base register."""

    def __init__(self, a):
        self.a, self.regs = a, collections.OrderedDict()

    def get(self, addrs):
        out, pinned = [], set()
        for addr in addrs:
            reg = self.regs.get(addr)
            if reg is None:
                free = [r for r in PG_PTR_REGS if r not in self.regs.values()]
                if free:
                    reg = free[0]
                else:
                    old = next(x for x, r in self.regs.items() if r not in pinned)
                    reg = self.regs.pop(old)
                self.a.emit(asm_i(0x13, reg, *_base_off(addr), 0))
            else:
                self.regs.pop(addr)
            self.regs[addr] = reg
            pinned.add(reg)
            out.append(reg)
        return out


def _base_off(addr):
    """(base register, offset) that reach the heap address ``addr``."""
    k = (addr - PG_REGION) // 4096
    return PG_BASE_REGS[k], addr - (PG_REGION + 2048 + 4096 * k)


def pairing_asm(n, pairs=4):
    """The pairing guest's words and labels (``build_pairing_program``)."""
    if n < 1:
        raise ValueError("at least one check")
    plan = _pairing_plan(pairs)
    if plan["end"] - PG_REGION > 4096 * len(PG_BASE_REGS):
        raise ValueError(f"the guest's heap passes its base registers: {plan['end']:#x}")
    r = PG_REGS
    a = _Asm()
    for k, reg in enumerate(PG_BASE_REGS):
        a.emit(*_imm32(reg, PG_REGION + 2048 + 4096 * k))
    for addr, value in sorted(plan["consts"].items()):
        for w in range(16):
            word = (value[w // 8] >> (32 * (w % 8))) & 0xFFFFFFFF
            if word:
                base, off = _base_off(addr + 4 * w)
                a.emit(*_imm32(r["tmp"], word), asm_s(2, base, r["tmp"], off))
    # the descriptors: (P's pointer, pairs), (Q's pointer, pairs)
    for off, value in ((0, PG_IN), (4, pairs), (8, PG_IN + 64 * pairs), (12, pairs)):
        base, imm = _base_off(plan["desc"] + off)
        a.emit(*_imm32(r["tmp"], value), asm_s(2, base, r["tmp"], imm))
    a.emit(*load_imm(r["n"], n), asm_i(0x13, r["held"], 0, 0, 0))
    a.label("loop")
    a.emit(phantom_hint_input(), asm_i(0x13, 1, *_base_off(PG_IN - 4), 0),
           asm_i(0x13, 2, 0, 1 + 48 * pairs, 0), hint_buffer(1, 2),
           asm_i(0x13, 3, *_base_off(plan["desc"]), 0),
           asm_i(0x13, 4, *_base_off(plan["desc"] + 8), 0), pairing_hint_insn(3, 4),
           asm_i(0x13, 1, *_base_off(plan["out"]), 0), asm_i(0x13, 2, 0, 192, 0),
           hint_buffer(1, 2))
    cache = _PtrCache(a)
    one = plan["one"]
    for (xy, yi), (px, py) in zip(plan["fracs"], plan["ps"]):
        a.emit(modular_r(DIV_F7, *cache.get([xy, px, py])))
        a.emit(modular_r(DIV_F7, *cache.get([yi, one, py])))
    f7 = {"add": FP2_ADD_F7, "sub": FP2_SUB_F7, "mul": FP2_MUL_F7, "div": FP2_DIV_F7}
    zero = plan["zero"]
    for name, out, x, y in plan["ops"]:
        if name == "conj":
            a.emit(modular_r(ADD_F7, *cache.get([out, x, zero])),
                   modular_r(SUB_F7, *cache.get([out + 32, zero, x + 32])))
        else:
            a.emit(fp2_r(f7[name], *cache.get([out, x, y])))
    # held when the product's 12 Fp words equal one's: IS_EQ, whose inputs
    # must be reduced
    a.emit(asm_i(0x13, r["all"], 0, 1, 0))
    for k, addr in enumerate(plan["outs"]):
        for h in (0, 32):
            want = one if (k, h) == (0, 0) else zero
            x, w = cache.get([addr + h, want])
            a.emit(modular_r(ISEQ_F7, r["eq"], x, w), asm_r(0x33, r["all"], r["all"], r["eq"], 7, 0))
    a.emit(asm_r(0x33, r["held"], r["held"], r["all"], 0, 0))
    for k in range(PG_PV_WORDS):                          # XOR of c's words
        acc, c_word = _base_off(plan["acc"] + 4 * k), _base_off(plan["out"] + 32 * k)
        a.emit(asm_i(0x03, r["eq"], *acc, 2), asm_i(0x03, r["tmp"], *c_word, 2),
               asm_r(0x33, r["eq"], r["eq"], r["tmp"], 4, 0), asm_s(2, acc[0], r["eq"], acc[1]))
    a.emit(asm_i(0x13, r["n"], r["n"], -1, 0))
    a.branch(0, r["n"], 0, "end")
    a.label("back")
    a.jal(0, "loop")
    a.label("end")
    a.emit(reveal(r["held"], 0, 0))
    for k in range(PG_PV_WORDS):
        a.emit(asm_i(0x03, r["eq"], *_base_off(plan["acc"] + 4 * k), 2),
               reveal(r["eq"], 0, 4 + 4 * k))
    a.label("terminate")
    a.emit(TERMINATE)
    return a.resolve(), a.labels


def build_pairing_program(n, pairs=4):
    """BN254 pairing checks, the Miller loop and residue check of
    ``assert_final_exp_is_one``, over n inputs of ``pairs`` finite, valid
    pairs each (``pairing_stream``), every check in the VM.  It is not
    EIP-197's ecPairing: there are no on-curve or subgroup checks and no
    points at infinity (a P with y = 0 ends in a modular DIV's
    ExecutionError).  An input's pairs are read
    with one HINT_BUFFER; the HintFinalExp phantom gives the residue
    witness (c, u), read back with another; each P's x/y and 1/y come from
    modular DIVs over p into slots whose high half is zero (Fp2's
    embedding); then ``final_exp_product``'s arithmetic, recorded once over
    the Fp2 ops and emitted as one straight-line body of Fp2 instructions
    (the conjugates as a modular ADD and SUB) over reused heap slots, each
    pointer from the pointer cache; the check holds when IS_EQ finds the
    product's 12 Fp words equal to one's.  The body runs once an input in a
    loop.  Reveals the number of checks held and the XOR over inputs of the
    low words of c's first seven Fp coefficients (``pairing_reference``).
    Config: the default executors, ``moduli=(BN254_P,)``,
    ``fp2=(BN254_P,)``."""
    return _program(pairing_asm(n, pairs)[0])


def _g1_add(p1, p2):
    """Affine addition on BN254's G1 (y^2 = x^3 + 3), None at infinity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    p = BN254_P
    if x1 == x2:
        if (y1 + y2) % p == 0:
            return None
        lam = 3 * x1 * x1 * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    return x3, (lam * (x1 - x3) - y1) % p


def _g2_mul(k, q):
    """k Q on the twist by double-and-add, from the Miller loop's steps."""
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = miller_double_step(BN254, acc)[0]
        if bit == "1":
            acc = q if acc is None else miller_add_step(BN254, acc, q)[0]
    return acc


def _g1_mul(k, pt):
    acc = None
    while k:
        if k & 1:
            acc = _g1_add(acc, pt)
        pt = _g1_add(pt, pt)
        k >>= 1
    return acc


@functools.lru_cache(maxsize=None)
def pairing_inputs(n, pairs=4, seed=0):
    """n inputs of ``pairs`` (P, Q) each, every input from its own seed:
    P_i = a_i G1 and Q_i = b_i G2 for i < pairs - 1, then
    P = -(sum a_i b_i) G1 and Q = G2, so that every check holds."""
    if pairs < 2:
        raise ValueError("a check that holds needs two pairs or more")
    r = BN254.r
    out = []
    for i in range(n):
        rng = np.random.default_rng([seed, i])
        while True:
            ab = [(int.from_bytes(rng.bytes(32), "big") % r,
                   int.from_bytes(rng.bytes(32), "big") % r) for _ in range(pairs - 1)]
            s = sum(x * y for x, y in ab) % r
            if s and all(x and y for x, y in ab):
                break
        ps = [_g1_mul(x, BN254.g1) for x, _ in ab] + [_g1_mul(r - s, BN254.g1)]
        qs = [_g2_mul(y, BN254.g2) for _, y in ab] + [BN254.g2]
        out.append((tuple(ps), tuple(qs)))
    return tuple(out)


def pairing_stream(n, pairs=4, seed=0):
    """The guest's inputs: an input's P's then Q's (``pairing_bytes``)."""
    return [list(pairing_bytes(ps, qs)) for ps, qs in pairing_inputs(n, pairs, seed)]


@functools.lru_cache(maxsize=None)
def pairing_reference(n, pairs=4, seed=0):
    """The 32 public-value bytes from the host library: the number of
    inputs whose residue check holds (the Miller loop, the hint (c, u),
    ``final_exp_product`` against one) and the XOR over inputs of the low
    words of c's first seven Fp coefficients."""
    held, xor = 0, [0] * PG_PV_WORDS
    for ps, qs in pairing_inputs(n, pairs, seed):
        c, u = final_exp_hint(BN254, multi_miller_loop(BN254, ps, qs))
        held += final_exp_product(BN254, c, u, g1_fracs(BN254, ps), qs) == F12_ONE
        cb = BN254.tower.f12_to_bytes(c, 32)
        for k in range(PG_PV_WORDS):
            xor[k] ^= int.from_bytes(cb[32 * k:32 * k + 4], "little")
    return list(b"".join(v.to_bytes(4, "little") for v in [held, *xor]))


def pairing_counts(n, pairs=4):
    """Instructions the guest runs (its label distances; the body is
    straight-line), and the rows of each Fp2 and modular chip."""
    _, lab = pairing_asm(n, pairs)
    ops = _pairing_plan(pairs)["counts"]
    insns = lab["loop"] + n * (lab["back"] - lab["loop"]) + (n - 1) \
        + (lab["terminate"] - lab["end"])
    return {"insns": insns, "fp2_addsub_0": n * (ops["add"] + ops["sub"]),
            "fp2_muldiv_0": n * (ops["mul"] + ops["div"]),
            "modular_addsub_0": n * 2 * ops["conj"], "modular_muldiv_0": n * 2 * pairs,
            "modular_iseq_0": n * 12}


# ---------------------------------------------------------------------------
# the native (recursion) VM's guests
# ---------------------------------------------------------------------------

def build_native_program():
    """Copy of tests/test_native_vm.py:35-74: a straight-line native
    program through every native chip but FRI_REDUCED_OPENING and
    VERIFY_BATCH; publishes pv[0] = 3.  Run it with ``NATIVE_INPUTS``."""
    I = Instruction
    prog = [
        # felt arith: [10] = 7 + 8 (imm/imm), then mul / div
        I(FA.ADD, a=10, b=7, c=8, d=4, e=0, f=0),
        I(FA.MUL, a=11, b=10, c=3, d=4, e=4, f=0),
        I(FA.DIV, a=12, b=11, c=10, d=4, e=4, f=4),   # = 3
        # ext field: x = (1,2,3,4) at 20..23, y = (5,6,7,8) at 24..27
        *[I(FA.ADD, a=20 + k, b=k + 1, c=0, d=4, e=0, f=0) for k in range(4)],
        *[I(FA.ADD, a=24 + k, b=k + 5, c=0, d=4, e=0, f=0) for k in range(4)],
        # z = x*y at 28; w = z/y at 32 (== x, so w[0] == 1)
        I(FE.BBE4MUL, a=28, b=20, c=24, d=4, e=4),
        I(FE.BBE4DIV, a=32, b=28, c=24, d=4, e=4),
        # branch: if [32] == 1 skip the bad write
        I(NB.BEQ, a=32, b=1, c=8, d=4, e=0),
        I(FA.ADD, a=15, b=999, c=0, d=4, e=0, f=0),
        # loadstore with pointer cell: [50] = 32; LOADW [40] = mem[[50]]
        I(FA.ADD, a=50, b=32, c=0, d=4, e=0, f=0),
        I(NL.LOADW, a=40, b=0, c=50, d=4, e=4, f=4),
        I(NL.STOREW, a=40, b=0, c=41, d=4, e=4, f=0),
        # hint: input vec [17, 23, 29]; stream = [3,17,23,29] -> 44..47
        phantom(NativePhantom.HINT_INPUT),
        I(NL4.HINT_STOREW4, a=0, b=0, c=44, d=4, e=4, f=0),
        # jal: [60] = pc+4, jump +8 (skip bad write)
        I(NativeJalOpcode.JAL, a=60, b=8, d=4),
        I(FA.ADD, a=15, b=888, c=0, d=4, e=0, f=0),
        # range check [44] (= 3) against 16/14 bit split
        I(NativeRangeCheckOpcode.RANGE_CHECK, a=44, b=15, c=14, d=4),
        # poseidon2 adapter: permute 64..79 -> 80..95, compress -> 96..103
        I(Poseidon2Opcode.PERM_POS2, a=80, b=64, c=0, d=4, e=4),
        I(Poseidon2Opcode.COMP_POS2, a=96, b=80, c=88, d=4, e=4),
        # publish pv[0] = [12]
        I(FA.ADD, a=0, b=12, c=0, d=3, e=4, f=0),
        I(SystemOpcode.TERMINATE, c=0),
    ]
    return VmExe(program=Program(instructions=prog), pc_start=0)


NATIVE_INPUTS = [[17, 23, 29]]

# Path 10: the FRI query phase of a leaf verifier as a native program.  A
# query opens the trace's rows (two rows of 32 and 16 felts at the tallest
# height, one of 8 felts a height below), checks them against the
# commitment with one VERIFY_BATCH, reduces them with one
# FRI_REDUCED_OPENING, and walks the FRI layers: each layer's opened pair
# (two extension elements) checked by its own VERIFY_BATCH, the query's
# value found in it through a pointer and loadw4, and the pair folded.
NQ_LEVEL0 = (32, 16)
NQ_LEVEL1 = 8
NQ_OPENED = sum(NQ_LEVEL0) + NQ_LEVEL1


@functools.lru_cache(maxsize=None)
def native_query_asm(n_queries=84, depth=21, n_layers=20):
    """The path-10 guest's instructions and its regions: (Builder, labels).
    ``labels`` holds the first instruction of the loop body ("loop"), the
    loop's closing branch ("back") and, for each layer, the fold's two
    blocks: "then" (index bit 0) and "else" (bit 1) as [start, end)."""
    if not 1 <= n_layers < depth <= 30:
        raise ValueError("need 1 <= n_layers < depth <= 30")
    b = Builder()
    l0 = sum(NQ_LEVEL0)
    # buffers at fixed addresses, filled anew by each query's hints
    setup = b.array(4 + 4 * n_layers)           # alpha, then each layer's beta
    alpha = Ext(setup.addr)
    opened = b.array(NQ_OPENED)
    sibs = b.array(8 * depth)
    commit = b.array(8)
    claims = b.array(4 * NQ_OPENED)
    layer_open = [b.array(8) for _ in range(n_layers)]
    x = Ext(b.alloc(4))
    cur, diff, tot = b.ext(), b.ext(), b.ext()
    acc = b.array(16)
    idx, i, link = b.felt(), b.felt(), b.felt()
    # before the loop: the challenges, each call site's descriptor, the
    # accumulator and the counter
    b.read_vec_into(setup)
    main_desc = b.write_batch_descriptor(
        {0: (opened.addr, l0), 1: (opened.addr + l0, NQ_LEVEL1)}, depth)
    layer_desc = [b.write_batch_descriptor({0: (layer_open[l].addr, 8)}, depth - 1 - l)
                  for l in range(n_layers)]
    for k in range(16):
        b.mov(0, acc.felt(k))
    b.mov(0, i)
    loop = b.label()
    b.place(loop)
    labels = {"loop": len(b.insns), "then": [], "else": []}
    # the query index, its range check and its bits
    b.read_vec_into(FeltArray(idx.addr, 1))
    b.range_check(idx, min(depth, 15), max(depth - 15, 0))
    bits = b.bits_le(idx, depth)
    # the opened rows against the commitment, and their reduced opening
    b.emit(phantom(NativePhantom.HINT_FELT))
    for arr in (opened, sibs, commit, claims):
        b.read_hints_into(arr)
    b.verify_batch(main_desc, sibs, bits.addr, commit.addr, depth,
                   inside_rows=-(-l0 // 8) + -(-NQ_LEVEL1 // 8))
    b.fri_reduced_opening(opened, claims, NQ_OPENED, alpha, dst=cur)
    for l in range(n_layers):
        d = depth - 1 - l
        b.emit(phantom(NativePhantom.HINT_FELT))
        for arr in (layer_open[l], sibs.slice(0, 8 * d), commit):
            b.read_hints_into(arr)
        b.read_hints_into(FeltArray(x.addr, 4))
        b.verify_batch(layer_desc[l], sibs, bits.addr + l + 1, commit.addr, d,
                       inside_rows=1)
        with b.scope():
            bit = bits.felt(l)
            four_bit = b.mul(bit, 4)
            ours = b.loadw4(b.add(four_bit, layer_open[l].addr))
            sib = b.loadw4(b.sub(layer_open[l].addr + 4, four_bit))
            b.assert_eq_ext(ours, cur)
            odd, join = b.label(), b.label()
            b.branch_eq(bit, 1, odd)
            start = len(b.insns)
            b.esub(ours, sib, dst=diff)
            b.eadd(ours, sib, dst=tot)
            b.jal(join, link)
            labels["then"].append((start, len(b.insns)))
            b.place(odd)
            b.esub(sib, ours, dst=diff)
            b.eadd(sib, ours, dst=tot)
            labels["else"].append((len(b.insns) - 2, len(b.insns)))
            b.place(join)
            beta = Ext(setup.addr + 4 + 4 * l)
            b.eadd(tot, b.emul(b.ediv(diff, x), beta), dst=cur)
    # fold the query into the accumulator
    b.eadd(Ext(acc.addr), cur, dst=Ext(acc.addr))
    b.add(acc.felt(4), idx, dst=acc.felt(4))
    b.permute(acc, dst=acc)
    b.add(i, 1, dst=i)
    labels["back"] = len(b.insns)
    b.branch_ne(i, n_queries, loop)
    out = b.compress(acc.slice(0, 8), acc.slice(8, 8))
    for k in range(8):
        b.public_value(out.felt(k), k)
    b.halt(0)
    labels["end"] = len(b.insns)
    return b, labels


def build_native_query_program(n_queries=84, depth=21, n_layers=20, seed=0):
    """Path 10's guest: the FRI query phase of a leaf verifier over
    ``n_queries`` queries, a runtime loop.  Each query hints its index
    (range-checked, decomposed into ``depth`` constrained bits), its 56
    opened felts, their ``depth`` sibling digests and the commitment, and
    checks them with one VERIFY_BATCH (rows of 32 and 16 felts at level 0,
    one of 8 at level 1); reduces them with one FRI_REDUCED_OPENING against
    56 hinted extension values and the hinted alpha; then, for each of
    ``n_layers`` FRI layers l, checks the layer's opened pair by a
    VERIFY_BATCH of depth ``depth - 1 - l``, loads the query's value and
    its sibling through pointers (loadw4), asserts the value equals the
    running one, picks the fold's branch on the index bit (BEQ, JAL) and
    folds: (e0 + e1) + beta_l (e0 - e1) / x, x hinted.  The final value
    and the index go into a 16-felt accumulator, permuted once a query
    (PERM_POS2); at the end COMP_POS2 of its halves gives the 8 public
    values.  Every query has its own commitments, hinted.  The program is
    the same for every ``seed``, which is not read: it stands in the
    signature so that path 10's arguments pass alike to this function and
    to ``native_query_stream``, which makes the inputs from it."""
    b, _ = native_query_asm(n_queries, depth, n_layers)
    return b.compile()


def _ext_add(x, y):
    return tuple((p + q) % P_NATIVE for p, q in zip(x, y))


def _ext_sub(x, y):
    return tuple((p - q) % P_NATIVE for p, q in zip(x, y))


def _perm_rows(states: np.ndarray) -> np.ndarray:
    """Poseidon2 of each canonical (16,) row, through the plain batched
    permutation on the CPU."""
    words = torch.from_numpy(to_monty_np(states).view(np.int32))
    return canonical_np(permute_plain(words))


def _sponge_rows(segs: np.ndarray) -> np.ndarray:
    """The overwrite-rate sponge's digest of each (n,) row (VERIFY_BATCH's
    row hash, vm/circuit/native.py VerifyBatchAir)."""
    st = np.zeros((segs.shape[0], 16), dtype=np.uint64)
    for c0 in range(0, segs.shape[1], 8):
        chunk = segs[:, c0:c0 + 8]
        st[:, :chunk.shape[1]] = chunk
        st = _perm_rows(st)
    return st[:, :8]


def _compress_rows(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    return _perm_rows(np.concatenate([left, right], axis=1))[:, :8]


def _batch_roots(levels: dict, sibs: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """VERIFY_BATCH's commitment of each query's opening: ``levels`` maps
    a level to the (queries, n) felts hashed in there, ``sibs`` (queries,
    depth, 8) and ``bits`` (queries, depth)."""
    node = _sponge_rows(levels[0])
    for s in range(sibs.shape[1]):
        flip = bits[:, s:s + 1].astype(bool)
        left = np.where(flip, sibs[:, s], node)
        right = np.where(flip, node, sibs[:, s])
        node = _compress_rows(left, right)
        if s + 1 in levels:
            node = _compress_rows(node, _sponge_rows(levels[s + 1]))
    return node


@functools.lru_cache(maxsize=None)
def native_query_inputs(n_queries=84, depth=21, n_layers=20, seed=0):
    """The path-10 guest's inputs from ``seed``: alpha and each layer's
    beta, and for each query its index, opened rows, siblings, claims, each
    layer's pair and x, every commitment (computed here) and the value each
    layer folds to.  A dict of numpy arrays and lists of extension
    tuples."""
    rng = np.random.default_rng(seed)

    def felts(*shape):
        return rng.integers(0, P_NATIVE, size=shape, dtype=np.uint64)

    def ext():
        return tuple(int(v) for v in felts(4))

    alpha = ext()
    betas = [ext() for _ in range(n_layers)]
    idx = rng.integers(0, 1 << depth, size=n_queries, dtype=np.int64)
    bits = (idx[:, None] >> np.arange(depth)) & 1
    l0 = sum(NQ_LEVEL0)
    opened = felts(n_queries, NQ_OPENED)
    sibs = felts(n_queries, depth, 8)
    claims = felts(n_queries, NQ_OPENED, 4)
    commit = _batch_roots({0: opened[:, :l0], 1: opened[:, l0:]}, sibs, bits)
    # the reduced opening: sum_t alpha^t (claim_t - opened_t)
    cur = []
    for q in range(n_queries):
        acc, apow = (0, 0, 0, 0), (1, 0, 0, 0)
        for t in range(NQ_OPENED):
            c = [int(v) for v in claims[q, t]]
            diff = ((c[0] - int(opened[q, t])) % P_NATIVE, c[1], c[2], c[3])
            acc = _ext_add(acc, ext_mul_int(apow, diff))
            apow = ext_mul_int(apow, alpha)
        cur.append(acc)
    layers = []
    for l in range(n_layers):
        d = depth - 1 - l
        pairs = np.zeros((n_queries, 8), dtype=np.uint64)
        xs, folded = [], []
        for q in range(n_queries):
            sib = ext()
            b = int(bits[q, l])
            e0, e1 = (cur[q], sib) if b == 0 else (sib, cur[q])
            pairs[q] = e0 + e1
            x = ext()
            while x == (0, 0, 0, 0):
                x = ext()
            xs.append(x)
            t = ext_mul_int(ext_mul_int(_ext_sub(e0, e1), ext_inv_int(x)), betas[l])
            folded.append(_ext_add(_ext_add(e0, e1), t))
        lsibs = felts(n_queries, d, 8)
        root = _batch_roots({0: pairs}, lsibs, bits[:, l + 1:])
        layers.append({"pairs": pairs, "sibs": lsibs, "commit": root, "x": xs,
                       "folded": folded})
        cur = folded
    return {"alpha": alpha, "betas": betas, "idx": idx, "bits": bits, "opened": opened,
            "sibs": sibs, "claims": claims, "commit": commit, "layers": layers,
            "final": cur}


def native_query_stream(n_queries=84, depth=21, n_layers=20, seed=0):
    """The path-10 guest's input vectors, in the order it reads them: alpha
    and the betas, then for each query its index, its main opening (opened
    felts, siblings, commitment, claims) and each layer's (pair, siblings,
    commitment, x)."""
    inp = native_query_inputs(n_queries, depth, n_layers, seed)
    out = [list(inp["alpha"]) + [v for beta in inp["betas"] for v in beta]]
    for q in range(n_queries):
        out.append([int(inp["idx"][q])])
        out.append([int(v) for v in np.concatenate([
            inp["opened"][q], inp["sibs"][q].reshape(-1), inp["commit"][q],
            inp["claims"][q].reshape(-1)])])
        for layer in inp["layers"]:
            out.append([int(v) for v in np.concatenate([
                layer["pairs"][q], layer["sibs"][q].reshape(-1), layer["commit"][q]])]
                + list(layer["x"][q]))
    return out


def native_query_reference(n_queries=84, depth=21, n_layers=20, seed=0):
    """The guest's 8 public values from its inputs: the accumulator
    absorbs each query's final folded value and its index and is permuted,
    then its halves are compressed."""
    inp = native_query_inputs(n_queries, depth, n_layers, seed)
    acc = np.zeros((1, 16), dtype=np.uint64)
    for q in range(n_queries):
        acc[0, :4] = _ext_add(tuple(int(v) for v in acc[0, :4]), inp["final"][q])
        acc[0, 4] = (int(acc[0, 4]) + int(inp["idx"][q])) % P_NATIVE
        acc = _perm_rows(acc)
    return [int(v) for v in _perm_rows(acc)[0, :8]]


def _native_rows(insn) -> dict:
    """The rows one execution of a native instruction adds to each chip."""
    op = insn.opcode
    if FA.ADD <= op <= FA.DIV:
        return {"native_field_arithmetic": 1}
    if FE.FE4ADD <= op <= FE.BBE4DIV:
        return {"native_field_extension": 1}
    if op in (NB.BEQ, NB.BNE):
        return {"native_branch_eq": 1}
    if NL.LOADW <= op <= NL.HINT_STOREW:
        return {"native_loadstore": 1}
    if NL4.LOADW4 <= op <= NL4.HINT_STOREW4:
        return {"native_loadstore4": 1}
    if op in (NativeJalOpcode.JAL, NativeRangeCheckOpcode.RANGE_CHECK):
        return {"native_jal_rangecheck": 1}
    if op in (Poseidon2Opcode.PERM_POS2, Poseidon2Opcode.COMP_POS2):
        return {"native_poseidon2": 1}
    if op == FriOpcode.FRI_REDUCED_OPENING:
        return {"fri_reduced_opening": insn.c}
    if op == VerifyBatchOpcode.VERIFY_BATCH:
        return {"verify_batch": 2 * insn.e + 1, "verify_batch_inside": insn.f}
    if op == SystemOpcode.PHANTOM:
        return {"phantom": 1}
    raise ValueError(f"opcode {op:#x} is not a native one")


def native_query_counts(n_queries=84, depth=21, n_layers=20, seed=0):
    """Instructions the path-10 guest runs and each chip's rows (and
    Poseidon2 permutations), from its regions: the loop body runs once a
    query, each layer's "then" block when the index bit is 0 and its "else"
    block when it is 1; the inputs give the bits."""
    b, lab = native_query_asm(n_queries, depth, n_layers)
    bits = native_query_inputs(n_queries, depth, n_layers, seed)["bits"]
    times = [1] * lab["loop"] + [n_queries] * (lab["back"] + 1 - lab["loop"]) \
        + [1] * (lab["end"] - lab["back"] - 1)
    for l, ((t0, t1), (e0, e1)) in enumerate(zip(lab["then"], lab["else"])):
        zeros = int((bits[:, l] == 0).sum())
        times[t0:t1] = [zeros] * (t1 - t0)
        times[e0:e1] = [n_queries - zeros] * (e1 - e0)
    counts = collections.Counter()
    for insn, k in zip(b.insns, times):
        if insn.opcode == SystemOpcode.TERMINATE:
            continue
        counts["insns"] += k
        for chip, rows in _native_rows(insn).items():
            counts[chip] += k * rows
    # Poseidon2Air's rows: native_poseidon2's, and verify_batch's compresses
    # (a sibling row each, and an injected level) and sponge rows
    vb_top = [insn for insn in b.insns if insn.opcode == VerifyBatchOpcode.VERIFY_BATCH]
    injected = sum(1 for insn in vb_top if insn.e == depth)  # the main batch's level 1
    counts["poseidon2"] = counts["native_poseidon2"] + counts["verify_batch_inside"] \
        + (counts["verify_batch"] - n_queries * len(vb_top)) // 2 + n_queries * injected
    return dict(counts)
