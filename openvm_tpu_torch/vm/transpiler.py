"""RISC-V -> VM instruction transpiler: RV32IM, IO, int256, modular
arithmetic, short-Weierstrass ECC, Fp2, keccak256, sha256 and pairing.

Copy of openvm_tpu/vm/transpiler.py:1-306 (decoder, ``Rv32ITranspiler-
Extension``, ``Rv32MTranspilerExtension``, ``Rv32IoTranspilerExtension``),
:309-332 (``Keccak256TranspilerExtension``: KECCAK256 and SHA256), :335-381
(``Int256TranspilerExtension``: the eleven ALU-type funct7s and BEQ256;
like the JAX package's, it lowers no other 256-bit branch), :383-417
(``ModularTranspilerExtension``: SETUP lowers to ``nop``, rd = 0 to ``nop``
except for DIV, HintNonQr and HintSqrt to phantoms with the modulus index
in the high half of c), :453-480 (``EccTranspilerExtension``: custom-1
funct3 0b001, funct7 = curve index * 8 + {EC_ADD_NE 0, EC_DOUBLE 1, SETUP
2 to ``nop``}), :420-450 (``Fp2TranspilerExtension``: custom-1 funct3
0b010, funct7 = Fp2 index * 8 + {ADD 0, SUB 1, MUL 2, DIV 3, SETUP 4 to
``nop``}, rd = 0 to ``nop``), :480-503 (``PairingTranspilerExtension``:
custom-1 funct3 0b011, the HintFinalExp phantom with the pairing index in
the high half of c) and :507-557 (``Transpiler``, each extension shown
only the current word, the one it reads, and ``transpile_elf``).
The default extension list is the JAX package's, in its order
(:520-531).
"""

from __future__ import annotations

from dataclasses import dataclass

from .elf import Elf, memory_image_to_init_memory
from .instructions import (BaseAlu256Opcode, BaseAluOpcode,
                           PairingPhantom,
                           BranchEqual256Opcode, BranchEqualOpcode,
                           BranchLessThanOpcode, DivRemOpcode, Instruction,
                           LessThan256Opcode, LessThanOpcode, Mul256Opcode,
                           MulHOpcode, MulOpcode, P, Program,
                           Rv32AuipcOpcode, Rv32HintStoreOpcode,
                           Rv32JalLuiOpcode, Rv32JalrOpcode,
                           Rv32KeccakOpcode, Rv32LoadStoreOpcode,
                           Rv32Phantom, Rv32Sha256Opcode, Shift256Opcode,
                           ShiftOpcode, SysPhantom, SystemOpcode, VmExe, nop,
                           phantom, unimp)

# RISC-V base opcodes
OP_LUI = 0b0110111
OP_AUIPC = 0b0010111
OP_JAL = 0b1101111
OP_JALR = 0b1100111
OP_BRANCH = 0b1100011
OP_LOAD = 0b0000011
OP_STORE = 0b0100011
OP_IMM = 0b0010011
OP_ALU = 0b0110011
OP_FENCE = 0b0001111
OP_SYSTEM_RV = 0b1110011  # CSR_OPCODE in the reference
OP_CUSTOM0 = 0x0b  # SYSTEM_OPCODE in the reference

RV32M_FUNCT7 = 0x01
TERMINATE_FUNCT3 = 0b000
HINT_FUNCT3 = 0b001
REVEAL_FUNCT3 = 0b010
PHANTOM_FUNCT3 = 0b011
NATIVE_STOREW_FUNCT3 = 0b111
NATIVE_STOREW_FUNCT7 = 2
CSRRW_FUNCT3 = 0b001
HINT_STOREW_IMM = 0
HINT_BUFFER_IMM = 1


def _sx(value: int, bits: int) -> int:
    """Sign-extend `bits`-wide value to python int."""
    if value & (1 << (bits - 1)):
        return value - (1 << bits)
    return value


@dataclass
class Decoded:
    rd: int
    rs1: int
    rs2: int
    funct3: int
    funct7: int
    imm_i: int  # sign-extended 12-bit
    imm_s: int
    imm_b: int
    imm_u: int  # raw upper 20 bits << 12 (unsigned as encoded)
    imm_j: int
    shamt: int


def decode(word: int) -> Decoded:
    rd = (word >> 7) & 0x1F
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    funct3 = (word >> 12) & 0x7
    funct7 = (word >> 25) & 0x7F
    imm_i = _sx(word >> 20, 12)
    imm_s = _sx(((word >> 25) << 5) | ((word >> 7) & 0x1F), 12)
    imm_b = _sx((((word >> 31) & 1) << 12) | (((word >> 7) & 1) << 11)
                | (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1),
                13)
    imm_u = _sx(word & 0xFFFFF000, 32)
    imm_j = _sx((((word >> 31) & 1) << 20) | (((word >> 12) & 0xFF) << 12)
                | (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1),
                21)
    shamt = (word >> 20) & 0x1F
    return Decoded(rd, rs1, rs2, funct3, funct7, imm_i, imm_s, imm_b, imm_u,
                   imm_j, shamt)


def _i12_to_u24(imm: int) -> int:
    return imm & 0xFFFFFF


def from_r_type(opcode, e_as, d: Decoded, allow_rd_zero=False) -> Instruction:
    if not allow_rd_zero and d.rd == 0:
        return nop()
    return Instruction(opcode, a=4 * d.rd, b=4 * d.rs1, c=4 * d.rs2, d=1,
                       e=e_as)


def from_i_type(opcode, d: Decoded) -> Instruction:
    if d.rd == 0:
        return nop()
    return Instruction(opcode, a=4 * d.rd, b=4 * d.rs1,
                       c=_i12_to_u24(d.imm_i), d=1, e=0)


def from_i_type_shamt(opcode, d: Decoded) -> Instruction:
    if d.rd == 0:
        return nop()
    return Instruction(opcode, a=4 * d.rd, b=4 * d.rs1, c=d.shamt, d=1, e=0)


def from_load(opcode, d: Decoded) -> Instruction:
    return Instruction(opcode, a=4 * d.rd, b=4 * d.rs1,
                       c=d.imm_i & 0xFFFF, d=1, e=2,
                       f=int(d.rd != 0), g=int(d.imm_i < 0))


def from_s_type(opcode, d: Decoded) -> Instruction:
    return Instruction(opcode, a=4 * d.rs2, b=4 * d.rs1,
                       c=d.imm_s & 0xFFFF, d=1, e=2, f=1,
                       g=int(d.imm_s < 0))


def from_b_type(opcode, d: Decoded) -> Instruction:
    return Instruction(opcode, a=4 * d.rs1, b=4 * d.rs2, c=d.imm_b % P,
                       d=1, e=1)


def from_j_type(opcode, d: Decoded) -> Instruction:
    return Instruction(opcode, a=4 * d.rd, b=0, c=d.imm_j % P, d=1, e=0,
                       f=int(d.rd != 0), g=0)


class Rv32ITranspilerExtension:
    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        opcode = w & 0x7F
        d = decode(w)
        f3 = d.funct3

        if opcode == OP_SYSTEM_RV:
            if f3 == CSRRW_FUNCT3 and d.rs1 == 0 and d.rd == 0:
                return one(nop())
            return one(unimp())
        if opcode == OP_CUSTOM0:
            if f3 == TERMINATE_FUNCT3:
                return one(Instruction(SystemOpcode.TERMINATE,
                                       c=d.imm_i & 0xFF))
            if f3 == PHANTOM_FUNCT3:
                imm = d.imm_i & 0xFFFF
                if imm == 0x0:  # HintInput
                    return one(phantom(Rv32Phantom.HINT_INPUT))
                if imm == 0x1:  # PrintStr
                    return one(phantom(Rv32Phantom.PRINT_STR, a=4 * d.rd,
                                       b=4 * d.rs1))
                if imm == 0x2:  # HintRandom
                    return one(phantom(Rv32Phantom.HINT_RANDOM, a=4 * d.rd))
                if imm == 0x3:  # HintLoadByKey
                    return one(phantom(Rv32Phantom.HINT_LOAD_BY_KEY,
                                       a=4 * d.rd, b=4 * d.rs1))
                if imm == 0x10:  # CtStart (cycle tracker; rd = span id)
                    return one(phantom(SysPhantom.CT_START, c_upper=d.rd))
                if imm == 0x11:  # CtEnd
                    return one(phantom(SysPhantom.CT_END))
                return None
            return None
        if opcode == OP_ALU:
            if d.funct7 == RV32M_FUNCT7:
                return None  # rv32m extension handles
            table = {
                (0, 0x00): BaseAluOpcode.ADD, (0, 0x20): BaseAluOpcode.SUB,
                (4, 0x00): BaseAluOpcode.XOR, (6, 0x00): BaseAluOpcode.OR,
                (7, 0x00): BaseAluOpcode.AND,
                (1, 0x00): ShiftOpcode.SLL, (5, 0x00): ShiftOpcode.SRL,
                (5, 0x20): ShiftOpcode.SRA,
                (2, 0x00): LessThanOpcode.SLT,
                (3, 0x00): LessThanOpcode.SLTU,
            }
            op = table.get((f3, d.funct7))
            if op is None:
                return None
            return one(from_r_type(op, 1, d))
        if opcode == OP_IMM:
            if f3 == 0:
                return one(from_i_type(BaseAluOpcode.ADD, d))
            if f3 == 4:
                return one(from_i_type(BaseAluOpcode.XOR, d))
            if f3 == 6:
                return one(from_i_type(BaseAluOpcode.OR, d))
            if f3 == 7:
                return one(from_i_type(BaseAluOpcode.AND, d))
            if f3 == 2:
                return one(from_i_type(LessThanOpcode.SLT, d))
            if f3 == 3:
                return one(from_i_type(LessThanOpcode.SLTU, d))
            if f3 == 1 and d.funct7 == 0x00:
                return one(from_i_type_shamt(ShiftOpcode.SLL, d))
            if f3 == 5 and d.funct7 == 0x00:
                return one(from_i_type_shamt(ShiftOpcode.SRL, d))
            if f3 == 5 and d.funct7 == 0x20:
                return one(from_i_type_shamt(ShiftOpcode.SRA, d))
            return None
        if opcode == OP_LOAD:
            table = {0: Rv32LoadStoreOpcode.LOADB, 1: Rv32LoadStoreOpcode.LOADH,
                     2: Rv32LoadStoreOpcode.LOADW,
                     4: Rv32LoadStoreOpcode.LOADBU,
                     5: Rv32LoadStoreOpcode.LOADHU}
            if f3 not in table:
                return None
            return one(from_load(table[f3], d))
        if opcode == OP_STORE:
            table = {0: Rv32LoadStoreOpcode.STOREB,
                     1: Rv32LoadStoreOpcode.STOREH,
                     2: Rv32LoadStoreOpcode.STOREW}
            if f3 not in table:
                return None
            return one(from_s_type(table[f3], d))
        if opcode == OP_BRANCH:
            table = {0: BranchEqualOpcode.BEQ, 1: BranchEqualOpcode.BNE,
                     4: BranchLessThanOpcode.BLT, 5: BranchLessThanOpcode.BGE,
                     6: BranchLessThanOpcode.BLTU,
                     7: BranchLessThanOpcode.BGEU}
            if f3 not in table:
                return None
            return one(from_b_type(table[f3], d))
        if opcode == OP_JAL:
            return one(from_j_type(Rv32JalLuiOpcode.JAL, d))
        if opcode == OP_JALR:
            return one(Instruction(Rv32JalrOpcode.JALR, a=4 * d.rd,
                                   b=4 * d.rs1, c=d.imm_i & 0xFFFF, d=1, e=0,
                                   f=int(d.rd != 0), g=int(d.imm_i < 0)))
        if opcode == OP_LUI:
            if d.rd == 0:
                return one(nop())
            return one(Instruction(Rv32JalLuiOpcode.LUI, a=4 * d.rd, b=0,
                                   c=((d.imm_u & 0xFFFFFFFF) >> 12) & 0xFFFFF,
                                   d=1, e=0, f=1, g=0))
        if opcode == OP_AUIPC:
            if d.rd == 0:
                return one(nop())
            return one(Instruction(Rv32AuipcOpcode.AUIPC, a=4 * d.rd, b=0,
                                   c=((d.imm_u & 0xFFFFF000) & 0xFFFFFFFF)
                                   >> 8, d=1, e=0))
        if opcode == OP_FENCE:
            return one(nop())
        return None


class Rv32MTranspilerExtension:
    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_ALU:
            return None
        d = decode(w)
        if d.funct7 != RV32M_FUNCT7:
            return None
        table = {0: MulOpcode.MUL, 1: MulHOpcode.MULH, 2: MulHOpcode.MULHSU,
                 3: MulHOpcode.MULHU, 4: DivRemOpcode.DIV,
                 5: DivRemOpcode.DIVU, 6: DivRemOpcode.REM,
                 7: DivRemOpcode.REMU}
        return one(from_r_type(table[d.funct3], 0, d))


class Rv32IoTranspilerExtension:
    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM0:
            return None
        d = decode(w)
        if d.funct3 == HINT_FUNCT3:
            imm = d.imm_i & 0xFFFF
            if imm == HINT_STOREW_IMM:
                return one(Instruction(Rv32HintStoreOpcode.HINT_STOREW,
                                       a=0, b=4 * d.rd, c=0, d=1, e=2))
            if imm == HINT_BUFFER_IMM:
                return one(Instruction(Rv32HintStoreOpcode.HINT_BUFFER,
                                       a=4 * d.rs1, b=4 * d.rd, c=0, d=1,
                                       e=2))
            return None
        if d.funct3 == REVEAL_FUNCT3:
            imm = d.imm_i
            return one(Instruction(Rv32LoadStoreOpcode.STOREW,
                                   a=4 * d.rs1, b=4 * d.rd,
                                   c=imm & 0xFFFF, d=1, e=3, f=1,
                                   g=int(imm < 0)))
        if d.funct3 == NATIVE_STOREW_FUNCT3:
            if d.funct7 != NATIVE_STOREW_FUNCT7:
                return None
            return one(Instruction(Rv32LoadStoreOpcode.STOREW,
                                   a=4 * d.rs1, b=4 * d.rd, c=0, d=1, e=4,
                                   f=1, g=0))
        return None


KECCAK_SHA_FUNCT3 = 0b100


class Keccak256TranspilerExtension:
    """keccak256 intrinsic on custom-0 funct3=0b100 funct7=0 (reference
    extensions/keccak256/transpiler/src/lib.rs + guest/src/lib.rs)."""

    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM0:
            return None
        d = decode(w)
        if d.funct3 != KECCAK_SHA_FUNCT3:
            return None
        if d.funct7 == 0:
            opc = Rv32KeccakOpcode.KECCAK256
        elif d.funct7 == 1:
            opc = Rv32Sha256Opcode.SHA256
        else:
            return None
        return one(Instruction(opc, a=4 * d.rd, b=4 * d.rs1,
                               c=4 * d.rs2, d=1, e=2))


INT256_FUNCT3 = 0b101
BEQ256_FUNCT3 = 0b110

# funct7 -> global opcode (reference Int256Funct7,
# extensions/bigint/guest/src/lib.rs:13 + transpiler/src/lib.rs:98-140)
_INT256_FUNCT7 = {
    0: BaseAlu256Opcode.ADD, 1: BaseAlu256Opcode.SUB,
    2: BaseAlu256Opcode.XOR, 3: BaseAlu256Opcode.OR,
    4: BaseAlu256Opcode.AND, 5: Shift256Opcode.SLL,
    6: Shift256Opcode.SRL, 7: Shift256Opcode.SRA,
    8: LessThan256Opcode.SLT, 9: LessThan256Opcode.SLTU,
    10: Mul256Opcode.MUL,
}


class Int256TranspilerExtension:
    """256-bit integer intrinsics (reference Int256TranspilerExtension)."""

    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM0:
            return None
        d = decode(w)
        if d.funct3 == INT256_FUNCT3:
            op = _INT256_FUNCT7.get(d.funct7)
            if op is None:
                return None
            return one(Instruction(op, a=4 * d.rd, b=4 * d.rs1,
                                   c=4 * d.rs2, d=1, e=2))
        if d.funct3 == BEQ256_FUNCT3:
            return one(Instruction(BranchEqual256Opcode.BEQ, a=4 * d.rs1,
                                   b=4 * d.rs2, c=d.imm_b % P, d=1, e=2))
        return None


OP_CUSTOM1 = 0x2B
MODULAR_ARITHMETIC_FUNCT3 = 0b000

# base funct7 (mod 8) -> local opcode offset within the modulus block
# (reference ModArithBaseFunct7 {AddMod, SubMod, MulMod, DivMod, IsEqMod,
# SetupMod, HintNonQr, HintSqrt} -> Rv32ModularArithmeticOpcode order,
# extensions/algebra/transpiler/src/lib.rs:131-154)
_MOD_BASE_TO_LOCAL = {0: 0, 1: 1, 2: 3, 3: 4, 4: 6}
_MOD_SETUP = 5


class ModularTranspilerExtension:
    """Modular-arithmetic intrinsics on custom-1 (reference
    ModularTranspilerExtension).  SETUP_* lowers to a no-op: the modulus
    is a keygen-time constant in this framework, so runtime setup rows
    carry no information the verifying key doesn't already pin."""

    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM1:
            return None
        d = decode(w)
        if d.funct3 != MODULAR_ARITHMETIC_FUNCT3:
            return None
        base = d.funct7 % 8
        mod_idx = d.funct7 // 8
        if base == _MOD_SETUP:  # setup -> nop (modulus is a vk constant)
            return one(nop())
        if base in (6, 7):  # HintNonQr / HintSqrt -> phantom sub-executor
            # (reference algebra/transpiler/src/lib.rs:111-130: phantom
            # with ModularPhantom disc, a = 4*rs1 for sqrt, c_upper =
            # mod_idx; the hint fills the stream, guest verifies)
            disc = 0x50 if base == 6 else 0x51
            return one(Instruction(SystemOpcode.PHANTOM,
                                   a=4 * d.rs1 if base == 7 else 0,
                                   b=0, c=disc | (mod_idx << 16)))
        local = _MOD_BASE_TO_LOCAL.get(base)
        if local is None:
            return None
        if d.rd == 0 and base != 4:
            return one(nop())
        return one(Instruction(0x500 + mod_idx * 8 + local, a=4 * d.rd,
                               b=4 * d.rs1, c=4 * d.rs2, d=1, e=2))


SW_FUNCT3 = 0b001
COMPLEX_EXT_FIELD_FUNCT3 = 0b010

# Fp2 base funct7 -> local opcode offset (reference
# ComplexExtFieldBaseFunct7 {Add, Sub, Mul, Div, Setup} -> Fp2Opcode order)
_FP2_BASE_TO_LOCAL = {0: 0, 1: 1, 2: 3, 3: 4}


class Fp2TranspilerExtension:
    """Complex-extension-field intrinsics on custom-1 funct3=010
    (reference Fp2TranspilerExtension)."""

    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM1:
            return None
        d = decode(w)
        if d.funct3 != COMPLEX_EXT_FIELD_FUNCT3:
            return None
        base = d.funct7 % 8
        fp2_idx = d.funct7 // 8
        if base == 4:  # setup -> nop
            return one(nop())
        local = _FP2_BASE_TO_LOCAL.get(base)
        if local is None:
            return None
        if d.rd == 0:
            return one(nop())
        return one(Instruction(0x710 + fp2_idx * 6 + local, a=4 * d.rd,
                               b=4 * d.rs1, c=4 * d.rs2, d=1, e=2))



class EccTranspilerExtension:
    """Short-Weierstrass intrinsics on custom-1 funct3=001 (reference
    EccTranspilerExtension, extensions/ecc/transpiler/src/lib.rs:14-80).
    funct7 = curve_idx*8 + {SwAddNe=0, SwDouble=1, SwSetup=2}."""

    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM1:
            return None
        d = decode(w)
        if d.funct3 != SW_FUNCT3:
            return None
        base = d.funct7 % 8
        curve_idx = d.funct7 // 8
        if base == 0:  # EC_ADD_NE
            return one(Instruction(0x600 + curve_idx * 4, a=4 * d.rd,
                                   b=4 * d.rs1, c=4 * d.rs2, d=1, e=2))
        if base == 1:  # EC_DOUBLE (rs2 unused)
            return one(Instruction(0x600 + curve_idx * 4 + 2, a=4 * d.rd,
                                   b=4 * d.rs1, c=0, d=1, e=2))
        if base == 2:  # setup -> no-op (curve constants live in the vk)
            return one(nop())
        return None


PAIRING_FUNCT3 = 0b011


class PairingTranspilerExtension:
    """Pairing phantom on custom-1 funct3=011 (reference
    extensions/pairing/transpiler/src/lib.rs:23-55):
    funct7 = pairing_idx * 16 + HintFinalExp(=0)."""

    def process_custom(self, stream):
        if not stream:
            return None
        w = stream[0]
        if (w & 0x7F) != OP_CUSTOM1:
            return None
        d = decode(w)
        if d.funct3 != PAIRING_FUNCT3:
            return None
        base = d.funct7 % 16
        pairing_idx = d.funct7 // 16
        if base != 0:  # only HintFinalExp exists
            return None
        return one(phantom(PairingPhantom.HINT_FINAL_EXP, a=4 * d.rs1,
                           b=4 * d.rs2, c_upper=pairing_idx))


@dataclass
class TranspilerOutput:
    instructions: list
    used_u32s: int


def one(insn: Instruction) -> TranspilerOutput:
    return TranspilerOutput([insn], 1)


class Transpiler:
    """Ordered list of extension processors (reference transpiler.rs:12-60).

    Panics on ambiguity (two extensions claiming the same word).
    """

    def __init__(self, extensions=None):
        self.extensions = extensions or [Rv32ITranspilerExtension(),
                                         Rv32MTranspilerExtension(),
                                         Rv32IoTranspilerExtension(),
                                         Int256TranspilerExtension(),
                                         ModularTranspilerExtension(),
                                         EccTranspilerExtension(),
                                         Fp2TranspilerExtension(),
                                         Keccak256TranspilerExtension(),
                                         PairingTranspilerExtension()]

    def transpile(self, words: list) -> list:
        out: list = []
        i = 0
        while i < len(words):
            # every extension here reads one word, so each is shown that
            # word alone: the JAX package's words[i:] copies the rest of
            # the program for every word
            stream = words[i:i + 1]
            results = [ext.process_custom(stream) for ext in self.extensions]
            hits = [r for r in results if r is not None]
            if len(hits) > 1:
                raise ValueError(
                    f"ambiguous transpilation at word {i}: {words[i]:#010x}")
            if not hits:
                # unknown instruction: trap at runtime
                out.append(unimp())
                i += 1
                continue
            out.extend(hits[0].instructions)
            i += hits[0].used_u32s
        return out


def transpile_elf(elf: Elf, extensions=None) -> VmExe:
    program = Program(instructions=Transpiler(extensions)
                      .transpile(elf.instructions), pc_base=elf.pc_base)
    return VmExe(program=program, pc_start=elf.pc_start,
                 init_memory=memory_image_to_init_memory(elf.memory_image))
