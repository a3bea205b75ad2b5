"""VM instruction set: opcodes, Instruction, Program, VmExe.

Copy of openvm_tpu/vm/instructions.py (the whole module).

Opcode numbering matches the reference exactly so that transpiled programs
are interchangeable:
  * system: reference crates/toolchain/instructions/src/lib.rs:76-93
    (TERMINATE=0, PHANTOM=1, PUBLISH=0x020)
  * rv32im: reference extensions/rv32im/transpiler/src/instructions.rs
    (BaseAlu@0x200, Shift@0x205, LessThan@0x208, LoadStore@0x210,
     BranchEq@0x220, BranchLt@0x225, JalLui@0x230, Jalr@0x235, Auipc@0x240,
     Mul@0x250, MulH@0x251, DivRem@0x254, HintStore@0x260)
Instruction operands a..g mirror reference
crates/toolchain/instructions/src/instruction.rs:8-13.
"""

from __future__ import annotations

from dataclasses import dataclass, field

P = 2013265921

DEFAULT_PC_STEP = 4
PC_BITS = 30
MAX_ALLOWED_PC = (1 << PC_BITS) - 1

# address spaces (reference riscv.rs:5-9, NATIVE_AS lib.rs:21)
RV32_IMM_AS = 0
RV32_REGISTER_AS = 1
RV32_MEMORY_AS = 2
PUBLIC_VALUES_AS = 3
NATIVE_AS = 4

RV32_REGISTER_NUM_LIMBS = 4
RV32_CELL_BITS = 8
RV32_NUM_REGISTERS = 32


class SystemOpcode:
    TERMINATE = 0
    PHANTOM = 1


class PublishOpcode:
    PUBLISH = 0x020


class BaseAluOpcode:
    ADD = 0x200
    SUB = 0x201
    XOR = 0x202
    OR = 0x203
    AND = 0x204


class ShiftOpcode:
    SLL = 0x205
    SRL = 0x206
    SRA = 0x207


class LessThanOpcode:
    SLT = 0x208
    SLTU = 0x209


class Rv32LoadStoreOpcode:
    LOADW = 0x210
    LOADBU = 0x211
    LOADHU = 0x212
    STOREW = 0x213
    STOREH = 0x214
    STOREB = 0x215
    # loads requiring sign extension (separate chip in the reference)
    LOADB = 0x216
    LOADH = 0x217


class BranchEqualOpcode:
    BEQ = 0x220
    BNE = 0x221


class BranchLessThanOpcode:
    BLT = 0x225
    BLTU = 0x226
    BGE = 0x227
    BGEU = 0x228


class Rv32JalLuiOpcode:
    JAL = 0x230
    LUI = 0x231


class Rv32JalrOpcode:
    JALR = 0x235


class Rv32AuipcOpcode:
    AUIPC = 0x240


class MulOpcode:
    MUL = 0x250


class MulHOpcode:
    MULH = 0x251
    MULHSU = 0x252
    MULHU = 0x253


class DivRemOpcode:
    DIV = 0x254
    DIVU = 0x255
    REM = 0x256
    REMU = 0x257


class Rv32HintStoreOpcode:
    HINT_STOREW = 0x260
    HINT_BUFFER = 0x261


class Rv32KeccakOpcode:
    """keccak256 intrinsic (reference Rv32KeccakOpcode, offset 0x310)."""
    KECCAK256 = 0x310


class Rv32Sha256Opcode:
    """sha256 intrinsic (reference Rv32Sha256Opcode, offset 0x320)."""
    SHA256 = 0x320


class BaseAlu256Opcode:
    """256-bit ALU (reference Rv32BaseAlu256Opcode, opcode_offset 0x400)."""
    ADD = 0x400
    SUB = 0x401
    XOR = 0x402
    OR = 0x403
    AND = 0x404


class Shift256Opcode:
    SLL = 0x405
    SRL = 0x406
    SRA = 0x407


class LessThan256Opcode:
    SLT = 0x408
    SLTU = 0x409


class BranchEqual256Opcode:
    BEQ = 0x420
    BNE = 0x421


class BranchLessThan256Opcode:
    BLT = 0x425
    BLTU = 0x426
    BGE = 0x427
    BGEU = 0x428


class Mul256Opcode:
    MUL = 0x450


class NativeLoadStoreOpcode:
    """Native (AS4) single-cell load/store (reference
    extensions/native/compiler/src/lib.rs:43-51, offset 0x100)."""
    LOADW = 0x100
    STOREW = 0x101
    HINT_STOREW = 0x102


class NativeLoadStore4Opcode:
    """Block-4 variants (reference lib.rs:54-63, offset 0x108)."""
    LOADW4 = 0x108
    STOREW4 = 0x109
    HINT_STOREW4 = 0x10A


class NativeBranchEqOpcode:
    """Felt equality branches (reference lib.rs:66-73, offset 0x110)."""
    BEQ = 0x110
    BNE = 0x111


class NativeJalOpcode:
    JAL = 0x115


class NativeRangeCheckOpcode:
    RANGE_CHECK = 0x120


class CastfOpcode:
    CASTF = 0x125


class FieldArithmeticOpcode:
    """Native felt arithmetic (reference lib.rs:118-126, offset 0x130)."""
    ADD = 0x130
    SUB = 0x131
    MUL = 0x132
    DIV = 0x133


class FieldExtensionOpcode:
    """Degree-4 extension arithmetic on 4-blocks (reference
    lib.rs:142-146, offset 0x140)."""
    FE4ADD = 0x140
    FE4SUB = 0x141
    BBE4MUL = 0x142
    BBE4DIV = 0x143


class Poseidon2Opcode:
    """Native poseidon2 (reference lib.rs:181-186, offset 0x150)."""
    PERM_POS2 = 0x150
    COMP_POS2 = 0x151


class FriOpcode:
    FRI_REDUCED_OPENING = 0x160


class VerifyBatchOpcode:
    VERIFY_BATCH = 0x170


class NativePhantom:
    """Reference lib.rs:149-161 (NativePhantom discriminants)."""
    PRINT = 0x10
    HINT_INPUT = 0x11
    HINT_BITS = 0x12
    HINT_LOAD = 0x13
    HINT_FELT = 0x14


class SysPhantom:
    NOP = 0
    DEBUG_PANIC = 1
    CT_START = 2
    CT_END = 3


class Rv32Phantom:
    HINT_INPUT = 0x20
    PRINT_STR = 0x21
    HINT_RANDOM = 0x22
    HINT_LOAD_BY_KEY = 0x23


class ModularPhantom:
    """Algebra extension phantoms (reference
    extensions/algebra/transpiler/src/lib.rs:34-37): hint-stream fills
    for quadratic non-residues and square roots (curve decompression);
    c_upper carries the modulus index."""
    HINT_NON_QR = 0x50
    HINT_SQRT = 0x51


class PairingPhantom:
    """Pairing extension phantom (reference
    extensions/pairing/transpiler/src/lib.rs:13-18): resets the hint
    stream to final_exp_hint(multi_miller_loop(P, Q)) = (c, u)."""
    HINT_FINAL_EXP = 0x30


@dataclass
class Instruction:
    """7-operand VM instruction over BabyBear (values canonical ints)."""

    opcode: int
    a: int = 0
    b: int = 0
    c: int = 0
    d: int = 0
    e: int = 0
    f: int = 0
    g: int = 0

    def operands(self):
        return (self.a, self.b, self.c, self.d, self.e, self.f, self.g)


def phantom(discriminant: int, a: int = 0, b: int = 0, c_upper: int = 0
            ) -> Instruction:
    """Phantom instruction: c = (c_upper << 16) | discriminant."""
    return Instruction(SystemOpcode.PHANTOM, a=a, b=b,
                       c=((c_upper << 16) | discriminant) % P)


def nop() -> Instruction:
    return Instruction(SystemOpcode.PHANTOM)


def unimp() -> Instruction:
    """Terminate with exit code 2 (trap for unsupported instructions)."""
    return Instruction(SystemOpcode.TERMINATE, c=2)


def isize_to_field(v: int) -> int:
    return v % P


@dataclass
class Program:
    """Instruction list with pc indexing: pc = pc_base + 4*i."""

    instructions: list  # list[Instruction | None] (None = gap)
    pc_base: int = 0
    step: int = DEFAULT_PC_STEP
    # powdr-fork APC hook (reference instructions/src/program.rs:27)
    apc_by_pc_index: dict = field(default_factory=dict)

    def get(self, pc: int):
        idx = (pc - self.pc_base) // self.step
        if idx in self.apc_by_pc_index:
            return self.apc_by_pc_index[idx]
        if 0 <= idx < len(self.instructions):
            return self.instructions[idx]
        return None

    def __len__(self):
        return len(self.instructions)


@dataclass
class VmExe:
    """Executable: program + entry pc + initial memory image.

    init_memory maps (address_space, address) -> byte value, mirroring
    reference exe.rs SparseMemoryImage.
    """

    program: Program
    pc_start: int = 0
    init_memory: dict = field(default_factory=dict)
    fn_bounds: dict = field(default_factory=dict)
