"""The RV32IM VM on the card: instructions, ELF loading, transpiler,
preflight, the AIRs and ``VirtualMachine`` (keygen -> prove -> verify).

Entry point: ``openvm_tpu_torch.vm.machine.VirtualMachine``.  The copies of
the JAX package's host modules cite their source in their docstrings.
"""

from .elf import Elf, load_elf
from .instructions import DEFAULT_PC_STEP, Instruction, Program, VmExe
from .interpreter import ExecutionError, Streams
from .transpiler import Transpiler, transpile_elf

__all__ = [
    "DEFAULT_PC_STEP", "Elf", "ExecutionError", "Instruction", "Program",
    "Streams", "Transpiler", "VmExe", "load_elf", "transpile_elf",
]
