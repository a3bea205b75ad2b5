"""Native-field eDSL: build recursion programs for the native VM.

Copy of openvm_tpu/native_compiler/__init__.py; the challenger and the
verifier program (challenger.py, verifier_program.py) are not ported yet.

TPU-native re-design of the reference native compiler
(reference extensions/native/compiler/src/ir/instructions.rs DslIr +
asm/compiler.rs AsmCompiler).  Instead of a typed IR lowered through an
assembly stage, the Python builder emits native `Instruction`s directly
with label fix-ups — recursion programs are generated per (vk, proof
shape) on the host, so the builder IS the compiler.
"""

from .builder import Builder, Felt, Ext, FeltArray  # noqa: F401
