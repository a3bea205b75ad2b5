"""Native-field eDSL: build recursion programs for the native VM.

Copy of openvm_tpu/native_compiler/__init__.py, with the challenger's and
the verifier program's names exported beside the Builder's.

TPU-native re-design of the reference native compiler
(reference extensions/native/compiler/src/ir/instructions.rs DslIr +
asm/compiler.rs AsmCompiler).  Instead of a typed IR lowered through an
assembly stage, the Python builder emits native `Instruction`s directly
with label fix-ups — recursion programs are generated per (vk, proof
shape) on the host, so the builder IS the compiler.
"""

from .builder import Builder, Felt, Ext, FeltArray  # noqa: F401
from .challenger import (ProgramChallenger, bits_le_canonical,  # noqa: F401
                         bits_to_index)
from .verifier_program import (build_internal_program,  # noqa: F401
                               build_leaf_program, build_root_program,
                               build_verifier_program, serialize_proof_felts,
                               static_height_profile)
