"""What the preflight needs of the E1 interpreter's module.

Copy of openvm_tpu/vm/interpreter.py:56-117: ``ExecutionError``,
``Streams`` and the immediate and sign helpers.  The E1 interpreter itself
(``Interpreter``, ``VmState``) is not on the proving path and is not here.
"""

from __future__ import annotations

from dataclasses import dataclass, field

M32 = 0xFFFFFFFF


class ExecutionError(Exception):
    pass


@dataclass
class Streams:
    input_stream: list = field(default_factory=list)  # list of byte-lists
    hint_stream: list = field(default_factory=list)  # byte deque (list)
    kv_store: dict = field(default_factory=dict)


def _sx(v: int, bits: int) -> int:
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _s32(v: int) -> int:
    return _sx(v & M32, 32)


def _imm24(c: int) -> int:
    """ALU immediate: u24 encoding of i12, sign-extended from bit 23."""
    return _sx(c & 0xFFFFFF, 24) & M32


def _imm16(c: int, g: int) -> int:
    """Load/store/jalr immediate: low 16 bits + sign flag g."""
    v = c & 0xFFFF
    if g:
        v |= 0xFFFF0000
    return v
