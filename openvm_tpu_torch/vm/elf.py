"""Minimal ELF32 loader for RISC-V guest programs.

Copy of openvm_tpu/vm/elf.py (the whole module).

Re-implements the loading semantics of reference
crates/toolchain/transpiler/src/elf.rs:63-230: read PT_LOAD segments into a
word-granular memory image; executable segments also contribute the
instruction stream (base = lowest executable vaddr); entrypoint must be
word-aligned.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

WORD_SIZE = 4
MAX_MEM = 1 << 29  # pointer_max_bits (reference MemoryConfig)
MAX_ALLOWED_PC = (1 << 30) - 1

PT_LOAD = 1
PF_X = 1


@dataclass
class Elf:
    instructions: list  # u32 words of the executable segments
    pc_start: int
    pc_base: int
    memory_image: dict  # word address -> u32 (includes text)
    fn_bounds: dict = field(default_factory=dict)


def load_elf(data: bytes) -> Elf:
    if data[:4] != b"\x7fELF":
        raise ValueError("not an ELF file")
    ei_class, ei_data = data[4], data[5]
    if ei_class != 1 or ei_data != 1:
        raise ValueError("expected ELF32 little-endian")
    (e_type, e_machine, _e_version, e_entry, e_phoff, _e_shoff, _e_flags,
     _e_ehsize, e_phentsize, e_phnum) = struct.unpack_from("<HHIIIIIHHH",
                                                           data, 16)
    if e_machine != 0xF3:  # EM_RISCV
        raise ValueError("not a RISC-V ELF")
    if e_entry >= MAX_MEM or e_entry % WORD_SIZE != 0:
        raise ValueError("invalid entrypoint")
    if e_phnum > 256:
        raise ValueError("too many program headers")

    image: dict[int, int] = {}
    instructions: list[int] = []
    base_address = 0xFFFFFFFF

    for i in range(e_phnum):
        off = e_phoff + i * e_phentsize
        (p_type, p_offset, p_vaddr, _p_paddr, p_filesz, p_memsz, p_flags,
         _p_align) = struct.unpack_from("<IIIIIIII", data, off)
        if p_type != PT_LOAD:
            continue
        if p_filesz >= MAX_MEM or p_memsz >= MAX_MEM:
            raise ValueError("invalid segment size")
        if p_vaddr % WORD_SIZE != 0:
            raise ValueError(f"vaddr {p_vaddr:#x} unaligned")
        executable = (p_flags & PF_X) != 0
        if executable and p_vaddr < base_address:
            base_address = p_vaddr
        for j in range(0, p_memsz, WORD_SIZE):
            addr = p_vaddr + j
            if addr >= MAX_MEM:
                raise ValueError(f"address {addr:#x} exceeds max memory")
            if executable and addr > MAX_ALLOWED_PC:
                raise ValueError(f"pc {addr:#x} exceeds max pc")
            if j >= p_filesz:
                image[addr] = 0
                continue
            n = min(p_filesz - j, WORD_SIZE)
            word = int.from_bytes(data[p_offset + j:p_offset + j + n],
                                  "little")
            image[addr] = word
            if executable:
                instructions.append(word)

    return Elf(instructions=instructions, pc_start=e_entry,
               pc_base=base_address, memory_image=image)


def memory_image_to_init_memory(memory_image: dict) -> dict:
    """(word addr -> u32) to ((as=2, byte addr) -> byte), reference
    transpiler util elf_memory_image_to_openvm_memory_image."""
    out = {}
    for addr, word in memory_image.items():
        for i, byte in enumerate(word.to_bytes(4, "little")):
            out[(2, addr + i)] = byte
    return out
