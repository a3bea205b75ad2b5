"""The native preflight core: ctypes bindings for csrc/host/preflight.cpp.

Copy of openvm_tpu/vm/native.py:125-442 (``NativeVmHandle``, its memory
shim and the record layouts) over the port's own copy of the JAX
package's csrc/preflight.cpp.  The shim makes the ctypes pointers of its
one-word scratch once, where the JAX package's makes six a word: the
extension handlers move most words through it (26 a 256-bit op).  ``g++`` builds it at first use into
``build/openvm_tpu_torch/host/<hash of the source and flags>/`` at the root of
the checkout; a failed build or load raises.  There is no fallback to the
Python loop: a caller that wants the Python loop says so
(``VirtualMachine.prove(..., native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from .instructions import VmExe
from .interpreter import ExecutionError

PF_CPP = Path(__file__).resolve().parent.parent / "csrc" / "host" / "preflight.cpp"
BUILD_ROOT = (Path(__file__).resolve().parent.parent.parent / "build"
              / "openvm_tpu_torch" / "host")
CXXFLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_pf_lib = None


def build_preflight_library() -> Path:
    """Compile the preflight core with g++ unless this source is built;
    raise with the compiler's output when it fails."""
    src = PF_CPP.read_bytes()
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode() + src).hexdigest()[:16]
    out_dir = BUILD_ROOT / digest
    so = out_dir / "libpreflight.so"
    if so.exists():
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXXFLAGS, str(PF_CPP), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"g++ failed to build {PF_CPP}:\n{proc.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


class _PfRunOut(ctypes.Structure):
    _fields_ = [("status", ctypes.c_int64), ("yield_op", ctypes.c_int64),
                ("pc", ctypes.c_uint32), ("ts", ctypes.c_uint64),
                ("instret", ctypes.c_uint64),
                ("n_touched", ctypes.c_int64),
                ("cpp_cells", ctypes.c_int64)]


# run statuses (csrc/host/preflight.cpp)
PF_YIELD = 1
PF_INSN_LIMIT = 5
PF_SEGMENT_FULL = 8
PF_MEM_ERROR = 9

# (chip name, width, field spec [(name, n_cols)...]) — must match
# csrc/host/preflight.cpp kWidths and row layouts exactly.  Order = Chip enum.
PREFLIGHT_LAYOUTS = [
    ("rv32_base_alu", 26, [("pc", 1), ("ts", 1), ("op_idx", 1),
                           ("is_imm", 1), ("a", 1), ("b", 1), ("c", 1),
                           ("rs1", 4), ("rs2", 4), ("rd", 4), ("p_ts1", 1),
                           ("p_ts2", 1), ("p_tsw", 1), ("prevw", 4)]),
    ("rv32_less_than", 22, [("pc", 1), ("ts", 1), ("op_idx", 1),
                            ("is_imm", 1), ("a", 1), ("b", 1), ("c", 1),
                            ("rs1", 4), ("rs2", 4), ("p_ts1", 1),
                            ("p_ts2", 1), ("p_tsw", 1), ("prevw", 4)]),
    ("rv32_shift", 26, [("pc", 1), ("ts", 1), ("op_idx", 1), ("is_imm", 1),
                        ("a", 1), ("b", 1), ("c", 1), ("rs1", 4),
                        ("rs2", 4), ("rd", 4), ("p_ts1", 1), ("p_ts2", 1),
                        ("p_tsw", 1), ("prevw", 4)]),
    ("rv32_mul", 25, [("pc", 1), ("ts", 1), ("op_idx", 1), ("a", 1),
                      ("b", 1), ("c", 1), ("rs1", 4), ("rs2", 4), ("rd", 4),
                      ("p_ts1", 1), ("p_ts2", 1), ("p_tsw", 1),
                      ("prevw", 4)]),
    ("rv32_div_rem", 29, [("pc", 1), ("ts", 1), ("op_idx", 1), ("a", 1),
                          ("b", 1), ("c", 1), ("rs1", 4), ("rs2", 4),
                          ("q", 4), ("r", 4), ("p_ts1", 1), ("p_ts2", 1),
                          ("p_tsw", 1), ("prevw", 4)]),
    ("rv32_branch_eq", 17, [("pc", 1), ("ts", 1), ("op_idx", 1), ("a", 1),
                            ("b", 1), ("imm", 1), ("rs1", 4), ("rs2", 4),
                            ("to_pc", 1), ("p_ts1", 1), ("p_ts2", 1)]),
    ("rv32_branch_lt", 17, [("pc", 1), ("ts", 1), ("op_idx", 1), ("a", 1),
                            ("b", 1), ("imm", 1), ("rs1", 4), ("rs2", 4),
                            ("to_pc", 1), ("p_ts1", 1), ("p_ts2", 1)]),
    ("rv32_jal_lui", 16, [("pc", 1), ("ts", 1), ("op_idx", 1), ("a", 1),
                          ("imm", 1), ("needs_write", 1), ("rd", 4),
                          ("to_pc", 1), ("p_tsw", 1), ("prevw", 4)]),
    ("rv32_jalr", 23, [("pc", 1), ("ts", 1), ("a", 1), ("b", 1), ("c", 1),
                       ("g", 1), ("needs_write", 1), ("rs1", 4), ("rd", 4),
                       ("to_pc", 1), ("lsb", 1), ("p_ts1", 1), ("p_tsw", 1),
                       ("prevw", 4)]),
    ("rv32_auipc", 13, [("pc", 1), ("ts", 1), ("a", 1), ("imm", 1),
                        ("rd", 4), ("p_tsw", 1), ("prevw", 4)]),
    ("rv32_load_store", 31, [("pc", 1), ("ts", 1), ("op_idx", 1), ("a", 1),
                             ("b", 1), ("c", 1), ("g", 1), ("e_as", 1),
                             ("needs_write", 1), ("rs1", 4),
                             ("word_addr", 1), ("s0", 1), ("s1", 1),
                             ("data2", 4), ("new3", 4), ("p_ts1", 1),
                             ("p_ts2", 1), ("p_tsw", 1), ("prevw", 4)]),
]

_I64P = ctypes.POINTER(ctypes.c_int64)
# the most words NativeMemShim.read_block and write_block move in a call
BLOCK_WORDS = 16


def load_preflight_library():
    global _pf_lib
    if _pf_lib is not None:
        return _pf_lib
    lib = ctypes.CDLL(str(build_preflight_library()))
    vp = ctypes.c_void_p
    lib.pf_vm_create.restype = vp
    lib.pf_vm_create.argtypes = [_I64P, ctypes.c_int64, ctypes.c_uint32,
                                 _I64P, _I64P, ctypes.c_int64, _I64P]
    lib.pf_vm_destroy.argtypes = [vp]
    lib.pf_vm_set_mode.argtypes = [vp, ctypes.c_int64]
    lib.pf_vm_set_limits.argtypes = [vp] + [ctypes.c_int64] * 5 \
        + [_I64P, _I64P, ctypes.c_int64, ctypes.c_int64]
    lib.pf_vm_run.restype = _PfRunOut
    lib.pf_vm_run.argtypes = [vp, ctypes.c_uint32, ctypes.c_uint64,
                              ctypes.c_uint64, ctypes.c_uint64,
                              ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64]
    lib.pf_vm_should_segment.restype = ctypes.c_int64
    lib.pf_vm_should_segment.argtypes = [vp, ctypes.c_uint64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64]
    lib.pf_vm_rec_count.restype = ctypes.c_int64
    lib.pf_vm_rec_count.argtypes = [vp, ctypes.c_int64]
    lib.pf_vm_rec_copy.argtypes = [vp, ctypes.c_int64, _I64P]
    lib.pf_vm_touched_count.restype = ctypes.c_int64
    lib.pf_vm_touched_count.argtypes = [vp]
    lib.pf_vm_touched_copy.argtypes = [vp, _I64P]
    lib.pf_vm_segment_reset.argtypes = [vp]
    lib.pf_vm_mem_error.restype = ctypes.c_int64
    lib.pf_vm_mem_error.argtypes = [vp]
    lib.pf_vm_read_words.argtypes = [vp, ctypes.c_int64, _I64P, _I64P,
                                     ctypes.c_int64, _I64P, _I64P]
    lib.pf_vm_write_words.argtypes = [vp, ctypes.c_int64, _I64P, _I64P,
                                      _I64P, ctypes.c_int64, _I64P, _I64P]
    lib.pf_vm_peek_word.restype = ctypes.c_int64
    lib.pf_vm_peek_word.argtypes = [vp, ctypes.c_int64, ctypes.c_int64]
    _pf_lib = lib
    return lib


def _p(arr):
    return arr.ctypes.data_as(_I64P)


class NativeMemShim:
    """PreflightMemory-compatible view over a NativeVmHandle: Python
    extension-opcode handlers read/write the same word memory the C++
    core uses, with identical touch/timestamp semantics."""

    def __init__(self, nvm: "NativeVmHandle"):
        self.nvm = nvm
        # one-word scratch and its ctypes pointers, made once: the handlers
        # of the extension opcodes read and write memory a word a call
        self._words = np.zeros(5, dtype=np.int64)  # wa, now, val, pts, prev
        self._ptrs = [ctypes.cast(self._words.ctypes.data + 8 * k, _I64P)
                      for k in range(5)]
        # a block's words in one call: (wa, now, val, pts, prev) rows
        self._block = np.zeros((5, BLOCK_WORDS), dtype=np.int64)
        self._block_ptrs = [ctypes.cast(self._block[k].ctypes.data, _I64P)
                            for k in range(5)]

    def read(self, a_s, wa, now_ts):
        w, (p_wa, p_now, p_val, p_pts, _) = self._words, self._ptrs
        w[0] = wa
        w[1] = now_ts
        self.nvm.lib.pf_vm_read_words(self.nvm.h, a_s, p_wa, p_now, 1, p_val, p_pts)
        self.nvm.check_mem_error()
        v = int(w[2])
        return [v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF,
                (v >> 24) & 0xFF], int(w[3])

    def write(self, a_s, wa, new_data, now_ts):
        w, (p_wa, p_now, p_val, p_pts, p_prev) = self._words, self._ptrs
        w[0] = wa
        w[1] = now_ts
        w[2] = (new_data[0] | (new_data[1] << 8)
                | (new_data[2] << 16) | (new_data[3] << 24))
        self.nvm.lib.pf_vm_write_words(self.nvm.h, a_s, p_wa, p_val, p_now, 1,
                                       p_prev, p_pts)
        self.nvm.check_mem_error()
        v = int(w[4])
        return [v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF,
                (v >> 24) & 0xFF], int(w[3])

    def read_block(self, a_s, wa, n, ts0):
        """``read`` of the n words from wa at timestamps ts0, ts0 + 1, ...
        in one call: (their 4n bytes, their previous timestamps)."""
        blk, (p_wa, p_now, p_val, p_pts, _) = self._block, self._block_ptrs
        blk[0, :n] = np.arange(wa, wa + n)
        blk[1, :n] = np.arange(ts0, ts0 + n)
        self.nvm.lib.pf_vm_read_words(self.nvm.h, a_s, p_wa, p_now, n, p_val, p_pts)
        self.nvm.check_mem_error()
        return (list(blk[2, :n].astype("<u4").tobytes()),
                blk[3, :n].tolist())

    def write_block(self, a_s, wa, data, ts0):
        """``write`` of len(data) / 4 words from wa at timestamps ts0,
        ts0 + 1, ... in one call: (the bytes they held, their previous
        timestamps)."""
        n = len(data) // 4
        blk, (p_wa, p_now, p_val, p_pts, p_prev) = self._block, self._block_ptrs
        blk[0, :n] = np.arange(wa, wa + n)
        blk[1, :n] = np.arange(ts0, ts0 + n)
        blk[2, :n] = np.frombuffer(bytes(data), dtype="<u4")
        self.nvm.lib.pf_vm_write_words(self.nvm.h, a_s, p_wa, p_val, p_now, n,
                                       p_prev, p_pts)
        self.nvm.check_mem_error()
        return (list(blk[4, :n].astype("<u4").tobytes()),
                blk[3, :n].tolist())

    def _get(self, key):
        # peek without bus access (used for partial-store current words)
        a_s, wa = key
        v = int(self.nvm.lib.pf_vm_peek_word(self.nvm.h, a_s, wa))
        self.nvm.check_mem_error()
        return [v & 0xFF, (v >> 8) & 0xFF, (v >> 16) & 0xFF,
                (v >> 24) & 0xFF, 0]

    def peek(self, a_s, wa):
        """Current word value without a timestamped access (PreflightMemory
        API parity; used by unaligned digest read-modify-write windows)."""
        return self._get((a_s, wa))[:4]


class NativeVmHandle:
    """Owns a csrc/host/preflight.cpp PfVm: program, word memory, RV32IM record
    vectors, touched order, per-pc exec counts.  One handle spans all
    continuation segments of an execution (memory persists across
    segment_reset; records/touched/exec counts are per-segment)."""

    # chips whose records the C++ core produces
    CPP_CHIPS = [name for name, _, _ in PREFLIGHT_LAYOUTS]

    def __init__(self, exe: VmExe):
        self.lib = load_preflight_library()
        self.exe = exe
        insns = exe.program.instructions
        n = max(len(insns), 1)
        self.ops = np.zeros((8, n), dtype=np.int64)
        self.ops[0, :] = -1
        for i, insn in enumerate(insns):
            if insn is None:
                continue
            self.ops[0, i] = insn.opcode
            self.ops[1:, i] = insn.operands()
        for idx, entry in getattr(exe.program, "apc_by_pc_index",
                                  {}).items():
            insn = entry[0] if isinstance(entry, tuple) else entry
            self.ops[0, idx] = insn.opcode
            self.ops[1:, idx] = insn.operands()
        img = {}
        for (a_s, addr), byte in exe.init_memory.items():
            if a_s == 2:
                w = img.setdefault(addr // 4, [0, 0, 0, 0])
                w[addr % 4] = byte
        self._image_words = np.asarray(sorted(img), dtype=np.int64)
        self._image_vals = np.asarray(
            [int.from_bytes(bytes(img[w]), "little") for w in sorted(img)],
            dtype=np.int64)
        self.exec_counts = np.zeros(n, dtype=np.int64)
        self.h = self.lib.pf_vm_create(
            _p(self.ops), n, exe.program.pc_base,
            _p(self._image_words), _p(self._image_vals),
            len(self._image_words), _p(self.exec_counts))
        self.count_only = False
        self.shim = NativeMemShim(self)

    def __del__(self):
        h = getattr(self, "h", None)
        if h:
            self.lib.pf_vm_destroy(h)
            self.h = None

    def check_mem_error(self):
        if self.lib.pf_vm_mem_error(self.h):
            raise ExecutionError("memory access out of bounds")

    def set_mode(self, count_only: bool):
        self.count_only = bool(count_only)
        self.lib.pf_vm_set_mode(self.h, 1 if count_only else 0)

    def set_limits(self, max_height=0, max_cells=0, max_interactions=0,
                   ts_delta=-1, check_insns=0, widths=None, inters=None,
                   touched_width=0, touched_inters=0):
        """Metered segmentation thresholds (reference segment_ctx.rs
        SegmentationLimits); widths/inters keyed by chip name."""
        w = np.zeros(len(PREFLIGHT_LAYOUTS), dtype=np.int64)
        iv = np.zeros(len(PREFLIGHT_LAYOUTS), dtype=np.int64)
        for k, (name, _, _) in enumerate(PREFLIGHT_LAYOUTS):
            w[k] = (widths or {}).get(name, 0)
            iv[k] = (inters or {}).get(name, 0)
        self.lib.pf_vm_set_limits(self.h, max_height, max_cells,
                                  max_interactions, ts_delta, check_insns,
                                  _p(w), _p(iv), touched_width,
                                  touched_inters)

    def run(self, pc, ts, instret, max_insns, py_cells=0, py_inters=0,
            py_max_height=0):
        return self.lib.pf_vm_run(self.h, pc, ts, instret, max_insns,
                                  py_cells, py_inters, py_max_height)

    def should_segment(self, ts, py_cells, py_inters, py_max_height):
        return bool(self.lib.pf_vm_should_segment(
            self.h, ts, py_cells, py_inters, py_max_height))

    def rec_counts(self):
        return {name: int(self.lib.pf_vm_rec_count(self.h, k))
                for k, (name, _, _) in enumerate(PREFLIGHT_LAYOUTS)}

    def drain_records(self):
        """C++ chip records as {chip: {col: np.uint64 array}}.  In
        count-only mode only a "pc" column of the right length is
        synthesized (height accounting, reference metered mode)."""
        records = {}
        for k, (name, width, fields) in enumerate(PREFLIGHT_LAYOUTS):
            cnt = int(self.lib.pf_vm_rec_count(self.h, k))
            if cnt == 0:
                continue
            if self.count_only:
                records[name] = {"pc": np.zeros(cnt, dtype=np.uint64)}
                continue
            buf = np.zeros((cnt, width), dtype=np.int64)
            self.lib.pf_vm_rec_copy(self.h, k, _p(buf))
            mat = buf.view(np.uint64)
            rec = {}
            col = 0
            for fname, ncols in fields:
                rec[fname] = (mat[:, col] if ncols == 1
                              else mat[:, col:col + ncols])
                col += ncols
            records[name] = rec
        return records

    def drain_touched(self):
        """(touched, init_words) dicts in the PreflightResult format."""
        nt = int(self.lib.pf_vm_touched_count(self.h))
        buf = np.zeros((max(nt, 1), 11), dtype=np.int64)
        if nt:
            self.lib.pf_vm_touched_copy(self.h, _p(buf))
        touched, init_words = {}, {}
        for row in buf[:nt]:
            key = (int(row[0]), int(row[1]))
            init_words[key] = [int(x) for x in row[2:6]]
            touched[key] = [int(x) for x in row[6:10]] + [int(row[10])]
        return touched, init_words

    def segment_reset(self):
        """Segment boundary: drop records/touched/exec counts, keep memory
        values (next segment continues from this memory)."""
        self.lib.pf_vm_segment_reset(self.h)
