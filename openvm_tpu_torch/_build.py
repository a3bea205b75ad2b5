"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

The sources are compiled for ``sm_90a`` at first use, one nvcc process per
source started together, and linked into one shared library with a plain C
interface under ``build/openvm_tpu_torch/<hash of sources and flags>/`` at
the root of the checkout.  Importing this module builds nothing.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0 and counts the
launch in ``LAUNCHES``, so a run can show which kernels it went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ._device import require_cuda

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("babybear.cu", "ntt.cu", "poseidon2.cu", "ext.cu", "gather.cu",
           "quotient.cu", "open.cu", "fri.cu", "logup.cu", "lookup.cu")
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "openvm_tpu_torch"
LIB_NAME = "libopenvm_tpu_torch.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
CFLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset_launches(); each wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"bb_elementwise": 0, "ntt": 0, "poseidon2_hash_rows": 0,
            "poseidon2_compress_layer": 0, "poseidon2_compress_tail": 0,
            "ext_elementwise": 0, "ext_powers": 0, "gather": 0,
            "quotient": 0, "open_dot": 0, "fri_reduced_open": 0,
            "fri_fold": 0, "quotient_columns": 0, "perm_cols": 0,
            "perm_scan": 0, "lookup_hist": 0}

_V, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
_SIGNATURES = {
    "ovt_bb_elementwise": (_I, _V, _V, _V, _LL, _V),
    "ovt_ntt_pass": (_V, _V, _V, _V, _V, _I, _U, _I, _I, _U, _I, _V),
    "ovt_p2_set_constants": (_V, _V, _V, _V),
    "ovt_poseidon2_hash_rows": (_V, _V, _U, _U, _V),
    "ovt_poseidon2_compress_layer": (_V, _V, _V, _U, _V),
    "ovt_poseidon2_compress_tail": (_V, _V, _V, _I, _U, _V),
    "ovt_ext_elementwise": (_I, _V, _V, _V, _LL, _I, _V),
    "ovt_ext_powers": (_U, _U, _U, _U, _V, _LL, _V),
    "ovt_gather": (_V, _V, _V, _I, _V, _LL, _V, _V),
    "ovt_quotient": (_V, _I, _V, _V, _V, _V, _I, _I, _I, _I, _V, _LL, _V),
    "ovt_open_partial": (_V, _I, _I, _V, _V, _V),
    "ovt_open_reduce": (_V, _I, _V, _LL, _V, _V),
    "ovt_fri_fold": (_V, _V, _V, _V, _LL, _I, _V, _V),
    "ovt_reduced_open": (_V, _I, _V, _V, _I, _V, _U, _I, _V, _V),
    "ovt_quotient_columns": (_V, _I, _V, _V, _V, _V, _I, _I, _I, _I, _V, _LL, _V),
    "ovt_perm_cols": (_V, _I, _I, _V, _V, _V, _V, _I, _I, _I, _V),
    "ovt_perm_scan": (_V, _LL, _I, _V, _V, _V),
    "ovt_lookup_hist": (_V, _I, _I, _I, _V, _V, _U, _V, _V, _U, _U, _V),
}

_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for f in sorted(p for p in CSRC.iterdir() if p.is_file()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the kernels unless this source hash is built."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir))
    try:
        procs = [(src, subprocess.Popen(
            [nvcc, *ARCH, *CFLAGS, "-c", str(CSRC / src), "-o",
             str(tmp / (src + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in SOURCES]
        log, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== nvcc {src}\n{out}")
            if proc.returncode:
                failed.append(src)
        if not failed:
            link = subprocess.run(
                [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                 *(str(tmp / (s + ".o")) for s in SOURCES)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            log.append(f"== link\n{link.stdout}")
            if link.returncode:
                failed.append("link")
        (out_dir / "build.log").write_text("".join(log))
        if failed:
            raise RuntimeError(f"CUDA build failed at {failed}:\n" + "".join(log))
        os.replace(tmp / LIB_NAME, lib_path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _LIB
    if _LIB is None:
        require_cuda()
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.ovt_error_string.argtypes = (ctypes.c_int,)
        handle.ovt_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def call(fn_name: str, device: torch.device, *args) -> None:
    """Run one C entry on ``device``'s current stream; raise on its error."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(handle, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} "
                           f"({handle.ovt_error_string(rc).decode()})")


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """``call`` a C entry that launches ``kernel``, and count the launch."""
    call(fn_name, device, *args)
    LAUNCHES[kernel] += 1


def check_words(t: torch.Tensor, name: str, device: torch.device) -> None:
    """A kernel operand: contiguous int32 Montgomery words on ``device``."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected torch.int32")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def upload(sections: list, device: torch.device) -> tuple:
    """numpy arrays laid end to end at 16-byte offsets in one pinned host
    buffer and sent to ``device`` in one non-blocking copy: (device uint8
    tensor, byte offset of each section).  The caller keeps the tensor
    until its launches are enqueued; PyTorch's caching allocator then holds
    the block for the stream's later work."""
    offs, size = [], 0
    for s in sections:
        offs.append(size)
        size += -(-s.nbytes // 16) * 16
    host = torch.empty(max(size, 16), dtype=torch.uint8, pin_memory=True)
    host_np = host.numpy()
    for s, o in zip(sections, offs):
        host_np[o:o + s.nbytes] = np.ascontiguousarray(s).view(np.uint8).ravel()
    return host.to(device, non_blocking=True), offs


def kernel_device(*tensors: torch.Tensor) -> torch.device:
    """The one device all operands share; CPU or CUDA, nothing else."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"operands on {dev} and {t.device}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev
