"""openvm_tpu_torch stands alone: no JAX, no openvm_tpu, no eager build,
no silent CPU fallback, and ctypes bindings that match the CUDA sources."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from openvm_tpu_torch import _build
from openvm_tpu_torch.field import babybear as bb

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "openvm_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    # openvm_tpu_torch starts with "openvm_tpu": compare whole dotted parts.
    head = name.split(".")[0]
    return head in ("jax", "jaxlib", "openvm_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import_in_source(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_importing_everything_loads_no_jax_and_builds_nothing():
    code = """
import importlib, pkgutil, sys
import openvm_tpu_torch
for m in pkgutil.walk_packages(openvm_tpu_torch.__path__, "openvm_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "openvm_tpu")]
assert not bad, bad
from openvm_tpu_torch import _build
assert _build._LIB is None
print("ok", len([m for m in sys.modules if m.startswith("openvm_tpu_torch")]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok ")
    assert int(out.stdout.split()[1]) >= 10


def test_constructors_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    words = np.arange(4, dtype=np.uint32)
    with pytest.raises(RuntimeError, match="CUDA"):
        bb.from_numpy(words)
    with pytest.raises(RuntimeError, match="CUDA"):
        bb.monty(words)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.lib()
    t = bb.from_numpy(words, device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.int32


def test_ctypes_signatures_match_the_cuda_sources():
    src = "".join((_build.CSRC / s).read_text() for s in _build.SOURCES)
    entries = dict(re.findall(r'extern "C" int (ovt_\w+)\(([^)]*)\)', src))
    assert set(entries) == set(_build._SIGNATURES)
    for name, params in entries.items():
        assert len(params.split(",")) == len(_build._SIGNATURES[name]), name
    assert set(p.name for p in _build.CSRC.glob("*.cu")) == set(_build.SOURCES)
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH


def test_every_port_package_is_checked():
    """The import check above walks every module of the port: the pairing
    host library, the Fp2, Fp12 and native circuit modules and the native
    Builder among them."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for module in ("pairing/__init__.py", "pairing/tower.py", "pairing/curve.py",
                   "pairing/miller.py", "pairing/final_exp.py", "vm/circuit/fp2.py",
                   "vm/circuit/fp12.py", "vm/circuit/native.py",
                   "native_compiler/__init__.py", "native_compiler/builder.py"):
        assert f"openvm_tpu_torch/{module}" in names, module


def test_native_config_takes_the_python_loop(tmp_path, monkeypatch):
    """A prove under NativeConfig makes no NativeVmHandle, whatever
    ``native=`` says: the config chooses the Python loop.  Under the RV32
    config a core that does not build still raises, as in
    tests/test_torch_vm.py::test_preflight_build_failure_raises."""
    from openvm_tpu_torch.stark import FriParameters, StarkConfig
    from openvm_tpu_torch.vm import machine, native
    from openvm_tpu_torch.vm.guest import (NATIVE_INPUTS, build_fib_program,
                                           build_native_program)

    def no_handle(exe):
        raise AssertionError("NativeVmHandle made for a native-VM program")

    cfg = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2, proof_of_work_bits=1))
    vm = machine.VirtualMachine(machine.NativeConfig(stark=cfg), device="cpu")
    vm.keygen()
    with monkeypatch.context() as mp:
        mp.setattr(machine, "NativeVmHandle", no_handle)
        for flag in (True, False):
            heights, pre = vm.prove(build_native_program(), inputs=NATIVE_INPUTS,
                                    native=flag, heights_only=True)
            assert pre.exit_code == 0 and pre.touched[(3, 0)][0] == 3
            assert heights["native_poseidon2"] == 2 and heights["poseidon2"] == 2
    bad = tmp_path / "preflight.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PF_CPP", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_pf_lib", None)
    rv32 = machine.VirtualMachine(machine.Rv32Config(stark=cfg), device="cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        rv32.execute_metered(build_fib_program(1))
