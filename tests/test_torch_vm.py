"""The port's RV32IM VM proof against openvm_tpu's: the fib(10) guest.

One module fixture runs the JAX package's ``VirtualMachine`` up to its STARK
prove (keygen without the disk cache, preflight, tracegen, the lookup
histograms) and captures the proving contexts there, so no JAX prove runs
in these tests.  The port proves the same guest on the CPU with its plain
versions.  Its contexts and multiplicity tables equal the JAX package's;
its proof's SHA-256 equals the pinned hash of the JAX package's proof
(``FIB10_PROOF_SHA256``, recomputed live by the OPENVM_SLOW test), and the
JAX package's verifier accepts it; a tampered public value fails.
chip_smoke.py's ``pinned`` phase proves the same guest on the card and
checks the same hash.
"""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.verifier import VerificationError
from openvm_tpu_torch.vm import native
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program, fib
from openvm_tpu_torch.vm.instructions import BaseAlu256Opcode, Instruction, Program, VmExe
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

from test_vm_prove import TEST_STARK as JAX_TEST_STARK
from test_vm_prove import build_fib_program as jax_build_fib_program

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
# sha256 of openvm_tpu's encode_proof bytes for
# VirtualMachine(Rv32Config(stark=TEST_STARK, executors=FIB_EXECUTORS))
# .prove(build_fib_program(10)) (tests/test_vm_prove.py's instance)
FIB10_PROOF_SHA256 = \
    "7f2298f064201166dd6b35c8beec5f7895484312deeaee02c9d2d204136bf53c"
AIR_NAMES = ["program", "connector", "public_values", "memory_boundary",
             "range_checker", "bitwise_lookup", "phantom", "rv32_base_alu",
             "rv32_less_than", "rv32_branch_eq", "rv32_branch_lt",
             "rv32_jal_lui", "rv32_jalr", "rv32_auipc", "rv32_load_store"]


class _StopBeforeProve(Exception):
    pass


@pytest.fixture(scope="module")
def jax_vm():
    """openvm_tpu's VM and its proving contexts of fib(10)."""
    vm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK,
                                                     executors=FIB_EXECUTORS))
    vm.keygen(cache=False)
    captured = {}

    def capture(pk, ctxs):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            vm.prove(jax_build_fib_program(10))
    return vm, captured["ctxs"]


@pytest.fixture(scope="module")
def port_vm():
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, executors=FIB_EXECUTORS),
                        device="cpu")
    vm.keygen()
    record = {}
    exe = build_fib_program(10)
    proof, pre = vm.prove(exe, record=record)
    return {"vm": vm, "exe": exe, "proof": proof, "pre": pre,
            "ctxs": record["ctxs"], "blob": codec.encode_proof(proof)}


def canonical(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        return bb.canonical_np(m)
    return np.asarray(m, dtype=np.uint64) % P


def test_air_names(jax_vm, port_vm):
    assert [a.name for a in port_vm["vm"].airs] == AIR_NAMES
    assert [a.name for a in jax_vm[0].airs] == AIR_NAMES


def test_vk_pre_hash_equal(jax_vm, port_vm):
    assert port_vm["vm"].pk.vk.pre_hash.tolist() == jax_vm[0].pk.vk.pre_hash.tolist()


@pytest.mark.parametrize("air_id", range(len(AIR_NAMES)), ids=AIR_NAMES)
def test_contexts_equal(jax_vm, port_vm, air_id):
    """Common and cached mains (the multiplicity tables among them) and
    public values of every AIR."""
    jc = next(c for c in jax_vm[1] if c.air_id == air_id)
    tc = next(c for c in port_vm["ctxs"] if c.air_id == air_id)
    assert np.array_equal(canonical(tc.common_main), canonical(jc.common_main))
    assert len(tc.cached_mains) == len(jc.cached_mains)
    for a, b in zip(tc.cached_mains, jc.cached_mains):
        assert np.array_equal(canonical(a), canonical(b))
    assert [int(v) % P for v in tc.public_values] == \
        [int(v) % P for v in jc.public_values]


def test_multiplicity_tables_are_live(port_vm):
    """The histograms counted something: the range and bitwise tables of
    fib(10) are not empty (their equality is in test_contexts_equal)."""
    for name in ("range_checker", "bitwise_lookup"):
        ctx = port_vm["ctxs"][AIR_NAMES.index(name)]
        assert canonical(ctx.common_main).sum() > 0


def test_proof_sha256_pinned(port_vm):
    assert hashlib.sha256(port_vm["blob"]).hexdigest() == FIB10_PROOF_SHA256


def test_jax_verifier_accepts_port_proof(jax_vm, port_vm):
    jproof = jcodec.decode_proof(port_vm["blob"])
    jstark.verify(jax_vm[0].pk.vk, jproof)
    result = jax_vm[0].verify(jproof)
    assert result["public_values"] == port_vm["proof"].per_air[2].public_values


def test_port_verifier_and_public_values(port_vm):
    vm, exe = port_vm["vm"], port_vm["exe"]
    result = vm.verify(port_vm["proof"], expected_exe_commit=vm.commit_exe(exe),
                       exe=exe)
    pvs = result["public_values"]
    assert int.from_bytes(bytes(pvs[:4]), "little") == fib(11)
    assert pvs[4] == fib(11) & 0xFF
    assert port_vm["pre"].exit_code == 0


def test_tampered_public_value_fails(jax_vm, port_vm):
    proof = copy.deepcopy(port_vm["proof"])
    pv_air = proof.per_air[port_vm["vm"].air_index["public_values"]]
    pv_air.public_values[0] = (pv_air.public_values[0] + 1) % (2**31)
    with pytest.raises((VerificationError, AssertionError)):
        port_vm["vm"].verify(proof)
    with pytest.raises((jstark.VerificationError, AssertionError)):
        jax_vm[0].verify(jcodec.decode_proof(codec.encode_proof(proof)))


def test_python_preflight_equals_native_core(port_vm):
    """The preflight's Python loop and the C++ core record the same rows."""
    exe = port_vm["exe"]
    py = PreflightInterpreter(exe).execute()
    cpp = port_vm["pre"]
    assert sorted(py.records) == sorted(cpp.records)
    for chip, cols in py.records.items():
        for col, v in cols.items():
            assert np.array_equal(np.asarray(v, dtype=np.uint64),
                                  np.asarray(cpp.records[chip][col],
                                             dtype=np.uint64)), (chip, col)
    assert py.exec_counts == cpp.exec_counts and py.touched == cpp.touched


def test_preflight_build_failure_raises(tmp_path, monkeypatch):
    """A preflight core that does not build raises; nothing falls back to
    the Python loop."""
    bad = tmp_path / "preflight.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PF_CPP", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_pf_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeVmHandle(build_fib_program(1))


def test_extension_opcode_raises_not_implemented():
    exe = VmExe(program=Program(instructions=[
        Instruction(BaseAlu256Opcode.ADD, a=4, b=8, c=12, d=1, e=2)]), pc_start=0)
    with pytest.raises(NotImplementedError):
        PreflightInterpreter(exe).execute()


def test_jax_prove_reproduces_pinned_hash():
    """The JAX package's full VM prove of fib(10) (minutes of XLA:CPU
    compiles; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's VM prove")
    vm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK,
                                                     executors=FIB_EXECUTORS))
    vm.keygen(cache=False)
    proof, _ = vm.prove(jax_build_fib_program(10))
    assert hashlib.sha256(jcodec.encode_proof(proof)).hexdigest() == \
        FIB10_PROOF_SHA256


def test_fib2000_proof_equals_jax():
    """Path 3's guest at ~10^4 instructions held against the JAX package:
    both prove build_fib_program(2000) (the two guests agree below 2048)
    with TEST_STARK and give the same proof bytes (minutes of XLA:CPU
    compiles and a JAX prove; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to prove fib(2000) in both packages")
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK,
                                                      executors=FIB_EXECUTORS))
    jvm.keygen(cache=False)
    jproof, _ = jvm.prove(jax_build_fib_program(2000))
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, executors=FIB_EXECUTORS),
                        device="cpu")
    vm.keygen()
    proof, pre = vm.prove(build_fib_program(2000))
    assert pre.instret == 5 * 2000 + 15
    assert codec.encode_proof(proof) == jcodec.encode_proof(jproof)
