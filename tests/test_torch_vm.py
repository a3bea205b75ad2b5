"""The port's RV32IM VM against openvm_tpu's: the fib(10) guest's proving
contexts.

The port runs the guest on the CPU up to its STARK prove (its
``stark_prove`` replaced by a capture of the proving contexts): its AIRs,
verifying key hash and every AIR's context (the multiplicity tables among
them) equal the JAX package's, pinned here by SHA-256
(``CONTEXT_SHA256``, ``VK_PRE_HASH``).  tests/test_torch_vm_proof.py
computes the JAX package's contexts live and holds them to the same pins,
and holds the port's proof of the guest to the JAX package's
(``FIB10_PROOF_SHA256``) and to its verifier; the JAX keygen and the
port's prove stay there, in a file of few tests, so that this one takes a
few seconds.  The preflight's Python loop and C++ core record the same
rows, a core that does not build raises, an opcode no family owns ends
as in the JAX package and the native phantoms behave as its.
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest
import torch

from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu.vm import transpiler as jtranspiler
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.vm import machine, native
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program
from openvm_tpu_torch.vm.instructions import Instruction, Program, SystemOpcode, VmExe
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine
from openvm_tpu_torch.vm.preflight import PreflightInterpreter
from openvm_tpu_torch.vm.transpiler import Transpiler

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


# the JAX package's VM of FIB_EXECUTORS under tests/test_vm_prove.py's
# TEST_STARK: its verifying key's pre_hash and the SHA-256 of each AIR's
# proving context of fib(10) (``context_digest``), computed live by
# tests/test_torch_vm_proof.py::test_jax_contexts_equal_pins
VK_PRE_HASH = [1648359518, 734183359, 725779700, 1112962446,
               518190510, 1662853829, 158422164, 975391667]
CONTEXT_SHA256 = {
    "program":
        "9df653bc88129af50f4863331a53cba258a13fd7a282f74ae62fbd0bf3481a2b",
    "connector":
        "091f3123a85858be194a01173115eea8cb8cb0b786c49cf71a3484602f033bc0",
    "public_values":
        "656a6155071ecce0ec21bd33065b7a84853c7b07251d9454ff9f349cf8f5d1e4",
    "memory_boundary":
        "d653d74b8051638b8bbd38b5f6688b54f6fcc8a74fbdd6beb1b79e05d7ee7d15",
    "range_checker":
        "5f3230da12bc9514a3b6261c8fac72b232b0b79fe435aa3671ea364931de3530",
    "bitwise_lookup":
        "4a0cee0ce581be4832d4ecfe98ae968f1c747b16ae89633a8f1d0d4e8a43cd3f",
    "phantom":
        "c01f2f8293c8ebade5099c2b280b9b6914eac96b465f13724d9457dbb51e161f",
    "rv32_base_alu":
        "6b7d23a8ec2758e6890f931c2eb2783110ca97246d65842ea53702c1c4ef1863",
    "rv32_less_than":
        "8d474b018c5cf8161edb947e17137899e586349b25bc9cf3a2e4b3f35347e646",
    "rv32_branch_eq":
        "048a6a4c7ac93f0519905ad8d13d7754d976bd3853ebc3bacb04d64fc8f7fa9c",
    "rv32_branch_lt":
        "e9e8637ae721a0de3bce1dbb27aad3e3910de2b2c1df1011cca96e9049618161",
    "rv32_jal_lui":
        "8f1ebd6911267ba0bf2fa133e860d0b3ec828c791adea76f91a5fd9bc8854452",
    "rv32_jalr":
        "edd9af4b4bc9ea6f707a351b5f33b49fe745bd8d4607e1e28339d2d51ce9cf50",
    "rv32_auipc":
        "b7175b89fdbcf20ff305b50b8d6416037c99aac625ab36acb098383dda1779f0",
    "rv32_load_store":
        "a25cb8b6379cbe7732dfac5202ef94fbb865d83358d039541b5dd5b42dbe8be2",
}


class _StopBeforeProve(Exception):
    pass


def canonical(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        return bb.canonical_np(m)
    return np.asarray(m, dtype=np.uint64) % P


def context_digest(ctx) -> str:
    """SHA-256 of a proving context's canonical words: each main matrix's
    shape and words (common, then cached), then its public values."""
    h = hashlib.sha256()
    for m in [ctx.common_main, *ctx.cached_mains]:
        a = np.ascontiguousarray(canonical(m))
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    h.update(np.asarray([int(v) % P for v in ctx.public_values], dtype=np.uint64).tobytes())
    return h.hexdigest()


def port_contexts(vm, exe) -> list:
    """The port's proving contexts of ``exe``, its STARK prove replaced by a
    capture."""
    captured = {}

    def capture(pk, ctxs, **kwargs):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(machine, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            vm.prove(exe)
    return captured["ctxs"]


@pytest.fixture(scope="module")
def port_vm():
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, executors=FIB_EXECUTORS),
                        device="cpu")
    vm.keygen()
    exe = build_fib_program(10)
    return {"vm": vm, "exe": exe, "ctxs": port_contexts(vm, exe)}


def test_air_names(port_vm):
    assert [a.name for a in port_vm["vm"].airs] == AIR_NAMES


def test_vk_pre_hash_equal(port_vm):
    assert port_vm["vm"].pk.vk.pre_hash.tolist() == VK_PRE_HASH


@pytest.mark.parametrize("air_id", range(len(AIR_NAMES)), ids=AIR_NAMES)
def test_contexts_equal(port_vm, air_id):
    """Common and cached mains (the multiplicity tables among them) and
    public values of every AIR: their digest is the JAX package's."""
    tc = next(c for c in port_vm["ctxs"] if c.air_id == air_id)
    assert context_digest(tc) == CONTEXT_SHA256[AIR_NAMES[air_id]]


def test_multiplicity_tables_are_live(port_vm):
    """The histograms counted something: the range and bitwise tables of
    fib(10) are not empty (their equality is in test_contexts_equal)."""
    for name in ("range_checker", "bitwise_lookup"):
        ctx = port_vm["ctxs"][AIR_NAMES.index(name)]
        assert canonical(ctx.common_main).sum() > 0


def test_python_preflight_equals_native_core(port_vm):
    """The preflight's Python loop and the C++ core record the same rows."""
    exe = port_vm["exe"]
    py = PreflightInterpreter(exe).execute()
    cpp = PreflightInterpreter(exe).execute(nvm=native.NativeVmHandle(exe))
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
    """Now that the native opcodes exist: an opcode in 0x100-0x1ff that no
    native family owns (0x1FF) ends in the JAX package's ExecutionError,
    word for word, through the Python loop and the C++ core; the native
    phantoms (HINT_INPUT, HINT_FELT, HINT_BITS, PRINT and the unhandled
    HINT_LOAD, 0x10 to 0x14) give the JAX package's records and touched
    words; the Fp2 words (custom-1, funct3 0b010) and the pairing word
    (funct3 0b011) transpile to the JAX package's Fp2 ADD and HintFinalExp
    phantom."""
    from openvm_tpu.vm.instructions import Instruction as JaxInstruction
    from openvm_tpu.vm.instructions import Program as JaxProgram
    from openvm_tpu.vm.instructions import VmExe as JaxVmExe
    from openvm_tpu.vm.interpreter import ExecutionError as JaxExecutionError
    from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
    from openvm_tpu_torch.vm.instructions import (FieldArithmeticOpcode, NativePhantom,
                                                  NativeLoadStore4Opcode, phantom)
    from openvm_tpu_torch.vm.interpreter import ExecutionError

    def both(insns):
        exe = VmExe(program=Program(instructions=insns), pc_start=0)
        return exe, JaxVmExe(program=JaxProgram(
            instructions=[JaxInstruction(*dataclasses.astuple(i)) for i in insns],
            pc_base=0), pc_start=0)

    exe, jexe = both([Instruction(0x1FF, a=4, b=8, c=12, d=4, e=4)])
    with pytest.raises(JaxExecutionError) as theirs:
        JaxPreflight(jexe).execute()
    with pytest.raises(ExecutionError) as ours:
        PreflightInterpreter(exe).execute()
    with pytest.raises(ExecutionError) as core:
        PreflightInterpreter(exe).execute(nvm=native.NativeVmHandle(exe))
    assert str(ours.value) == str(core.value) == str(theirs.value) == \
        "opcode 0x1ff has no circuit support yet"
    hint4 = NativeLoadStore4Opcode.HINT_STOREW4
    exe, jexe = both([
        Instruction(FieldArithmeticOpcode.ADD, a=7, b=13, c=0, d=4, e=0, f=0),
        phantom(NativePhantom.HINT_INPUT),
        Instruction(hint4, a=0, b=0, c=40, d=4, e=4, f=0),
        phantom(NativePhantom.HINT_FELT),
        Instruction(hint4, a=0, b=0, c=44, d=4, e=4, f=0),
        phantom(NativePhantom.HINT_BITS, a=7, b=4),
        Instruction(hint4, a=0, b=0, c=48, d=4, e=4, f=0),
        phantom(NativePhantom.PRINT, a=7, c_upper=4),
        phantom(NativePhantom.HINT_LOAD),
        Instruction(SystemOpcode.TERMINATE, c=0)])
    inputs = [[5, 9, 11], [21, 22, 23, 24]]
    ours, theirs = PreflightInterpreter(exe).execute(inputs), JaxPreflight(jexe).execute(inputs)
    assert sorted(ours.records) == sorted(theirs.records) == [
        "native_field_arithmetic", "native_loadstore4", "phantom"]
    for chip, cols in theirs.records.items():
        for col, v in cols.items():
            assert np.array_equal(ours.records[chip][col], v), (chip, col)
    assert ours.touched == theirs.touched and ours.exit_code == theirs.exit_code == 0
    assert [ours.touched[(4, a)][0] for a in range(40, 52)] == \
        [3, 5, 9, 11, 21, 22, 23, 24, 1, 0, 1, 1]
    fp2 = (2 << 20) | (1 << 15) | (0b010 << 12) | (3 << 7) | 0x2B
    pairing = (2 << 20) | (1 << 15) | (0b011 << 12) | 0x2B
    ours = Transpiler().transpile([fp2, pairing])
    theirs = jtranspiler.Transpiler().transpile([fp2, pairing])
    assert [dataclasses.astuple(i) for i in ours] == [dataclasses.astuple(i) for i in theirs]
    assert ours[0].opcode == 0x710
    assert (ours[1].opcode, ours[1].c & 0xFFFF) == (SystemOpcode.PHANTOM, 0x30)


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
