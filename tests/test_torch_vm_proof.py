"""The port's RV32IM VM proof of the fib(10) guest against openvm_tpu's.

One module fixture runs the JAX package's ``VirtualMachine`` up to its STARK
prove (keygen without the disk cache, preflight, tracegen, the lookup
histograms) and captures the proving contexts there, so no JAX prove runs
in these tests; they equal the pins tests/test_torch_vm.py holds the port's
contexts to.  The port proves the same guest on the CPU with its plain
versions.  Its proof's SHA-256 equals the pinned hash of the JAX package's
proof (``FIB10_PROOF_SHA256``, recomputed live by the OPENVM_SLOW test of
tests/test_torch_vm.py), and the JAX package's verifier accepts it; a
tampered public value fails.  chip_smoke.py's ``pinned`` phase proves the
same guest on the card and checks the same hash.  This file keeps to a few
test functions, so that ``--dist loadfile`` queues it after
tests/test_aggregation.py.
"""

import copy
import hashlib

import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.stark import codec
from openvm_tpu_torch.stark.verifier import VerificationError
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program, fib
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

from test_torch_vm import (AIR_NAMES, CONTEXT_SHA256, FIB10_PROOF_SHA256, TEST_STARK,
                           VK_PRE_HASH, _StopBeforeProve, context_digest)
from test_vm_prove import TEST_STARK as JAX_TEST_STARK
from test_vm_prove import build_fib_program as jax_build_fib_program

torch.set_num_threads(1)


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


def test_jax_contexts_equal_pins(jax_vm, port_vm):
    """The JAX package's AIRs, verifying key hash and contexts are the ones
    tests/test_torch_vm.py pins, and so are the contexts the port proved."""
    vm, ctxs = jax_vm
    assert [a.name for a in vm.airs] == AIR_NAMES
    assert vm.pk.vk.pre_hash.tolist() == VK_PRE_HASH
    assert {AIR_NAMES[c.air_id]: context_digest(c) for c in ctxs} == CONTEXT_SHA256
    assert {AIR_NAMES[c.air_id]: context_digest(c) for c in port_vm["ctxs"]} == \
        CONTEXT_SHA256


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
