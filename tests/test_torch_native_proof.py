"""The port's native-VM proof of build_native_program against openvm_tpu's.

One module fixture runs the JAX package's ``VirtualMachine(NativeConfig)``
up to its STARK prove (keygen without the disk cache, preflight, tracegen,
the lookup histograms) and captures the proving contexts there; the port
proves the same program on the CPU with its plain versions.  The contexts
and verifying keys are equal, and so are both packages' contexts of a
small path-10 guest, whose VERIFY_BATCH and FRI_REDUCED_OPENING rows feed
the shared Poseidon2Air and the address-space-4 boundary; the JAX package's verifier accepts the
port's proof and a tampered public value fails in both.  No JAX prove
runs here: the JAX package's CPU prove of this program ran past 900 s and
11.9 GB, so the port's proof is pinned by its SHA-256
(``NATIVE_PROOF_SHA256``), and held to the JAX package's bytes only under
``OPENVM_SLOW`` (ROADMAP G4).  This file keeps to a few test functions, so
that ``--dist loadfile`` queues it after tests/test_aggregation.py.
"""

import copy
import hashlib
import os

import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.verifier import VerificationError
from openvm_tpu_torch.vm import machine
from openvm_tpu_torch.vm.guest import (NATIVE_INPUTS, build_native_program,
                                       build_native_query_program, native_query_stream)
from openvm_tpu_torch.vm.machine import NativeConfig, VirtualMachine

from test_native_vm import TEST_STARK as JAX_TEST_STARK
from test_native_vm import build_native_program as jax_build_native_program
from test_torch_native import jax_exe
from test_torch_vm import _StopBeforeProve, canonical, context_digest

torch.set_num_threads(1)

TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
# sha256 of the port's encode_proof bytes for
# VirtualMachine(NativeConfig(stark=TEST_STARK), device="cpu")
# .prove(build_native_program(), inputs=NATIVE_INPUTS)
NATIVE_PROOF_SHA256 = \
    "7d1f5e79d87f09812573668c7b812908779d1a94fec6ca220711348ae39bba69"


def contexts(module, vm, exe, inputs, **kwargs) -> list:
    """``vm``'s proving contexts of ``exe``, the STARK prove of its machine
    ``module`` replaced by a capture."""
    captured = {}

    def capture(pk, ctxs, **_):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            vm.prove(exe, inputs=inputs, **kwargs)
    return captured["ctxs"]


@pytest.fixture(scope="module")
def jax_vm():
    """openvm_tpu's native VM and its proving contexts of the program."""
    vm = jmachine.VirtualMachine(jmachine.NativeConfig(stark=JAX_TEST_STARK))
    vm.keygen(cache=False)
    return vm, contexts(jmachine, vm, jax_build_native_program(), NATIVE_INPUTS,
                        native=False)


@pytest.fixture(scope="module")
def port_vm():
    vm = VirtualMachine(NativeConfig(stark=TEST_STARK), device="cpu")
    vm.keygen()
    record = {}
    exe = build_native_program()
    proof, pre = vm.prove(exe, inputs=NATIVE_INPUTS, record=record)
    return {"vm": vm, "exe": exe, "proof": proof, "pre": pre,
            "ctxs": record["ctxs"], "blob": codec.encode_proof(proof)}


def test_contexts_equal_jax(jax_vm, port_vm):
    """The AIRs, the verifying key's hash and every AIR's proving context
    (the public-values, boundary and shared Poseidon2 traces and the
    multiplicity tables among them) equal the JAX package's."""
    jvm, jctxs = jax_vm
    vm = port_vm["vm"]
    assert [a.name for a in vm.airs] == [a.name for a in jvm.airs]
    assert [a.width for a in vm.airs] == [a.width for a in jvm.airs]
    assert vm.pk.vk.pre_hash.tolist() == jvm.pk.vk.pre_hash.tolist()
    assert [context_digest(c) for c in port_vm["ctxs"]] == [context_digest(c) for c in jctxs]


def test_query_guest_contexts_equal_jax(jax_vm, port_vm):
    """On build_native_query_program(2, 4, 3, 0) with its stream, every
    AIR's proving context equals the JAX package's: the machine-level
    assembly of the shared Poseidon2Air from the verify_batch requests and
    of the boundary over address space 4, which build_native_program does
    not reach."""
    args = (2, 4, 3, 0)
    exe, stream = build_native_query_program(*args), native_query_stream(*args)
    vm = port_vm["vm"]
    ours = contexts(machine, vm, exe, stream)
    theirs = contexts(jmachine, jax_vm[0], jax_exe(exe), stream, native=False)
    for name in ("fri_reduced_opening", "verify_batch", "verify_batch_inside", "poseidon2"):
        assert canonical(ours[vm.air_index[name]].common_main).any(), name
    assert [context_digest(c) for c in ours] == [context_digest(c) for c in theirs]


def test_proof_sha256_pinned(port_vm):
    assert hashlib.sha256(port_vm["blob"]).hexdigest() == NATIVE_PROOF_SHA256


def test_verifiers_accept_port_proof(jax_vm, port_vm):
    """The JAX package's STARK and VM verifiers and the port's accept the
    proof; the felt public value is the program's 3."""
    jproof = jcodec.decode_proof(port_vm["blob"])
    jstark.verify(jax_vm[0].pk.vk, jproof)
    theirs = jax_vm[0].verify(jproof)
    vm, exe = port_vm["vm"], port_vm["exe"]
    ours = vm.verify(port_vm["proof"], expected_exe_commit=vm.commit_exe(exe), exe=exe)
    assert list(ours["public_values"]) == list(theirs["public_values"]) == [3] + [0] * 15
    assert port_vm["pre"].exit_code == 0


def test_tampered_public_value_fails(jax_vm, port_vm):
    proof = copy.deepcopy(port_vm["proof"])
    pv_air = proof.per_air[port_vm["vm"].air_index["native_public_values"]]
    pv_air.public_values[0] = (pv_air.public_values[0] + 1) % (2**31)
    with pytest.raises((VerificationError, AssertionError)):
        port_vm["vm"].verify(proof)
    with pytest.raises((jstark.VerificationError, AssertionError)):
        jax_vm[0].verify(jcodec.decode_proof(codec.encode_proof(proof)))


def test_jax_prove_reproduces_pinned_hash(jax_vm):
    """The JAX package's own prove of the program (past 900 s and 11.9 GB
    on a CPU; run with OPENVM_SLOW=1) gives the pinned bytes."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's native-VM prove")
    proof, _ = jax_vm[0].prove(jax_build_native_program(), inputs=NATIVE_INPUTS,
                               native=False)
    assert hashlib.sha256(jcodec.encode_proof(proof)).hexdigest() == NATIVE_PROOF_SHA256
