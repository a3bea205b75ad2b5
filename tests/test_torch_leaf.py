"""The port's proof of its verifier program on the native VM.

tests/test_torch_recursion.py's verifier program (the recursion instance's
FibonacciAir proof verified in-program, its commitment exposed) is proved by
the port on the CPU with its plain versions, on ``NativeConfig`` at the
test profile with the leaf layout's 44 public values.  The program's
PERM_POS2 words carry e = 4 (ROADMAP F5), which the JAX package's Builder
does not emit, so the JAX package cannot prove its own program and these
bytes have no JAX counterpart: ``LEAF_PROGRAM_PROOF_SHA256`` pins them as the
port makes them.  The JAX package's VM verifier and the port's accept the
proof, and a tampered public value fails in both.  The same two
verifying keys (one keygen in each package, the ``keys`` fixture, which
waits on no prove) drive ``build_internal_program`` and
``build_root_program`` at fixed log degrees, whose programs equal the JAX
package's word for word with PERM_POS2's e masked.  This file keeps
to a few test functions, so that ``--dist loadfile`` queues it after
tests/test_aggregation.py.
"""

import copy
import hashlib

import numpy as np
import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.native_compiler import verifier_program as jvp
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.native_compiler import (build_internal_program, build_root_program,
                                              serialize_proof_felts)
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.verifier import VerificationError
from openvm_tpu_torch.vm.machine import NativeConfig, VirtualMachine

from test_native_vm import TEST_STARK as JAX_TEST_STARK
from test_torch_native import jax_exe
from test_torch_recursion import assert_programs_equal, recursion  # noqa: F401

torch.set_num_threads(1)

P = 2013265921
SEED = 0
LEAF_PVS = 44
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
# sha256 of the port's encode_proof bytes for
# VirtualMachine(NativeConfig(stark=TEST_STARK, num_native_pvs=44),
# device="cpu").prove(exe, inputs=serialize_proof_felts(vk, proof)), exe the
# recursion instance's build_verifier_program(expose="commit")
LEAF_PROGRAM_PROOF_SHA256 = \
    "457f3d5d5587868173aaa400a32f4e5546f1e5193561e92dd0f85bd777ebcdc9"
# the internal and root programs' child log degrees, one per NativeConfig
# AIR in keygen order (program, connector, native_public_values, ...,
# verify_batch_inside): unequal, with ties, so that the verifier's
# tallest-first order is exercised
NODE_LOG_DEGREES = (12, 1, 6, 11, 11, 17, 16, 3, 12, 4, 10, 12, 12, 10, 8, 10, 6, 8)


@pytest.fixture(scope="module")
def keys():
    """Both packages' native VMs at the test profile with 44 public
    values, after keygen."""
    jvm = jmachine.VirtualMachine(jmachine.NativeConfig(stark=JAX_TEST_STARK,
                                                        num_native_pvs=LEAF_PVS))
    jvm.keygen(cache=False)
    vm = VirtualMachine(NativeConfig(stark=TEST_STARK, num_native_pvs=LEAF_PVS),
                        device="cpu")
    vm.keygen()
    return {"jvm": jvm, "vm": vm}


@pytest.fixture(scope="module")
def native(keys, recursion):  # noqa: F811
    """``keys`` and the port's CPU proof of the verifier program."""
    exe = recursion["exe"]
    hints = serialize_proof_felts(recursion["pk"].vk, recursion["proof"])
    proof, pre = keys["vm"].prove(exe, inputs=hints)
    return {**keys, "exe": exe, "proof": proof, "pre": pre,
            "blob": codec.encode_proof(proof)}


def test_internal_and_root_programs_equal_jax(keys):
    """build_internal_program (two children) and build_root_program over
    each package's NativeConfig verifying key, at fixed log degrees (no
    proof needed), equal the JAX package's with PERM_POS2's e masked."""
    vm, jvm = keys["vm"], keys["jvm"]
    assert vm.pk.vk.pre_hash.tolist() == jvm.pk.vk.pre_hash.tolist()
    log_degrees = list(NODE_LOG_DEGREES)
    assert len(log_degrees) == len(vm.pk.vk.per_air)
    exe, meta = build_internal_program(vm.pk.vk, log_degrees, 2)
    jexe, jmeta = jvp.build_internal_program(jvm.pk.vk, log_degrees, 2)
    assert meta == jmeta and meta["num_children"] == 2
    n_internal = assert_programs_equal(exe, jexe)
    rng = np.random.default_rng(SEED)
    internal_commit, leaf_commit = ([int(v) for v in rng.integers(0, P, size=8)]
                                    for _ in range(2))
    exe, meta = build_root_program(vm.pk.vk, log_degrees, internal_commit, leaf_commit)
    jexe, jmeta = jvp.build_root_program(jvm.pk.vk, log_degrees, internal_commit,
                                         leaf_commit)
    assert meta == jmeta
    n_root = assert_programs_equal(exe, jexe)
    assert n_internal == 2 * n_root


def test_proof_sha256_pinned(native, recursion):  # noqa: F811
    """The verifier program ran to its end and exposed the recursion
    proof's commitment; the proof's bytes are the pinned ones."""
    assert native["pre"].exit_code == 0
    exposed = [native["pre"].touched.get((3, k), [0])[0] for k in range(8)]
    assert exposed == [int(v) for v in recursion["proof"].commitments.main_trace[-1]]
    assert hashlib.sha256(native["blob"]).hexdigest() == LEAF_PROGRAM_PROOF_SHA256


def test_verifiers_accept_port_proof(native, recursion):  # noqa: F811
    """The JAX package's VM verifier (its STARK verifier inside) and the
    port's accept the proof, the port's with the program's commitment;
    the public values are the recursion proof's commitment and zeros."""
    vm, jvm, exe = native["vm"], native["jvm"], native["exe"]
    theirs = jvm.verify(jcodec.decode_proof(native["blob"]), exe=jax_exe(exe))
    commit = vm.commit_exe(exe)
    ours = vm.verify(native["proof"], expected_exe_commit=commit, exe=exe)
    want = [int(v) for v in recursion["proof"].commitments.main_trace[-1]]
    assert list(ours["public_values"]) == list(theirs["public_values"]) == \
        want + [0] * (LEAF_PVS - 8)
    with pytest.raises((VerificationError, AssertionError)):
        vm.verify(native["proof"], expected_exe_commit=[(int(v) + 1) % P for v in commit],
                  exe=exe)


def test_tampered_public_value_fails(native):
    proof = copy.deepcopy(native["proof"])
    pv_air = proof.per_air[native["vm"].air_index["native_public_values"]]
    pv_air.public_values[0] = (pv_air.public_values[0] + 1) % P
    with pytest.raises((VerificationError, AssertionError)):
        native["vm"].verify(proof)
    with pytest.raises((jstark.VerificationError, AssertionError)):
        native["jvm"].verify(jcodec.decode_proof(codec.encode_proof(proof)))
