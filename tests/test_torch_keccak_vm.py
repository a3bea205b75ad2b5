"""The port's VM proofs of a keccak256 and a sha256 guest on the CPU against
openvm_tpu's: contexts, the JAX package's verifier, and the constraint
checker.

The JAX package runs each guest only up to its STARK prove (its
``stark_prove`` replaced by a capture of the proving contexts), so no JAX
prove runs here.  The port proves tests/test_vm_keccak.py's guest over 150
bytes (two keccak blocks) and tests/test_vm_sha256.py's over 58 bytes (a
block whose padding spills into a second) on the CPU with its plain
versions: every AIR's context equals the JAX package's, and the JAX
package's verifier accepts the port's proof.  The port's checker passes on
the keccak contexts, and with one keccakf cell changed it gives the JAX
package's failure strings.  Like tests/test_torch_persistent.py, this file
keeps to a few test functions, so that ``--dist loadfile`` queues it after
tests/test_aggregation.py.
"""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.stark import debug as jdebug
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.debug import check_constraints
from openvm_tpu_torch.vm.circuit.keccak import keccak256
from openvm_tpu_torch.vm.circuit.sha256 import sha256
from openvm_tpu_torch.vm.guest import (build_keccak_program, build_sha_program,
                                       hint_inputs)
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

from test_vm_keccak import build_keccak_program as jax_build_keccak_program
from test_vm_prove import TEST_STARK as JAX_TEST_STARK
from test_vm_sha256 import build_sha_program as jax_build_sha_program

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
EXECUTORS = ("alu", "loadstore", "hintstore")
KECCAK_DATA = bytes((3 * i + 1) & 0xFF for i in range(150))  # 2 blocks
SHA_DATA = bytes((7 * i + 2) & 0xFF for i in range(58))  # 2 blocks
# a keccakf cell the tamper test changes: row 5 (round 5 of the first
# permutation), column 40 (a bit of the theta parity columns)
TAMPER_ROW, TAMPER_COL = 5, 40


class _StopBeforeProve(Exception):
    pass


def canonical(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        return bb.canonical_np(m)
    return np.asarray(m, dtype=np.uint64) % P


def _case(flag, build, jax_build, data):
    """Both packages' VMs of the config; the JAX package's contexts and the
    port's contexts, proof and preflight of the guest over ``data``."""
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(
        stark=JAX_TEST_STARK, executors=EXECUTORS, **{flag: True}))
    jvm.keygen(cache=False)
    captured = {}

    def capture(pk, ctxs):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    inputs = hint_inputs(data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            jvm.prove(jax_build(len(data)), inputs=inputs)
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, executors=EXECUTORS,
                                   **{flag: True}), device="cpu")
    vm.keygen()
    record = {}
    exe = build(len(data))
    proof, pre = vm.prove(exe, inputs=inputs, record=record)
    return {"jax_vm": jvm, "jax_ctxs": captured["ctxs"], "vm": vm, "exe": exe,
            "jexe": jax_build(len(data)), "proof": proof, "pre": pre,
            "ctxs": record["ctxs"], "blob": codec.encode_proof(proof)}


@pytest.fixture(scope="module")
def keccak_case():
    return _case("keccak", build_keccak_program, jax_build_keccak_program, KECCAK_DATA)


@pytest.fixture(scope="module")
def sha_case():
    return _case("sha256", build_sha_program, jax_build_sha_program, SHA_DATA)


def _assert_contexts_equal(case):
    vm, jvm = case["vm"], case["jax_vm"]
    assert [a.name for a in vm.airs] == [a.name for a in jvm.airs]
    assert vm.pk.vk.pre_hash.tolist() == jvm.pk.vk.pre_hash.tolist()
    for tc, jc in zip(case["ctxs"], case["jax_ctxs"]):
        name = vm.airs[tc.air_id].name
        assert tc.air_id == jc.air_id, name
        assert np.array_equal(canonical(tc.common_main), canonical(jc.common_main)), name
        assert len(tc.cached_mains) == len(jc.cached_mains), name
        for a, b in zip(tc.cached_mains, jc.cached_mains):
            assert np.array_equal(canonical(a), canonical(b)), name
        assert [int(v) % P for v in tc.public_values] == \
            [int(v) % P for v in jc.public_values], name


def _assert_jax_accepts(case):
    vm, jvm = case["vm"], case["jax_vm"]
    jproof = jcodec.decode_proof(case["blob"])
    jstark.verify(jvm.pk.vk, jproof)
    jresult = jvm.verify(jproof, expected_exe_commit=jvm.commit_exe(case["jexe"]))
    result = vm.verify(case["proof"], expected_exe_commit=vm.commit_exe(case["exe"]),
                       exe=case["exe"])
    assert list(jresult["public_values"]) == list(result["public_values"])
    return result["public_values"]


def test_keccak_contexts_equal_and_jax_verifier_accepts(keccak_case):
    """Every AIR's trace (keccakf's padding permutations included) and
    public values equal the JAX package's, and its verifier accepts the
    port's proof, which reveals digest words 0 and 7."""
    _assert_contexts_equal(keccak_case)
    heights = {keccak_case["vm"].airs[c.air_id].name: int(c.common_main.shape[0])
               for c in keccak_case["ctxs"]}
    assert heights["keccakf"] == 64 and heights["keccak_sponge"] == 2
    pvs = _assert_jax_accepts(keccak_case)
    digest = keccak256(KECCAK_DATA)
    assert list(pvs[:8]) == list(digest[:4]) + list(digest[28:32])


def test_sha256_contexts_equal_and_jax_verifier_accepts(sha_case):
    _assert_contexts_equal(sha_case)
    heights = {sha_case["vm"].airs[c.air_id].name: int(c.common_main.shape[0])
               for c in sha_case["ctxs"]}
    assert heights["sha256"] == 128 and heights["sha256_sponge"] == 2
    pvs = _assert_jax_accepts(sha_case)
    assert list(pvs[:4]) == list(sha256(SHA_DATA)[:4])


def _tampered(ctxs, vm, to_tensor: bool):
    out = copy.copy(ctxs)
    k = next(i for i, c in enumerate(ctxs) if vm.airs[c.air_id].name == "keccakf")
    ctx = copy.copy(ctxs[k])
    m = canonical(ctx.common_main).copy()
    m[TAMPER_ROW, TAMPER_COL] = (m[TAMPER_ROW, TAMPER_COL] + 1) % P
    ctx.common_main = bb.monty(m, device="cpu") if to_tensor else m
    out[k] = ctx
    return out


def test_check_constraints_matches_jax(keccak_case):
    """No failure on the good keccak contexts; with one keccakf cell
    changed, the JAX package's debugger's failure strings
    (tests/test_vm_keccak.py:213 runs that debugger on the good ones)."""
    vm, jvm = keccak_case["vm"], keccak_case["jax_vm"]
    assert check_constraints(vm.pk, keccak_case["ctxs"]) == []
    ours = check_constraints(vm.pk, _tampered(keccak_case["ctxs"], vm, True),
                             raise_on_error=False)
    theirs = jdebug.check_constraints(jvm.pk, _tampered(keccak_case["jax_ctxs"], jvm, False),
                                      raise_on_error=False)
    assert ours and ours == theirs
    assert ours[0].startswith("air keccakf: constraint #")


def test_keccak_proof_equals_jax():
    """The JAX package's prove of the same keccak guest gives the port's
    bytes (XLA:CPU compiles keccakf's DAG of 56 K nodes; run with
    OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to prove the keccak guest in both packages")
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(
        stark=JAX_TEST_STARK, executors=EXECUTORS, keccak=True))
    jvm.keygen(cache=False)
    jproof, _ = jvm.prove(jax_build_keccak_program(len(KECCAK_DATA)),
                          inputs=hint_inputs(KECCAK_DATA))
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, executors=EXECUTORS, keccak=True),
                        device="cpu")
    vm.keygen()
    proof, _ = vm.prove(build_keccak_program(len(KECCAK_DATA)),
                        inputs=hint_inputs(KECCAK_DATA))
    blob = codec.encode_proof(proof)
    assert hashlib.sha256(blob).hexdigest() == \
        hashlib.sha256(jcodec.encode_proof(jproof)).hexdigest()
