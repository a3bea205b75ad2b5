"""The port's VM proof of a sha256 + int256 + modular-arithmetic guest on the
CPU against openvm_tpu's: contexts, the JAX package's verifier, and the
constraint checker.

One config, path 7's: FIB_EXECUTORS with the sha256 and int256 extensions
and the modular chips of secp256k1's two moduli.  The JAX package runs
``build_u256_iter_program(2)`` only up to its STARK prove (its
``stark_prove`` replaced by a capture of the proving contexts, pinned by
SHA-256 and recomputed live under ``OPENVM_SLOW``), so no JAX prove runs
here; the port proves it on the CPU with its plain versions.  Every AIR's
context equals the JAX package's, the JAX package's verifier accepts the
port's proof, and its public values are ``u256_iter_reference(2)``.  The
port's checker catches a changed int256 result and a changed Mul256Air
carry (tests/test_vm_bigint_negative.py's two cases).  On a guest that
makes no extension call (fib(8)), the unused int256 and modular chips' one
zero row passes the port's checker, as it passes the JAX package's
debugger: both report only sha256's known round-flag failures (F3),
pinned.  A smaller guest (every int256 op and five modular ops over
secp256k1's prime, no sha256) is proved with the port's bytes equal to the
JAX package's, pinned by SHA-256 and compared live under ``OPENVM_SLOW``.
Like tests/test_torch_keccak_vm.py, this file keeps to a few test
functions, so that ``--dist loadfile`` queues it after
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
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.debug import check_constraints
from openvm_tpu_torch.vm import guest
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

from test_torch_bigint import jax_u256_exe
from test_torch_keccak_vm import canonical
from test_vm_bigint import ALL_OPS
from test_vm_bigint import build_bigint_program as jax_build_bigint_program
from test_vm_prove import TEST_STARK as JAX_TEST_STARK

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
N = 2
FLAGS = dict(executors=guest.FIB_EXECUTORS, sha256=True, bigint=True,
             moduli=guest.U256_MODULI)
NEW_CHIPS = ("int256_", "modular_")
# The JAX package's proving contexts of build_u256_iter_program(N), its
# STARK prove stopped (``contexts_digest``; about a minute of JAX
# tracegen and histograms, recomputed under OPENVM_SLOW).
U256_CONTEXTS_SHA256 = "d04c165d565cc9c2d90721b494a003f4958e7d7c935373b79b155e4f43817891"
# The JAX package's debugger on fib(8)'s contexts in this config: only
# sha256's round-flag constraints fail on its zero row (F3).
F3_FAILURES = ["air sha256: constraint #64 nonzero at row 0 (of 1)",
               "air sha256: constraint #65 nonzero at row 0 (of 1)"]
# A guest small enough for the JAX package's CPU prove: every int256 op
# (tests/test_vm_bigint.py's ALL_OPS) and ADD, MUL, DIV, SUB and IS_EQ over
# secp256k1's prime, in a config without sha256 and with one modulus.
SMALL_FLAGS = dict(executors=("alu", "loadstore", "hintstore"), bigint=True,
                   moduli=(guest.SECP256K1_P,))
SMALL_OPS = ALL_OPS + [guest.modular_r(guest.ADD_F7, 3, 1, 2),
                       guest.modular_r(guest.MUL_F7, 4, 3, 2),
                       guest.modular_r(guest.DIV_F7, 3, 4, 2),
                       guest.modular_r(guest.SUB_F7, 4, 3, 1),
                       guest.modular_r(guest.ISEQ_F7, 28, 3, 3)]
# The JAX package's proof of that guest under TEST_STARK (265,321 bytes;
# its CPU prove took 1,477 s and about 15 GB when this was pinned).
SMALL_PROOF_SHA256 = "3ee23e1b51af2945bac68d9e08475f4941f42bba1e33d19991b59468f5920ab8"


class _StopBeforeProve(Exception):
    pass


def _jax_contexts(jvm, exe):
    captured = {}

    def capture(pk, ctxs):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            jvm.prove(exe)
    return captured["ctxs"]


def contexts_digest(ctxs) -> str:
    """SHA-256 of the proving contexts: each matrix's shape and canonical
    words, and the public values, AIR by AIR."""
    h = hashlib.sha256()
    for ctx in ctxs:
        for m in [ctx.common_main] + list(ctx.cached_mains):
            words = canonical(m).astype(np.uint64)
            h.update(np.asarray(words.shape, dtype=np.uint64).tobytes())
            h.update(words.tobytes())
        h.update(np.asarray([int(v) % P for v in ctx.public_values], dtype=np.uint64).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def case():
    """Both packages' VMs of path 7's config (the JAX package's keygen for
    its verifier); the port's contexts, proof and preflight of the u256
    guest."""
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK, **FLAGS))
    jvm.keygen(cache=False)
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, **FLAGS), device="cpu")
    vm.keygen()
    record = {}
    exe = guest.build_u256_iter_program(N)
    proof, pre = vm.prove(exe, record=record)
    return {"jax_vm": jvm, "vm": vm, "exe": exe, "jexe": jax_u256_exe(guest.u256_iter_items(N)[0]),
            "proof": proof, "pre": pre, "ctxs": record["ctxs"],
            "blob": codec.encode_proof(proof)}


def test_contexts_equal_and_jax_verifier_accepts(case):
    """Every AIR's trace and public values equal the JAX package's
    (U256_CONTEXTS_SHA256; the verifying keys' pre-hashes live), every chip
    of the config has rows, and the JAX package's verifier accepts the
    port's proof, whose public values are the guest's reference."""
    vm, jvm = case["vm"], case["jax_vm"]
    assert [a.name for a in vm.airs] == [a.name for a in jvm.airs]
    assert vm.pk.vk.pre_hash.tolist() == jvm.pk.vk.pre_hash.tolist()
    assert contexts_digest(case["ctxs"]) == U256_CONTEXTS_SHA256
    rows = case["pre"].records
    assert all(name in rows for name in
               [a.name for a in vm.airs if a.name.startswith(NEW_CHIPS + ("sha256",))])
    jproof = jcodec.decode_proof(case["blob"])
    jstark.verify(jvm.pk.vk, jproof)
    jresult = jvm.verify(jproof, expected_exe_commit=jvm.commit_exe(case["jexe"]))
    result = vm.verify(case["proof"], expected_exe_commit=vm.commit_exe(case["exe"]),
                       exe=case["exe"])
    assert list(jresult["public_values"]) == list(result["public_values"]) \
        == guest.u256_iter_reference(N)


def _tampered(ctxs, vm, name, col, to_tensor=True):
    """``ctxs`` with row 0 of the named column of the AIR's trace plus 1."""
    out = copy.copy(ctxs)
    k = next(i for i, c in enumerate(ctxs) if vm.airs[c.air_id].name == name)
    ctx = copy.copy(ctxs[k])
    m = canonical(ctx.common_main).copy()
    j = vm.airs[ctx.air_id].c.index[col]
    m[0, j] = (m[0, j] + 1) % P
    ctx.common_main = bb.monty(m, device="cpu") if to_tensor else m
    out[k] = ctx
    return out


def test_check_constraints_catches_tampered_int256(case):
    """No failure on the good contexts; a changed int256_alu result byte
    and a changed Mul256Air carry each fail a constraint of their AIR."""
    vm = case["vm"]
    assert check_constraints(vm.pk, case["ctxs"]) == []
    for name, col in (("int256_alu", "z"), ("int256_mul", "carry")):
        failures = check_constraints(vm.pk, _tampered(case["ctxs"], vm, name, col),
                                     raise_on_error=False)
        assert failures and failures[0].startswith(f"air {name}: constraint #"), failures


def test_unused_chips_zero_rows_as_jax(case):
    """F3 on the new chips: fib(8) in path 7's config leaves every int256,
    modular and sha256 chip at one zero row.  The port's checker gives
    exactly F3_FAILURES, sha256's round-flag constraints, which the JAX
    package's debugger gives on the same contexts (compared live when
    the pin was taken): the int256 and modular chips' zero rows pass."""
    vm = case["vm"]
    ctxs, _ = vm._contexts(guest.build_fib_program(8), None, None, True, None, None)
    heights = {vm.airs[c.air_id].name: int(c.common_main.shape[0]) for c in ctxs}
    assert all(heights[a.name] == 1 for a in vm.airs
               if a.name.startswith(NEW_CHIPS + ("sha256",)))
    assert check_constraints(vm.pk, ctxs, raise_on_error=False) == F3_FAILURES


def test_small_guest_proof_equals_jax_pin():
    """Every int256 op and five modular ops over secp256k1's prime: the
    port's CPU proof has the bytes of the JAX package's prove of the same
    guest (SMALL_PROOF_SHA256, pinned)."""
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, **SMALL_FLAGS), device="cpu")
    vm.keygen()
    proof, pre = vm.prove(guest.build_bigint_program(SMALL_OPS),
                          inputs=guest.hint_input_for(guest.A_VAL, guest.B_VAL))
    assert {"int256_alu", "int256_mul", "modular_muldiv_0", "modular_iseq_0"} <= set(pre.records)
    assert hashlib.sha256(codec.encode_proof(proof)).hexdigest() == SMALL_PROOF_SHA256


def test_jax_reproduces_pins():
    """The JAX package's contexts of the u256 guest and its prove of the
    small guest, live (about 25 minutes and 15 GB of XLA:CPU compiles; run
    with OPENVM_SLOW=1).  The JAX prove of build_u256_iter_program(2)
    passed 16 GB within 20 minutes and is not compared (ROADMAP.md, G3)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's contexts and prove")
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK, **FLAGS))
    jvm.keygen(cache=False)
    ctxs = _jax_contexts(jvm, jax_u256_exe(guest.u256_iter_items(N)[0]))
    assert contexts_digest(ctxs) == U256_CONTEXTS_SHA256
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK, **SMALL_FLAGS))
    jvm.keygen(cache=False)
    jproof, _ = jvm.prove(jax_build_bigint_program(SMALL_OPS),
                          inputs=guest.hint_input_for(guest.A_VAL, guest.B_VAL))
    assert hashlib.sha256(jcodec.encode_proof(jproof)).hexdigest() == SMALL_PROOF_SHA256
