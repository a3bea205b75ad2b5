"""The port's VM proof of an ecrecover guest on the CPU against
openvm_tpu's: contexts, the JAX package's verifier, and the constraint
checker.

Path 8's config: the default executors (every RV32IM chip and the
range-tuple table), keccak, the modular chips of secp256k1's p and n and
the secp256k1 curve, as the JAX package's ecrecover config
(tests/test_real_elf_breadth.py:193-196).  The port proves
``build_ecrecover_program(1)`` (one signature recovered) on the CPU with
its plain versions; every AIR's context equals the JAX package's (its
STARK prove stopped, pinned by SHA-256 and recomputed live under
``OPENVM_SLOW``), but for F4's repair of the HINT_BUFFER rows of
HintStoreAir, applied to the JAX package's contexts before the digest
(ROADMAP.md: its own constraints reject them); the JAX package's verifier
accepts the port's proof, whose public values are
``ecrecover_reference(1)``.  The port's checker catches one changed
sw_double_0 cell.  tests/test_torch_ecc_proof.py proves the full-opcode
and the ECC guests.  Like tests/test_torch_bigint_vm.py, this file keeps
to a few test functions, so that ``--dist loadfile`` queues it after
tests/test_aggregation.py.
"""

import dataclasses
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
from openvm_tpu_torch.vm.circuit import buses as B
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

from test_torch_bigint_vm import _StopBeforeProve, _tampered, contexts_digest
from test_torch_ecc import jax_exe
from test_torch_keccak_vm import canonical
from test_vm_prove import TEST_STARK as JAX_TEST_STARK

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
N = 1
FLAGS = dict(keccak=True, moduli=guest.ECRECOVER_MODULI, curves=(guest.SECP256K1_CURVE,))
# The JAX package's proving contexts (``contexts_digest`` after
# ``f4_repaired``) of build_ecrecover_program(N) in FLAGS' config, its
# STARK prove stopped (a JAX keygen and tracegen, recomputed under
# OPENVM_SLOW).
ECRECOVER_CONTEXTS_SHA256 = "24d22178a73d01180267bef57fae52b3008bed89d26ea2f880b6221e1f9904a9"


def f4_repaired(vm, ctxs):
    """``ctxs`` as the port makes them (ROADMAP.md, F4): HintStoreAir's
    is_buffer flag, and the length read's timestamp limbs, kept on a
    HINT_BUFFER's start row only, and the range checker's multiplicities
    without the two range sends that each other row of a HINT_BUFFER made
    of those limbs; every other context as it is."""
    out = list(ctxs)
    k, air = next((k, vm.airs[c.air_id]) for k, c in enumerate(ctxs)
                  if vm.airs[c.air_id].name == "rv32_hint_store")
    m = canonical(ctxs[k].common_main).copy()
    ix = air.c.index
    cont = (m[:, ix["is_buffer"]] == 1) & (m[:, ix["is_start"]] == 0)
    sends = [(1 << B.RANGE_LO_BITS) - 1 + m[cont, ix["dlo2"]],
             (1 << (B.TIMESTAMP_BITS - B.RANGE_LO_BITS)) - 1 + m[cont, ix["dhi2"]]]
    for col in ("is_buffer", "dlo2", "dhi2"):
        m[cont, ix[col]] = 0
    out[k] = dataclasses.replace(ctxs[k], common_main=m)
    r = next(r for r, c in enumerate(ctxs) if vm.airs[c.air_id].name == "range_checker")
    mult = canonical(ctxs[r].common_main).copy()
    for rows in sends:  # the table's row of (value, bits) is 2^bits - 1 + value
        np.subtract.at(mult[:, 0], rows.astype(np.int64), 1)
    out[r] = dataclasses.replace(ctxs[r], common_main=mult % P)
    return out


def _jax_contexts(jvm, exe, inputs):
    """The JAX package's proving contexts of the guest: its prove stopped
    at the STARK prove."""
    captured = {}

    def capture(pk, ctxs):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            jvm.prove(exe, inputs=inputs)
    return captured["ctxs"]


def _prove(flags, exe, inputs):
    """The port's keygen and CPU prove in the config: (vm, proof, preflight,
    contexts)."""
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, **flags), device="cpu")
    vm.keygen()
    record = {}
    proof, pre = vm.prove(exe, inputs=inputs, record=record)
    return vm, proof, pre, record["ctxs"]


def _jax_vm(flags):
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(stark=JAX_TEST_STARK, **flags))
    jvm.keygen(cache=False)
    return jvm


def _jax_accepts(jvm, jexe, blob):
    jproof = jcodec.decode_proof(blob)
    jstark.verify(jvm.pk.vk, jproof)
    return jvm.verify(jproof, expected_exe_commit=jvm.commit_exe(jexe))


@pytest.fixture(scope="module")
def case():
    """Both packages' VMs of path 8's config (the JAX package's keygen for
    its verifier); the port's proof, preflight and contexts of the
    one-signature ecrecover guest."""
    exe = guest.build_ecrecover_program(N)
    vm, proof, pre, ctxs = _prove(FLAGS, exe, guest.ecrecover_stream(N))
    return {"jax_vm": _jax_vm(FLAGS), "vm": vm, "exe": exe, "proof": proof, "pre": pre,
            "ctxs": ctxs, "jexe": jax_exe(guest.ecrecover_asm(N)[0]),
            "blob": codec.encode_proof(proof)}


def test_ecrecover_contexts_equal_and_jax_verifier_accepts(case):
    """Every AIR's trace and public values equal the JAX package's, F4's
    rows repaired (ECRECOVER_CONTEXTS_SHA256; the verifying keys'
    pre-hashes live), every chip of the config but modular_iseq_1 has
    rows, and the JAX package's verifier accepts the port's proof, whose
    public values are the guest's reference."""
    vm, jvm = case["vm"], case["jax_vm"]
    assert [a.name for a in vm.airs] == [a.name for a in jvm.airs]
    assert vm.pk.vk.pre_hash.tolist() == jvm.pk.vk.pre_hash.tolist()
    assert contexts_digest(case["ctxs"]) == ECRECOVER_CONTEXTS_SHA256
    rows = case["pre"].records
    assert {a.name for a in vm.airs[vm.NUM_SYSTEM_AIRS:]} - set(rows) == \
        {"range_tuple", "modular_iseq_1"}
    jresult = _jax_accepts(jvm, case["jexe"], case["blob"])
    result = vm.verify(case["proof"], expected_exe_commit=vm.commit_exe(case["exe"]),
                       exe=case["exe"])
    assert list(jresult["public_values"]) == list(result["public_values"]) \
        == guest.ecrecover_reference(N)


def test_check_constraints_catches_tampered_sw_double(case):
    """No failure on the good contexts; a changed sw_double_0 lambda limb
    fails a constraint of that AIR."""
    vm = case["vm"]
    assert check_constraints(vm.pk, case["ctxs"]) == []
    failures = check_constraints(vm.pk, _tampered(case["ctxs"], vm, "sw_double_0", "lam"),
                                 raise_on_error=False)
    assert failures and failures[0].startswith("air sw_double_0: constraint #"), failures


def test_jax_reproduces_pins():
    """The JAX package's contexts of the ecrecover guest, live (a JAX
    keygen, tracegen and histograms; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's contexts")
    jvm = _jax_vm(FLAGS)
    ctxs = _jax_contexts(jvm, jax_exe(guest.ecrecover_asm(N)[0]), guest.ecrecover_stream(N))
    assert contexts_digest(f4_repaired(jvm, ctxs)) == ECRECOVER_CONTEXTS_SHA256
