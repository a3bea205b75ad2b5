"""The port's VM proofs of the Fp2 guest and the pairing-hint guest on the
CPU against openvm_tpu's: contexts, the JAX package's verifier, and the
constraint checker.

One config, the JAX package's Fp2 test config (tests/test_vm_fp2.py:80-85):
the executors alu, loadstore and hintstore with the Fp2 chips of BN254's
prime.  The port proves ``build_fp2_program()`` (an Fp2 add, mul, div and
sub) and ``build_pairing_hint_program()`` (two BN254 pairs through
HINT_BUFFER, the HintFinalExp phantom and its 192 words read back) on the
CPU with its plain versions.  Every AIR's context equals the JAX
package's (its STARK prove stopped, pinned by SHA-256 and recomputed live
under ``OPENVM_SLOW``), the hint guest's after F4's repair of its
HINT_BUFFER rows (ROADMAP.md), and the JAX package's verifier accepts both
proofs.  The hint guest makes no Fp2 call, so its proof also answers F3
for the Fp2 chips: their one zero row each passes the checker and the
verifiers.  The port's checker catches one changed fp2_muldiv_0 cell.
Like tests/test_torch_ecc_vm.py, this file keeps to a few test
functions, so that ``--dist loadfile`` queues it after
tests/test_aggregation.py.
"""

import os

import pytest
import torch

from openvm_tpu_torch.pairing import BN254, final_exp_hint, multi_miller_loop
from openvm_tpu_torch.stark import codec
from openvm_tpu_torch.stark.debug import check_constraints
from openvm_tpu_torch.vm import guest

from test_pairing import build_pairing_hint_program as jax_build_pairing_hint_program
from test_torch_bigint_vm import _tampered, contexts_digest
from test_torch_ecc_vm import _jax_accepts, _jax_contexts, _jax_vm, _prove, f4_repaired
from test_vm_fp2 import build_fp2_program as jax_build_fp2_program

torch.set_num_threads(1)

FLAGS = dict(executors=("alu", "loadstore", "hintstore"), fp2=(guest.BN254_P,))
# The JAX package's proving contexts (``contexts_digest``, the hint
# guest's after ``f4_repaired``) of the two guests in FLAGS' config, its
# STARK prove stopped (a JAX keygen and tracegen, recomputed under
# OPENVM_SLOW).
FP2_CONTEXTS_SHA256 = "eb6ad3a15d79d6b724b8eea12f8dba3218c066680d341e3583aa2e67a6aaa038"
PAIRING_HINT_CONTEXTS_SHA256 = \
    "37cefa31ccaa4252dba7bc2035d352c54d3dfdfa9b29db8dcb543b9406286df5"
GUESTS = {
    "fp2": (guest.build_fp2_program, jax_build_fp2_program, guest.fp2_hint_input),
    "pairing_hint": (guest.build_pairing_hint_program, jax_build_pairing_hint_program,
                     guest.pairing_hint_stream),
}


@pytest.fixture(scope="module")
def case():
    """The JAX package's VM of the config (its keygen, for its verifier),
    and the port's proof, preflight and contexts of each guest, proved by
    one port VM."""
    out = {"jax_vm": _jax_vm(FLAGS)}
    vm = None
    for name, (build, jbuild, inputs) in GUESTS.items():
        exe = build()
        if vm is None:
            vm, proof, pre, ctxs = _prove(FLAGS, exe, inputs())
        else:
            record = {}
            proof, pre = vm.prove(exe, inputs=inputs(), record=record)
            ctxs = record["ctxs"]
        out[name] = {"exe": exe, "jexe": jbuild(), "proof": proof, "pre": pre, "ctxs": ctxs,
                     "blob": codec.encode_proof(proof)}
    out["vm"] = vm
    return out


@pytest.mark.parametrize("name,pin", [("fp2", FP2_CONTEXTS_SHA256),
                                      ("pairing_hint", PAIRING_HINT_CONTEXTS_SHA256)],
                         ids=["fp2", "pairing_hint"])
def test_contexts_equal_and_jax_verifier_accepts(case, name, pin):
    """Every AIR's trace and public values equal the JAX package's (the
    pin; the verifying keys' pre-hashes live), and the JAX package's
    verifier accepts the port's proof, whose public values are the
    guest's: the Fp2 guest's c = a, the hint guest's first word of c.
    The hint guest's Fp2 chips keep one zero row (F3: they pass)."""
    vm, jvm, run = case["vm"], case["jax_vm"], case[name]
    assert [a.name for a in vm.airs] == [a.name for a in jvm.airs]
    assert vm.pk.vk.pre_hash.tolist() == jvm.pk.vk.pre_hash.tolist()
    assert contexts_digest(run["ctxs"]) == pin
    jresult = _jax_accepts(jvm, run["jexe"], run["blob"])
    result = vm.verify(run["proof"], expected_exe_commit=vm.commit_exe(run["exe"]),
                       exe=run["exe"])
    pvs = list(result["public_values"])
    assert list(jresult["public_values"]) == pvs
    fp2_rows = {a: run["pre"].records.get(a) for a in ("fp2_addsub_0", "fp2_muldiv_0")}
    if name == "fp2":
        assert pvs[:4] == list(guest.FP2_A0.to_bytes(32, "little")[:4])
        assert all(len(r["pc"]) == 2 for r in fp2_rows.values())
        return
    assert not any(fp2_rows.values())
    heights = {vm.airs[c.air_id].name: int(c.common_main.shape[0]) for c in run["ctxs"]}
    assert heights["fp2_addsub_0"] == heights["fp2_muldiv_0"] == 1
    cv = BN254
    c, _ = final_exp_hint(cv, multi_miller_loop(cv, [cv.g1, guest.g1_neg(cv.g1)],
                                                [cv.g2, cv.g2]))
    assert pvs[:4] == list(cv.tower.f12_to_bytes(c, 32)[:4])


def test_check_constraints_catches_tampered_fp2(case):
    """No failure on either guest's contexts (the hint guest's unused Fp2
    chips included); a changed fp2_muldiv_0 result limb fails a
    constraint of that AIR."""
    vm = case["vm"]
    for name in GUESTS:
        assert check_constraints(vm.pk, case[name]["ctxs"]) == []
    failures = check_constraints(vm.pk, _tampered(case["fp2"]["ctxs"], vm, "fp2_muldiv_0", "z"),
                                 raise_on_error=False)
    assert failures and failures[0].startswith("air fp2_muldiv_0: constraint #"), failures


def test_jax_reproduces_pins():
    """The JAX package's contexts of the two guests, live (a JAX keygen,
    tracegen and histograms; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's contexts")
    jvm = _jax_vm(FLAGS)
    for name, pin in (("fp2", FP2_CONTEXTS_SHA256),
                      ("pairing_hint", PAIRING_HINT_CONTEXTS_SHA256)):
        _, jbuild, inputs = GUESTS[name]
        ctxs = _jax_contexts(jvm, jbuild(), inputs())
        assert contexts_digest(f4_repaired(jvm, ctxs)) == pin, name
