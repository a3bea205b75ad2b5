"""The port's VM proofs of the full RV32IM opcode mix and of an ECC guest
on the CPU against openvm_tpu's.

The full-opcode guest of tests/test_vm_full_ops.py (shift, mul, mulh, div,
rem, a division by zero, a hinted word) is proved in the default config
(every RV32IM chip and the range-tuple table): every AIR's context equals
the JAX package's (its STARK prove stopped, pinned by SHA-256 and
recomputed live under ``OPENVM_SLOW``) and the JAX package's verifier
accepts the port's proof.  The port's CPU proof of tests/test_vm_ecc.py's
guest (2G and 3G in a config of the curve alone) has the bytes of the JAX
package's (pinned by SHA-256, compared live under ``OPENVM_SLOW``).  Apart
from tests/test_torch_ecc_vm.py, so that the two files' CPU proves run on
two workers; each keeps to a few test functions, so that ``--dist
loadfile`` queues it after tests/test_aggregation.py.
"""

import hashlib
import os

import pytest
import torch

from openvm_tpu.stark import codec as jcodec
from openvm_tpu_torch.stark import codec
from openvm_tpu_torch.vm import guest

from test_torch_bigint_vm import contexts_digest
from test_torch_ecc_vm import _jax_accepts, _jax_contexts, _jax_vm, _prove
from test_torch_keccak_vm import canonical
from test_vm_ecc import build_ecc_program as jax_build_ecc_program
from test_vm_full_ops import build_full_ops_program as jax_build_full_ops_program

torch.set_num_threads(1)

# The JAX package's proving contexts (``contexts_digest``) of the
# full-opcode guest in the default config, its STARK prove stopped.
FULL_OPS_CONTEXTS_SHA256 = "180f6a8cd8a4894698ad5a53d2b71fc672867c3600693d57b62cd5e7e0516f1e"
# tests/test_vm_ecc.py's config: the curve alone beside alu, loadstore and
# hintstore; the JAX package's proof of its guest under TEST_STARK (176,825
# bytes; its CPU prove took 1,266 s and 8.9 GB when this was pinned).
ECC_FLAGS = dict(executors=("alu", "loadstore", "hintstore"), curves=(guest.SECP256K1_CURVE,))
ECC_PROOF_SHA256 = "d15d45454c928f17d169a215a3dce1e328c1a117c82c6a5bb3e58855879709cd"


def test_full_ops_proof_jax_verifier_accepts():
    """The full-opcode guest in the default config: contexts equal the
    JAX package's (FULL_OPS_CONTEXTS_SHA256, range_tuple's multiplicities
    of the mul and divrem sends among them), and its verifier accepts the
    port's proof (the mul result and the hinted word revealed)."""
    exe = guest.build_full_ops_program()
    vm, proof, pre, ctxs = _prove({}, exe, guest.FULL_OPS_INPUTS)
    assert {"rv32_shift", "rv32_mul", "rv32_div_rem", "rv32_hint_store"} <= set(pre.records)
    assert contexts_digest(ctxs) == FULL_OPS_CONTEXTS_SHA256
    tuple_mult = canonical(next(c.common_main for c in ctxs
                                if c.air_id == vm.air_index["range_tuple"]))
    assert int(tuple_mult.sum()) > 0
    jvm = _jax_vm({})
    jresult = _jax_accepts(jvm, jax_build_full_ops_program(), codec.encode_proof(proof))
    pvs = list(jresult["public_values"])
    assert pvs[:8] == list((0x355 * 7).to_bytes(4, "little")) + guest.FULL_OPS_INPUTS[0]


def test_ecc_proof_equals_jax_pin():
    """2G by EC_DOUBLE and 3G by EC_ADD_NE: the port's CPU proof has the
    bytes of the JAX package's prove of the same guest (ECC_PROOF_SHA256)."""
    _, proof, pre, _ = _prove(ECC_FLAGS, guest.build_ecc_program(), guest.ecc_inputs())
    assert len(pre.records["sw_add_ne_0"]["pc"]) == len(pre.records["sw_double_0"]["pc"]) == 1
    assert hashlib.sha256(codec.encode_proof(proof)).hexdigest() == ECC_PROOF_SHA256


def test_jax_reproduces_pins():
    """The JAX package's contexts of the full-opcode guest and its prove of
    tests/test_vm_ecc.py's guest, live (about 25 minutes and 9 GB of
    XLA:CPU compiles; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's contexts and prove")
    jvm = _jax_vm({})
    ctxs = _jax_contexts(jvm, jax_build_full_ops_program(), guest.FULL_OPS_INPUTS)
    assert contexts_digest(ctxs) == FULL_OPS_CONTEXTS_SHA256
    jvm = _jax_vm(ECC_FLAGS)
    jproof, _ = jvm.prove(jax_build_ecc_program(), inputs=guest.ecc_inputs())
    assert hashlib.sha256(jcodec.encode_proof(jproof)).hexdigest() == ECC_PROOF_SHA256
