"""The port's STARK prover against openvm_tpu's: equal proof bytes.

One module-scoped fixture proves tests/test_torch_prover.py's three AIRs at
mixed heights with both packages under tests/test_stark_e2e.py's
TEST_CONFIG: FibonacciAir at 2^5, a second FibonacciAir at 2^3 and CubeAir
at 2^4 (one preprocessed column, one cached main partition, a degree-3
transition constraint, so log_quotient_degree 1: two quotient chunks and
next_step 2).  That covers every round kind of ``prove`` except the
after-challenge round, which needs interactions.  This file makes the only
JAX prove of the port's tests (about a minute of XLA:CPU compiles); the
port proves on the CPU with its plain versions.  The SHA-256 of that JAX
proof is pinned (``FIXTURE_PROOF_SHA256``) and checked on every run;
chip_smoke.py proves the same instance on the card and checks the same
hash.  This file keeps to a few test functions, so that ``--dist
loadfile`` queues it after tests/test_aggregation.py.
"""

import hashlib

import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.stark import codec as jcodec
from openvm_tpu_torch import stark
from openvm_tpu_torch.stark import codec

from test_stark_e2e import TEST_CONFIG, FibonacciAir as JaxFibonacciAir
from test_torch_prover import CONFIG, FIXTURE_PROOF_SHA256, FibonacciAir, contexts, cube_air

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def proofs():
    jpk = jstark.keygen([JaxFibonacciAir(), JaxFibonacciAir(),
                         cube_air(jstark.Air)(4)], TEST_CONFIG)
    jproof = jstark.prove(jpk, contexts(jstark.AirProvingContext))
    tpk = stark.keygen([FibonacciAir(), FibonacciAir(), cube_air(stark.Air)(4)],
                       CONFIG, device="cpu")
    tproof = stark.prove(tpk, contexts(stark.AirProvingContext), device="cpu")
    return jpk, jproof, tpk, tproof


def test_vk_pre_hash_equal(proofs):
    jpk, _, tpk, _ = proofs
    assert [v.log_quotient_degree for v in tpk.vk.per_air] == [0, 0, 1]
    assert jpk.vk.pre_hash.tolist() == tpk.vk.pre_hash.tolist()


def test_proof_bytes_equal(proofs):
    _, jproof, _, tproof = proofs
    assert codec.encode_proof(tproof) == jcodec.encode_proof(jproof)


def test_jax_verifier_accepts_port_proof(proofs):
    jpk, _, _, tproof = proofs
    jstark.verify(jpk.vk, jcodec.decode_proof(codec.encode_proof(tproof)))


def test_port_verifier_accepts_both_proofs(proofs):
    _, jproof, tpk, tproof = proofs
    stark.verify(tpk.vk, tproof)
    stark.verify(tpk.vk, codec.decode_proof(jcodec.encode_proof(jproof)))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_pinned_small_proof_hash(proofs, as_tensor):
    """The JAX proof has the pinned hash, and the port gives it from
    canonical numpy traces and from Montgomery tensors alike."""
    _, jproof, tpk, tproof = proofs
    if as_tensor:
        tproof = stark.prove(tpk, contexts(stark.AirProvingContext, as_tensor=True),
                             device="cpu")
    else:
        assert hashlib.sha256(jcodec.encode_proof(jproof)).hexdigest() == \
            FIXTURE_PROOF_SHA256
    assert hashlib.sha256(codec.encode_proof(tproof)).hexdigest() == \
        FIXTURE_PROOF_SHA256
