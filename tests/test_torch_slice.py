"""The trace-commitment slice end to end, openvm_tpu_torch against openvm_tpu.

Traces of mixed heights -> Montgomery form -> coset LDEs batched by height
(as stark/prover.py:144 does) -> Merkle commit -> Fiat-Shamir: observe the
root, sample query indices -> open the rows -> verify on the host.  Root,
indices, opened rows and proofs must be equal to the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import merkle as jm, ntt as jntt
from openvm_tpu.challenger import DuplexChallenger as JaxChallenger
from openvm_tpu.field import babybear as jbb
from openvm_tpu.stark import config as jconfig
from openvm_tpu_torch import merkle, ntt
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import config

torch.set_num_threads(1)

# (log height, width): a segment's shape, shrunk: two matrices at the top
# height, two below it, and narrow lookup tables further down.
SHAPES = [(5, 9), (5, 11), (4, 5), (4, 7), (3, 4), (2, 1), (1, 2)]
LOG_BLOWUP = 1
NUM_QUERIES = 6


def _traces(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, bb.P, size=(1 << lh, w), dtype=np.uint64)
            for lh, w in SHAPES]


def _jax_slice(traces):
    mats = [jbb.to_monty(jnp.asarray(t.astype(np.uint32))) for t in traces]
    by_h: dict = {}
    for k, m in enumerate(mats):
        by_h.setdefault(m.shape[0], []).append(k)
    ldes = [None] * len(mats)
    for idxs in by_h.values():
        y = jntt.coset_lde(jnp.concatenate([mats[k] for k in idxs], axis=1),
                           LOG_BLOWUP)
        off = 0
        for k in idxs:
            ldes[k] = y[:, off:off + mats[k].shape[1]]
            off += mats[k].shape[1]
    tree = jm.commit(ldes)
    ch = JaxChallenger()
    ch.observe_slice(tree.root)
    log_max = tree.max_height().bit_length() - 1
    indices = [ch.sample_bits(log_max) for _ in range(NUM_QUERIES)]
    return tree, indices, [jm.open_row(tree, i) for i in indices]


def _port_slice(traces):
    mats = [bb.monty(t, device="cpu") for t in traces]
    tree = merkle.commit(ntt.batched_coset_ldes(mats, LOG_BLOWUP))
    ch = DuplexChallenger()
    ch.observe_slice(tree.root)
    log_max = tree.max_height().bit_length() - 1
    indices = [ch.sample_bits(log_max) for _ in range(NUM_QUERIES)]
    return tree, indices, [merkle.open_row(tree, i) for i in indices]


def test_slice_equals_jax_and_verifies():
    traces = _traces(7)
    jtree, jidx, jopen = _jax_slice(traces)
    ttree, tidx, topen = _port_slice(traces)
    np.testing.assert_array_equal(ttree.root, jtree.root)
    for a, b in zip(jtree.digest_layers, ttree.digest_layers):
        np.testing.assert_array_equal(np.asarray(a), bb.to_numpy(b))
    assert tidx == jidx
    for (jrows, jproof), (trows, tproof) in zip(jopen, topen):
        for a, b in zip(jrows + jproof, trows + tproof):
            np.testing.assert_array_equal(a, b)

    dims = [(int(m.shape[0]), int(m.shape[1])) for m in ttree.matrices]
    assert dims == [(1 << (lh + LOG_BLOWUP), w) for lh, w in SHAPES]
    rows_by_mat = [np.stack([rows[k] for rows, _ in topen])
                   for k in range(len(dims))]
    sibs = [np.stack([proof[k] for _, proof in topen])
            for k in range(len(topen[0][1]))]
    assert merkle.verify_batch_queries(ttree.root, dims, tidx, rows_by_mat,
                                       sibs).all()
    for i, (rows, proof) in zip(tidx, topen):
        assert merkle.verify_batch(ttree.root, dims, i, rows, proof)
    rows_by_mat[4][3, 0] = (rows_by_mat[4][3, 0] + 1) % bb.P  # one word
    ok = merkle.verify_batch_queries(ttree.root, dims, tidx, rows_by_mat, sibs)
    assert ok.tolist() == [k != 3 for k in range(NUM_QUERIES)]


def test_challenger_vectors_and_jax_parity():
    # tests/test_bitcompat_fixtures.py:70-78
    ch = DuplexChallenger()
    ch.observe_slice(list(range(8)))
    assert [ch.sample() for _ in range(3)] == [536986157, 1951342121, 635888807]
    assert ch.sample_bits(20) == 870614
    ch2 = DuplexChallenger()
    ch2.observe_ext((1, 2, 3, 4))
    assert ch2.sample_ext() == (1548460626, 39002199, 1146611958, 137492534)

    ours, theirs = DuplexChallenger(), JaxChallenger()
    for c in (ours, theirs):
        c.observe_slice(np.arange(11, dtype=np.uint64) * 12345)
    assert ours.grind(6) == theirs.grind(6)
    clone = ours.clone()
    seq = [ours.sample_bits(13) for _ in range(9)]
    assert seq == [theirs.sample_bits(13) for _ in range(9)]
    assert [clone.sample_bits(13) for _ in range(9)] == seq


@pytest.mark.parametrize("log_blowup", [1, 2, 3])
def test_fri_parameters_equal_jax(log_blowup):
    ours = config.FriParameters.standard_with_100_bits_conjectured_security(log_blowup)
    theirs = jconfig.FriParameters.standard_with_100_bits_conjectured_security(log_blowup)
    assert (ours.log_blowup, ours.num_queries, ours.proof_of_work_bits,
            ours.max_log_trace_height) == \
        (theirs.log_blowup, theirs.num_queries, theirs.proof_of_work_bits,
         theirs.max_log_trace_height)
    assert config.StarkConfig() == config.baby_bear_poseidon2_config()
