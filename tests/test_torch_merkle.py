"""openvm_tpu_torch.merkle against openvm_tpu.merkle: every digest layer,
opened row and proof equal; the host verifiers agree."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import merkle as jm, poseidon2 as jp2
from openvm_tpu_torch import merkle
from openvm_tpu_torch.field import babybear as bb

torch.set_num_threads(1)

# tests/test_bitcompat_fixtures.py:29-30
MERKLE_ROOT = [512692767, 1522905392, 880658602, 995090898,
               1116979930, 1561754655, 1474458837, 453321358]

# (height, width) lists: one matrix; several at one height; several heights
# given out of height order (input order must be kept).
SHAPES = {
    "single": [(8, 5)],
    "same_height": [(8, 3), (8, 9), (8, 1)],
    "mixed": [(4, 2), (16, 7), (8, 3), (16, 2), (2, 9), (4, 1)],
}


def _mats(shapes, seed):
    rng = np.random.default_rng(seed)
    words = [bb.to_monty_np(rng.integers(0, bb.P, size=s, dtype=np.uint64))
             for s in shapes]
    return ([jnp.asarray(w) for w in words],
            [bb.from_numpy(w, device="cpu") for w in words])


@pytest.mark.parametrize("case,seed", [("single", 0), ("same_height", 1),
                                       ("mixed", 2)])
def test_commit_layers_equal_jax(case, seed):
    jmats, tmats = _mats(SHAPES[case], seed)
    want = jm.commit_layers(jmats)
    got = merkle.commit_layers(tmats)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), bb.to_numpy(b))


@pytest.mark.parametrize("inject", [False, True])
def test_compress_layer_equals_jax_compress_pairs(inject):
    (jprev, jinj), (tprev, tinj) = _mats([(8, 8), (4, 8)], 3)
    want = jp2.compress_pairs(jprev[0::2], jprev[1::2])
    if inject:
        want = jp2.compress_pairs(want, jinj)
    got = merkle.compress_layer(tprev, tinj if inject else None)
    np.testing.assert_array_equal(np.asarray(want), bb.to_numpy(got))


def test_open_row_and_verify_equal_jax():
    shapes = SHAPES["mixed"]
    jmats, tmats = _mats(shapes, 4)
    jtree, ttree = jm.commit(jmats), merkle.commit(tmats)
    np.testing.assert_array_equal(jtree.root, ttree.root)
    dims = list(shapes)
    indices = [0, 5, 15, 10]
    rows_q, proofs_q = [], []
    for index in indices:
        (jrows, jproof), (trows, tproof) = (jm.open_row(jtree, index),
                                            merkle.open_row(ttree, index))
        for a, b in zip(jrows + jproof, trows + tproof):
            np.testing.assert_array_equal(a, b)
            assert b.dtype == np.uint64
        assert merkle.verify_batch(ttree.root, dims, index, trows, tproof)
        rows_q.append(trows)
        proofs_q.append(tproof)
        tampered = [r.copy() for r in trows]
        tampered[2][1] = (tampered[2][1] + 1) % bb.P
        assert not merkle.verify_batch(ttree.root, dims, index, tampered, tproof)
        assert not jm.verify_batch(ttree.root, dims, index, tampered, tproof)
    rows_by_mat = [np.stack([r[k] for r in rows_q]) for k in range(len(shapes))]
    sibs_by_level = [np.stack([p[k] for p in proofs_q])
                     for k in range(len(proofs_q[0]))]
    ok = merkle.verify_batch_queries(ttree.root, dims, indices, rows_by_mat,
                                     sibs_by_level)
    assert ok.tolist() == [True] * len(indices)
    sibs_by_level[1][2, 0] ^= 1
    ok = merkle.verify_batch_queries(ttree.root, dims, indices, rows_by_mat,
                                     sibs_by_level)
    assert ok.tolist() == [True, True, False, True]


def test_pinned_merkle_root():
    tr = bb.monty((np.arange(8 * 4).reshape(8, 4) * 11 + 1) % bb.P, device="cpu")
    root = bb.canonical_np(merkle.commit_layers([tr])[-1][0])
    assert root.tolist() == MERKLE_ROOT
    assert merkle.commit([tr]).root.tolist() == MERKLE_ROOT


def test_commit_rejects_bad_heights():
    with pytest.raises(ValueError):
        merkle.commit_layers([torch.zeros((6, 2), dtype=torch.int32)])
    with pytest.raises(ValueError):
        merkle.commit_layers([])


def test_commit_plan():
    """Layers of more than tail_max digests one launch each, the rest in
    one tail launch; path 3's trees at the default TAIL_MAX take at most
    120 compress launches."""
    assert merkle.commit_plan(32, 4) == ([16, 8], [4, 2, 1])
    assert merkle.commit_plan(2, 8) == ([], [1])
    assert merkle.commit_plan(1, 8) == ([], [])
    assert merkle.commit_plan(8, 512) == ([], [4, 2, 1])
    with pytest.raises(ValueError):
        merkle.commit_plan(8, 3)
    # main, permutation and quotient trees of 2^21 leaves, FRI trees of
    # 2^20 down to 2^1 leaves
    trees = [1 << 21] * 3 + [1 << k for k in range(1, 21)]
    launches = 0
    for h in trees:
        single, tail = merkle.commit_plan(h, merkle.TAIL_MAX)
        launches += len(single) + (1 if tail else 0)
    assert launches <= 120


@pytest.mark.parametrize("tail_max", [2, 4, 8])
def test_commit_with_tail_equals_plain_and_jax(tail_max):
    """Injections at heights inside and above the tail: the planned commit
    (layers one by one, then the tail) equals the layer-by-layer plain
    commit and JAX's commit_layers."""
    shapes = [(32, 3), (8, 2), (16, 1), (4, 5), (2, 1), (1, 4), (8, 3)]
    jmats, tmats = _mats(shapes, 5 + tail_max)
    want = jm.commit_layers(jmats)
    got = merkle.commit_layers(tmats, tail_max=tail_max)
    plain = merkle.commit_layers_plain(tmats)
    assert len(got) == len(want) == len(plain) == 6
    for a, b, c in zip(want, got, plain):
        np.testing.assert_array_equal(np.asarray(a), bb.to_numpy(b))
        np.testing.assert_array_equal(bb.to_numpy(c), bb.to_numpy(b))
    tail = merkle.compress_tail(got[-tail_max.bit_length() - 1],
                                [None] * tail_max.bit_length())
    assert [t.shape[0] for t in tail] == [tail_max >> k for k in range(tail_max.bit_length())]
