"""openvm_tpu_torch.merkle's openings against openvm_tpu.merkle's: every
opened row and proof of a commit over mixed heights equal, and the host
verifiers agree, a tampered row refused by both.  The JAX package's
openings take about 5 s, so this test has a file of its own, queued by
``--dist loadfile`` after tests/test_aggregation.py;
tests/test_torch_merkle.py holds the commits."""

import numpy as np
import torch

from openvm_tpu import merkle as jm
from openvm_tpu_torch import merkle
from openvm_tpu_torch.field import babybear as bb

from test_torch_merkle import SHAPES, _mats

torch.set_num_threads(1)


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
