"""openvm_tpu_torch.fri's commit phase and the K6 gathers against
openvm_tpu's on small shapes: the commit phase's trees, betas, final
polynomial and folded evaluations, its refusal of a high-degree input in
both packages, the query gathers from its trees
(through ``gather_queries_device`` and through K6's modelled job table),
and the row gathers on mixed heights.  The JAX package's compiles take
about 20 s, so these tests have a file of their own, queued by ``--dist
loadfile`` after tests/test_aggregation.py; tests/test_torch_fri.py holds
the rest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvm_tpu import fri as jfri, merkle as jm
from openvm_tpu.challenger import DuplexChallenger as JaxChallenger
from openvm_tpu_torch import fri, merkle
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.field import babybear as bb

from test_torch_fri import LOG_BLOWUP, _flat, _model_equals_plain, _ro_polys, _t, _words

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def committed():
    polys = _ro_polys(2, low_degree=True)
    jch = JaxChallenger()
    jres = jfri.commit_phase({k: jnp.asarray(v) for k, v in polys.items()},
                             4, LOG_BLOWUP, jch)
    tch = DuplexChallenger()
    tres = fri.commit_phase({k: _t(v) for k, v in polys.items()},
                            4, LOG_BLOWUP, tch)
    return jres, tres, jch, tch


def test_commit_phase_equal_jax(committed):
    (jtrees, jbetas, jfinal, jevals), (ttrees, tbetas, tfinal, tevals), \
        jch, tch = committed
    assert [t.root.tolist() for t in jtrees] == [t.root.tolist() for t in ttrees]
    for a, b in zip(jbetas, tbetas):
        np.testing.assert_array_equal(np.asarray(a), bb.to_numpy(b))
    assert jfinal == tfinal
    assert len(jevals) == len(tevals) == 4 - LOG_BLOWUP
    for a, b in zip(jevals, tevals):
        np.testing.assert_array_equal(np.asarray(a), bb.to_numpy(b))
    assert jch.sample() == tch.sample()


def test_commit_phase_rejects_high_degree_in_both_packages():
    polys = _ro_polys(3, low_degree=False)
    with pytest.raises(AssertionError, match="not constant"):
        jfri.commit_phase({k: jnp.asarray(v) for k, v in polys.items()},
                          4, LOG_BLOWUP, JaxChallenger())
    with pytest.raises(AssertionError, match="not constant"):
        fri.commit_phase({k: _t(v) for k, v in polys.items()},
                         4, LOG_BLOWUP, DuplexChallenger())


def test_gather_queries_equal_jax(committed):
    (jtrees, _, _, jevals), (ttrees, _, _, tevals), _, _ = committed
    indices = [0, 15, 5, 9, 5]
    want = jfri.format_gathered_queries(jax.device_get(
        jfri.gather_queries_device(indices, jtrees, jevals)), len(indices))
    got = fri.format_gathered_queries(
        fri.gather_queries_device(indices, ttrees, tevals), len(indices))
    assert len(want) == len(got)
    for wq, gq in zip(want, got):
        assert [s.sibling_value for s in wq] == [s.sibling_value for s in gq]
        assert [[d.tolist() for d in s.opening_proof] for s in wq] == \
            [[d.tolist() for d in s.opening_proof] for s in gq]


def test_gather_rows_equal_jax_on_mixed_heights():
    rng = np.random.default_rng(4)
    words = [_words(rng, h, w) for h, w in ((16, 3), (4, 2), (16, 1), (8, 5))]
    jtree = jm.commit([jnp.asarray(w) for w in words])
    ttree = merkle.commit([_t(w) for w in words])
    indices = [3, 15, 0, 8, 3]
    want = jm.format_gathered_rows(
        jax.device_get(jm.gather_rows_device(jtree, indices)), len(indices))
    got = merkle.format_gathered_rows(
        merkle.gather_rows_device(ttree, indices), len(indices))
    for (wr, wp), (gr, gp) in zip(want, got):
        assert [r.tolist() for r in wr] == [r.tolist() for r in gr]
        assert [p.tolist() for p in wp] == [p.tolist() for p in gp]
    assert all(got[k][0][i].tolist() == merkle.open_row(ttree, idx)[0][i].tolist()
               for k, idx in enumerate(indices) for i in range(len(words)))


@pytest.mark.parametrize("q", [1, 84])
def test_gather_model_equal_jax_gather_queries(committed, q):
    (jtrees, _, _, jevals), (ttrees, _, _, tevals), _, _ = committed
    indices = np.random.default_rng(6).integers(0, 16, size=q).tolist()
    plan = merkle.GatherPlan()
    ids = fri.add_query_jobs(plan, ttrees, tevals)
    want = jax.device_get(jfri.gather_queries_device(indices, jtrees, jevals))
    flat = _model_equals_plain(plan, indices)
    order = []
    for lv in want:
        order += [lv["sibs"]] + list(lv["paths"]["sibs"])
    np.testing.assert_array_equal(flat, _flat(order))
    got = fri.collect_queries(plan.run(indices), ids)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["sibs"], np.asarray(w["sibs"]))
