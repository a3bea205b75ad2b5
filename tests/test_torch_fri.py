"""openvm_tpu_torch.fri (K14's plain version, the commit phase, the K6
gathers) against openvm_tpu.fri on small shapes."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from openvm_tpu import fri as jfri, merkle as jm, ntt as jntt
from openvm_tpu.challenger import DuplexChallenger as JaxChallenger
from openvm_tpu.field import babybear as jbb
from openvm_tpu.field import ext as jef
from openvm_tpu_torch import fri, merkle
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.field import babybear as bb

torch.set_num_threads(1)

P = bb.P
LOG_BLOWUP = 1


def _words(rng, *shape):
    return bb.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64))


def _t(a):
    return bb.from_numpy(a, device="cpu")


@pytest.mark.parametrize("log_h", [1, 2, 3, 6])
def test_fold_xs_equal_jax(log_h):
    np.testing.assert_array_equal(jfri._fold_xs(log_h), fri._fold_xs(log_h))


@pytest.mark.parametrize("with_ro", [False, True])
def test_fold_evals_equal_jax(with_ro):
    rng = np.random.default_rng(1)
    evals, beta, ro = _words(rng, 16, 4), _words(rng, 4), _words(rng, 8, 4)
    want = jfri.fold_evals(jnp.asarray(evals), jnp.asarray(beta))
    if with_ro:
        jb = jnp.asarray(beta)
        want = jef.add(want, jef.mul(jnp.broadcast_to(jef.mul(jb, jb), (8, 4)),
                                     jnp.asarray(ro)))
    got = fri.fold_evals(_t(evals), _t(beta), _t(ro) if with_ro else None)
    np.testing.assert_array_equal(np.asarray(want), bb.to_numpy(got))


def _ro_polys(seed, low_degree):
    """{4: (16, 4), 3: (8, 4)}: bit-reversed coset LDEs (log_blowup 1) of
    random columns, or random values when not ``low_degree``."""
    rng = np.random.default_rng(seed)
    out = {}
    for log_lde in (4, 3):
        if low_degree:
            cols = jbb.to_monty(jnp.asarray(rng.integers(
                0, P, size=(1 << (log_lde - LOG_BLOWUP), 4), dtype=np.uint64)
                .astype(np.uint32)))
            out[log_lde] = np.array(jntt.coset_lde(cols, LOG_BLOWUP))
        else:
            out[log_lde] = _words(rng, 1 << log_lde, 4)
    return out


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
