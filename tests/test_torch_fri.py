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


# K6 redesigned: the numpy job table and the kernel's indexing modelled on
# the CPU (merkle._gather_model: block and thread job searches, row groups,
# 16-byte units) against run_plain and JAX's gathers

def _flat(blocks):
    return np.concatenate([np.asarray(b, dtype=np.uint64).reshape(-1) for b in blocks])


def _model_equals_plain(plan, indices, threads=merkle.GATHER_THREADS):
    got = merkle._gather_model(plan, indices, threads)
    assert torch.equal(got, plan.run_plain(indices))
    return got.numpy().view(np.uint32)


@pytest.mark.parametrize("q", [1, 84])
def test_gather_model_equal_jax_gather_rows(q):
    rng = np.random.default_rng(5)
    shapes = ((32, 3), (8, 1), (32, 4), (16, 13), (32, 8), (4, 3))
    words = [_words(rng, h, w) for h, w in shapes]
    jtree = jm.commit([jnp.asarray(w) for w in words])
    ttree = merkle.commit([_t(w) for w in words])
    indices = rng.integers(0, 32, size=q).tolist()
    plan = merkle.GatherPlan()
    mats, sibs = plan.add_tree(ttree)
    want = jax.device_get(jm.gather_rows_device(jtree, indices))
    flat = _model_equals_plain(plan, indices)
    np.testing.assert_array_equal(flat, _flat(want["mats"] + want["sibs"]))
    for threads in (1, 4, 32):  # blocks across many jobs
        _model_equals_plain(plan, indices, threads)
    blocks = plan.run(indices)
    np.testing.assert_array_equal(_flat(blocks), flat)
    assert [b.shape for b in blocks] == [(q, w) for _, w in shapes] + [(q, 8)] * 5
    assert all(b.dtype == np.uint32 for b in blocks)


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


@pytest.mark.parametrize("q", [1, 84])
def test_gather_table_slices_flips_shifts(q):
    rng = np.random.default_rng(7)
    big = _t(_words(rng, 64, 20))
    plan = merkle.GatherPlan()
    plan.add(big, 0)                  # 16-byte units
    plan.add(big[:, 4:8], 1, 1)       # a slice, row stride 20 > width 4
    plan.add(big[:, 3:16], 2, 0)      # width 13, off a 16-byte boundary
    plan.add(big[:, 8:9], 0, 1)       # width 1
    plan.add(big[:, 0:0], 0)          # no output
    plan.add(big[:32, 1:4], 1, 1)     # width 3, half the rows
    plan.add(big[:, 12:20], 3, 1)     # width 8
    indices = rng.integers(0, 64, size=q).tolist()
    tab, first, block_job, idx, total = plan.table(indices)
    assert len(tab) == 6 and total == q * (20 + 4 + 13 + 1 + 3 + 8)
    # the width-8 job's output starts at word 41 q: 16 bytes only for q = 84
    vec8 = q % 4 == 0
    assert tab[:, merkle.GJ_VEC].tolist() == [4, 4, 1, 1, 1, 4 if vec8 else 1]
    assert tab[:, merkle.GJ_ROW_UNITS].tolist() == [5, 1, 13, 1, 3, 2 if vec8 else 8]
    assert tab[:, merkle.GJ_STRIDE].tolist() == [20] * 6
    assert first.tolist() == np.concatenate([[0], np.cumsum(
        q * tab[:, merkle.GJ_ROW_UNITS])]).tolist()
    assert tab[:, merkle.GJ_OUT].tolist() == (q * np.array(
        [0, 20, 24, 37, 38, 41])).tolist()
    assert idx.tolist() == indices
    starts = np.arange(0, first[-1], merkle.GATHER_THREADS)
    assert block_job.tolist() == [int(np.nonzero(first[:-1] <= g)[0][-1]) for g in starts]
    flat = _model_equals_plain(plan, indices)
    for threads in (1, 8):
        _model_equals_plain(plan, indices, threads)
    rows = [(big, 0, 0), (big[:, 4:8], 1, 1), (big[:, 3:16], 2, 0), (big[:, 8:9], 0, 1),
            (big[:, 0:0], 0, 0), (big[:32, 1:4], 1, 1), (big[:, 12:20], 3, 1)]
    want = [bb.canonical_np(m[(np.asarray(indices) >> s) ^ f]) for m, s, f in rows]
    np.testing.assert_array_equal(flat, _flat(want))
    with pytest.raises(ValueError, match="past"):
        plan.table([64])
    plan.add(big.long(), 0)
    with pytest.raises(ValueError, match="int32"):
        plan.table(indices)


def test_gather_model_more_jobs_than_a_block():
    rng = np.random.default_rng(8)
    mats = [_t(_words(rng, 16, w)) for w in (1, 3, 8)]
    plan = merkle.GatherPlan()
    for k in range(700):  # q = 1: a block of 256 one-word units spans 256 jobs
        plan.add(mats[k % 3 if k % 5 else 0], k % 4, k % 2)
    for indices in ([9], [3, 15, 0]):
        _model_equals_plain(plan, indices)
        _model_equals_plain(plan, indices, 16)
    assert [b.shape for b in plan.run([])] == [(0, int(m.shape[1])) for m, _, _ in plan.jobs]
