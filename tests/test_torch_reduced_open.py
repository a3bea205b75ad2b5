"""K13 (the reduced openings) and K14 (the FRI fold) of openvm_tpu_torch
against openvm_tpu on small shapes: the plain versions against the JAX
package's computation, the CPU models of the kernels' own regrouping,
batching and on-card points against the plain versions.  Integer
arithmetic: every comparison is exact equality of Montgomery words."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import fri as jfri
from openvm_tpu.field import babybear as jbb
from openvm_tpu.field import ext as jef
from openvm_tpu.stark.prover import _col_comb as jax_col_comb
from openvm_tpu.stark.prover import _lde_points as jax_lde_points
from openvm_tpu_torch import fri, ntt
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import prover as pv

torch.set_num_threads(1)

P = bb.P


def _words(rng, *shape):
    return bb.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64))


def _t(a):
    return bb.from_numpy(a, device="cpu")


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, size=4))


def _monty(canonical):
    return jbb.to_monty(jnp.asarray(np.asarray(canonical, dtype=np.uint64).astype(np.uint32)))


def _committed(rng):
    """Matrices in round order at heights 2^2, 2^4 and 2^6, 1 to 4 a height,
    widths 1, 3, 8 and 45 (a column slice among them): trace matrices
    opened at two points, quotient-like ones at one, each with random
    opened values; (LDE tensor, points, opened) as the prover keeps them."""
    mats = []
    for log_h, widths in ((4, (3, 45)), (2, (1,)), (6, (8, 3, 1, 45)), (4, (8,))):
        zeta = _ext(rng)
        for k, w in enumerate(widths):
            lde = _t(_words(rng, 1 << log_h, w + 2))[:, 1:1 + w] if k == 1 else \
                _t(_words(rng, 1 << log_h, w))
            points = [zeta] if w == 8 else [zeta, (_ext(rng)[0], 0, 0, 0)]
            mats.append((lde, points, [rng.integers(0, P, size=(w, 4), dtype=np.uint64)
                                       for _ in points]))
    return mats


def test_reduced_open_plain_equals_reference():
    """``reduced_open_jobs`` + ``reduced_open_many_plain`` against the JAX
    package's loop (openvm_tpu/stark/prover.py:773-792), written here the
    way it is there: alpha_pow advanced by alpha^w per (matrix, point) in
    round order within each height, JAX ``_col_comb``, ef.sub/mul/inv over
    ``_lde_points``."""
    rng = np.random.default_rng(11)
    mats = _committed(rng)
    alpha = _ext(rng)
    got = pv.reduced_open_many_plain(pv.reduced_open_jobs(mats, alpha), alpha)

    max_w = max(int(lde.shape[1]) for lde, _, _ in mats)
    apows = [jef.ones(())]
    for _ in range(max_w):
        apows.append(jef.mul(apows[-1], _monty(alpha)))
    apows = jnp.stack(apows)
    ro, ro_alpha_pow = {}, {}
    for lde, points, opened in mats:
        h, w = (int(v) for v in lde.shape)
        lh = h.bit_length() - 1
        if lh not in ro:
            ro[lh] = jef.zeros((h,))
            ro_alpha_pow[lh] = jef.ones(())
        col_comb = jax_col_comb(jnp.asarray(bb.to_numpy(lde.contiguous())), apows)
        xs = jnp.asarray(jax_lde_points(lh, jbb.GENERATOR))
        for z, op in zip(points, opened):
            p_at_z = jef.dot(_monty(op), apows[:w], axis=0)
            num = jef.sub(jnp.broadcast_to(p_at_z, (h, 4)), col_comb)
            zmx = jef.sub(jnp.broadcast_to(_monty(z), (h, 4)), jef.from_base(xs))
            contrib = jef.mul(jnp.broadcast_to(ro_alpha_pow[lh], (h, 4)),
                              jef.mul(num, jef.inv(zmx)))
            ro[lh] = jef.add(ro[lh], contrib)
            ro_alpha_pow[lh] = jef.mul(ro_alpha_pow[lh], apows[w])
    assert sorted(got) == sorted(ro)
    for lh, want in ro.items():
        np.testing.assert_array_equal(np.asarray(want), bb.to_numpy(got[lh]))


def _model_jobs(rng):
    """Jobs over heights 2^1 to 2^6 with up to 4 distinct points a height,
    rows of 16-byte units (widths 4, 8, 32 and 36, a strided slice among
    them) and of words, and at height 2^3 a point equal to the LDE point
    of row 5: z - x = 0 there, and the term contributes 0; at height 2^1 a
    matrix opened twice at one point, as a one-row trace is at zeta and
    zeta g_1 = zeta."""
    jobs = []
    x5 = bb.from_monty_int(int(ntt.lde_points_np(3)[5]))
    for log_h, widths in ((1, (2, 4)), (3, (36, 1, 8)), (6, (45, 4)), (2, (32,)),
                          (5, (3, 8, 5, 36)), (4, (1,))):
        zs = [_ext(rng) for _ in range(1 + log_h % 4)]
        if log_h == 3:
            zs[0] = (x5, 0, 0, 0)
        for k, w in enumerate(widths):
            if k == 1 and w % 4 == 0:
                m = _t(_words(rng, 1 << log_h, w + 8))[:, 4:4 + w]
            elif k == 2:
                m = _t(_words(rng, 1 << log_h, w + 1))[:, 1:]
            else:
                m = _t(_words(rng, 1 << log_h, w))
            pick = sorted({k % len(zs), (k + 1) % len(zs)} if k % 2 == 0 else {k % len(zs)})
            jobs.append((m, [(zs[q], _ext(rng), _ext(rng)) for q in pick]))
        if log_h == 1:
            jobs.append((_t(_words(rng, 2, 5)), [(zs[0], _ext(rng), _ext(rng))
                                                 for _ in range(2)]))
    return jobs, _ext(rng)


@pytest.mark.parametrize("threads,rows,cols,root_bits",
                         [(2, 1, 4, 1), (4, 2, 32, 3), (8, 2, 5, 10), (128, 2, 32, 10)])
def test_reduced_open_model_equals_plain(threads, rows, cols, root_bits):
    """K13's launch modelled on the CPU (``pv._reduced_open_model``: blocks
    of threads * rows rows by the height table, columns staged ``cols`` at
    a time, s_p per distinct point, x from A(hi) B(lo), one batch inverse a
    thread skipping the zero denominator) equals the plain version, tile
    by tile smaller and larger than the heights."""
    rng = np.random.default_rng(threads + cols)
    jobs, alpha = _model_jobs(rng)
    want = pv.reduced_open_many_plain(jobs, alpha)
    got = pv._reduced_open_model(jobs, alpha, threads, rows, cols, root_bits)
    assert sorted(got) == sorted(want)
    for lh in want:
        np.testing.assert_array_equal(got[lh].numpy(), want[lh].numpy())


def test_reduced_open_table_layout():
    """The job table: heights largest first, each a run of blocks of
    whole tiles from the first blocks on, its matrices consecutive with
    their points' mask, ro's row offsets laid end to end; more than
    RO_MAX_PTS distinct points at one height are refused."""
    rng = np.random.default_rng(5)
    jobs, alpha = _model_jobs(rng)
    heights, mats, consts, n_apow, total, out_off, n_out = pv._ro_table(
        jobs, alpha, list(range(len(jobs))), tile=8)
    logs = heights[:, pv.RH_LOG].tolist()
    assert logs == sorted(logs, reverse=True) == sorted(out_off, reverse=True)
    blocks = [-(-(1 << lh) // 8) for lh in logs]
    assert heights[:, pv.RH_BLOCK0].tolist() == np.cumsum([0] + blocks[:-1]).tolist()
    assert total == sum(blocks) and n_out == sum(1 << lh for lh in logs)
    assert [out_off[lh] for lh in logs] == np.cumsum([0] + [1 << lh for lh in logs][:-1]).tolist()
    assert heights[:, pv.RH_MAT0].tolist() == np.cumsum(
        [0] + heights[:-1, pv.RH_NMAT].tolist()).tolist()
    assert n_apow == max(int(m.shape[1]) for m, _ in jobs)
    for hj in heights:
        for mj in mats[hj[pv.RH_MAT0]:hj[pv.RH_MAT0] + hj[pv.RH_NMAT]]:
            m, pts = jobs[mj[pv.RM_PTR]]
            assert 1 << hj[pv.RH_LOG] == m.shape[0] and mj[pv.RM_W] == m.shape[1]
            assert bin(int(mj[pv.RM_MASK])).count("1") == len({z for z, _, _ in pts})
            assert mj[pv.RM_VEC] == (m.shape[1] % 4 == 0 and m.stride(0) % 4 == 0
                                     and m.data_ptr() % 16 == 0)
    crowded = [(jobs[0][0], [(_ext(rng), _ext(rng), _ext(rng))]) for _ in range(5)]
    with pytest.raises(ValueError, match="distinct points"):
        pv._ro_table(crowded, alpha, list(range(5)))


@pytest.mark.parametrize("root_bits", [3, 10])
def test_points_made_on_the_card_equal_tables(root_bits):
    """The A(hi) B(lo) split that K13 and K14 run (``ntt.rev_root_points``)
    gives the LDE points, the fold's y and 1/(-2y) of the host tables, at
    heights 2^1 to 2^14 (below and above the split's 2^root_bits)."""
    neg_half = P - pow(2, -1, P)
    for log_h in range(1, 15):
        rows = np.arange(1 << log_h)
        np.testing.assert_array_equal(
            bb.to_monty_np(ntt.rev_root_points(log_h, rows, bits=root_bits)
                           * bb.GENERATOR % P), ntt.lde_points_np(log_h))
        even = rows[0::2]
        np.testing.assert_array_equal(
            bb.to_monty_np(ntt.rev_root_points(log_h, even, bits=root_bits)),
            fri._fold_xs(log_h))
        np.testing.assert_array_equal(
            bb.to_monty_np(ntt.rev_root_points(log_h, even, inverse=True, bits=root_bits)
                           * neg_half % P), fri._inv_neg2y_np(log_h - 1))


@pytest.mark.parametrize("log_h", [1, 2, 5])
@pytest.mark.parametrize("with_ro", [False, True])
def test_fold_model_equals_jax(log_h, with_ro):
    """K14 modelled on the CPU (``fri._fold_model``: two outputs a thread,
    y and 1/(-2y) from the on-card split, the odd output's by w_4) equals
    JAX ``fold_evals`` (+ beta^2 ro)."""
    rng = np.random.default_rng(log_h)
    h = 1 << log_h
    evals, beta, ro = _words(rng, h, 4), _words(rng, 4), _words(rng, h // 2, 4)
    want = jfri.fold_evals(jnp.asarray(evals), jnp.asarray(beta))
    if with_ro:
        jb = jnp.asarray(beta)
        want = jef.add(want, jef.mul(jnp.broadcast_to(jef.mul(jb, jb), (h // 2, 4)),
                                     jnp.asarray(ro)))
    got = fri._fold_model(_t(evals), _t(beta), _t(ro) if with_ro else None)
    np.testing.assert_array_equal(np.asarray(want), bb.to_numpy(got))
