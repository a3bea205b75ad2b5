"""K13's plain version (the reduced openings) against the JAX package's loop
on small shapes.  The eager JAX calls take about 20 s, so this test has a
file of its own, queued by ``--dist loadfile`` after
tests/test_aggregation.py; tests/test_torch_reduced_open.py holds the rest
of K13 and K14."""

import jax.numpy as jnp
import numpy as np
import torch

from openvm_tpu.field import babybear as jbb
from openvm_tpu.field import ext as jef
from openvm_tpu.stark.prover import _col_comb as jax_col_comb
from openvm_tpu.stark.prover import _lde_points as jax_lde_points
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import prover as pv

from test_torch_reduced_open import _committed, _ext, _monty

torch.set_num_threads(1)


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
