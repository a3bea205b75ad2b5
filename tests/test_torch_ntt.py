"""openvm_tpu_torch.ntt against openvm_tpu.ntt: raw words must be equal.

The JAX side runs on XLA:CPU; every distinct shape and static argument is
one compile there, so the cases are few and tiny.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import ntt as jntt
from openvm_tpu.field import babybear as jbb
from openvm_tpu_torch import ntt
from openvm_tpu_torch.field import babybear as bb

torch.set_num_threads(1)


def _inputs(log_n, w, seed):
    rng = np.random.default_rng(seed)
    canon = rng.integers(0, bb.P, size=(1 << log_n, w), dtype=np.uint64)
    words = bb.to_monty_np(canon)
    return jnp.asarray(words), bb.from_numpy(words, device="cpu")


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out, dtype=np.uint32),
                                  bb.to_numpy(torch_out))


@pytest.mark.parametrize("log_n,inverse", [(1, False), (6, True), (10, False),
                                           (10, True)])
def test_twiddle_table_matches_jax(log_n, inverse):
    np.testing.assert_array_equal(ntt._twiddle_table(log_n, inverse),
                                  jntt._twiddle_table(log_n, inverse))


@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_table_at_the_main_path_height(inverse):
    # The JAX table's per-element loop takes seconds at 2^21: spot-check.
    g = bb.two_adic_generator_int(21)
    if inverse:
        g = bb.inv_int(g)
    tab = ntt._twiddle_table(21, inverse)
    assert len(tab) == 1 << 20
    for i in (0, 1, 2, 12345, (1 << 19) + 7, len(tab) - 1):
        assert tab[i] == bb.to_monty_int(pow(g, i, bb.P))


@pytest.mark.parametrize("log_n,shift", [(0, 31), (5, 31), (9, 7 * pow(3, -1, bb.P) % bb.P)])
def test_shift_powers_match_jax(log_n, shift):
    np.testing.assert_array_equal(ntt._row_factors(log_n, shift, 1),
                                  np.asarray(jntt._shift_powers(log_n, shift)))


def test_bitrev_matches_jax():
    for log_n in (0, 1, 4, 9):
        np.testing.assert_array_equal(ntt.bitrev_perm(log_n),
                                      jntt.bitrev_perm(log_n))
    jx, tx = _inputs(4, 3, 0)
    _same(jntt.bitrev_rows(jx), ntt.bitrev_rows(tx))


@pytest.mark.parametrize("log_n,w", [(0, 8), (1, 1), (3, 45), (8, 8), (10, 1)])
def test_ntt_intt_match_jax(log_n, w):
    jx, tx = _inputs(log_n, w, 10 + log_n)
    _same(jntt.ntt(jx), ntt.ntt(tx))
    _same(jntt.intt(jx), ntt.intt(tx))


@pytest.mark.parametrize(
    "log_n,w,lb,shift,bitrev_out,in_shift,return_coeffs", [
        (0, 8, 1, 31, True, 1, False),
        (3, 45, 1, 31, True, 1, True),
        (4, 1, 2, 31, False, 1, False),
        (5, 8, 1, 7, True, 31, True),
        (6, 3, 0, 31, False, 11, False),
        (10, 8, 1, 31, True, 1, False),
    ])
def test_coset_lde_matches_jax(log_n, w, lb, shift, bitrev_out, in_shift,
                               return_coeffs):
    jx, tx = _inputs(log_n, w, 100 + log_n)
    want = jntt.coset_lde(jx, lb, shift, bitrev_out, in_shift, return_coeffs)
    got = ntt.coset_lde(tx, lb, shift=shift, bitrev_out=bitrev_out,
                        in_shift=in_shift, return_coeffs=return_coeffs)
    if return_coeffs:
        _same(want[0], got[0])
        _same(want[1], got[1])
    else:
        _same(want, got)


def test_batched_coset_ldes_equal_one_call_per_matrix():
    mats = [_inputs(log_n, w, 200 + k)[1]
            for k, (log_n, w) in enumerate([(4, 3), (3, 2), (4, 5), (2, 1)])]
    got = ntt.batched_coset_ldes(mats, 1)
    for m, y in zip(mats, got):
        assert torch.equal(y, ntt.coset_lde(m, 1))


def test_bad_height_raises():
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros((6, 2), dtype=torch.int32))


# ---------------------------------------------------------------------------
# K3's pass design, through its plain model (ntt._pass_model mirrors the
# kernel's tile, group and twiddle index arithmetic).  A small forced k_max
# makes many passes from small heights.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_n", range(25))
def test_pass_plan_covers_every_stage_once_in_order(log_n):
    plan = ntt._pass_plan(log_n)
    assert [s for s0, k in plan for s in range(s0, s0 + k)] == list(range(log_n))
    assert all(1 <= k <= ntt.K_MAX for _, k in plan)
    assert len(plan) == -(-log_n // ntt.K_MAX)
    assert max((k for _, k in plan), default=0) - min((k for _, k in plan), default=0) <= 1


def test_pass_plan_of_the_main_path_lde():
    # 2^20 -> 2^21: two inverse and two forward passes
    assert ntt._pass_plan(20) == [(0, 10), (10, 10)]
    assert ntt._pass_plan(21) == [(0, 11), (11, 10)]
    assert ntt._pass_plan(3, 2) == [(0, 2), (2, 1)]


@pytest.mark.parametrize("k_max", [2, 3])
def test_pass_model_equals_the_dif_stages(k_max):
    rng = np.random.default_rng(7)
    for log_n in range(1, 13):
        canon = rng.integers(0, bb.P, size=(1 << log_n, 9), dtype=np.uint64)
        x = bb.from_numpy(bb.to_monty_np(canon), device="cpu")
        for w in (1, 5, 9):
            xs = x[:, :w].contiguous()
            for inverse in (False, True):
                got = ntt._dif(ntt._pass_model, xs, torch.empty_like(xs), log_n,
                               inverse, k_max=k_max)
                want = ntt._dif_stages_plain(xs.long(), log_n, inverse).int()
                assert torch.equal(got, want), (log_n, w, inverse)


@pytest.mark.parametrize("log_n", [1, 3, 8])
def test_pass_model_equals_jax_dif_stages(log_n):
    # one XLA compile per height: widths 1 and 5 are column prefixes of 9
    import jax
    jx, tx = _inputs(log_n, 9, 300 + log_n)
    want = np.asarray(jax.jit(jntt._dif_stages, static_argnums=(1, 2))(
        jx, log_n, False), dtype=np.uint32)
    for w in (1, 5, 9):
        xs = tx[:, :w].contiguous()
        got = ntt._dif(ntt._pass_model, xs, torch.empty_like(xs), log_n, False,
                       k_max=3)
        np.testing.assert_array_equal(want[:, :w], bb.to_numpy(got))


CHIP_LDE_ARGS = [(1, 31, True, 1, False), (2, 7, False, 31, True),
                 (0, 31, False, 11, False), (3, 31, True, 1, True),
                 (0, 31, True, 1, True), (1, bb.GENERATOR, False, 1, False)]


@pytest.mark.parametrize("args", CHIP_LDE_ARGS)
def test_fused_lde_passes_equal_coset_lde_plain(args):
    rng = np.random.default_rng(11)
    for log_n in (0, 1, 4, 7):
        for w in (1, 9):
            x = bb.from_numpy(bb.to_monty_np(rng.integers(
                0, bb.P, size=(1 << log_n, w), dtype=np.uint64)), device="cpu")
            for k_max in (2, 3):
                got = ntt._coset_lde_passes(x, *args, ntt._pass_model, k_max)
                want = ntt.coset_lde_plain(x, *args)
                if args[-1]:
                    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                else:
                    assert torch.equal(got, want), (log_n, w, k_max)


@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_passes_equal_ntt_plain(inverse):
    rng = np.random.default_rng(12)
    for log_n in (1, 3, 6):
        x = bb.from_numpy(bb.to_monty_np(rng.integers(
            0, bb.P, size=(1 << log_n, 5), dtype=np.uint64)), device="cpu")
        plain = ntt.intt_plain if inverse else ntt.ntt_plain
        for k_max in (2, 3, ntt.K_MAX):
            assert torch.equal(ntt._ntt_passes(x, inverse, ntt._pass_model, k_max),
                               plain(x))


def test_fused_lde_passes_match_jax_with_coeffs():
    jx, tx = _inputs(5, 8, 105)
    want = jntt.coset_lde(jx, 1, 7, True, 31, True)
    got = ntt._coset_lde_passes(tx, 1, 7, True, 31, True, ntt._pass_model, 2)
    _same(want[0], got[0])
    _same(want[1], got[1])
