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
