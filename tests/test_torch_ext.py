"""openvm_tpu_torch.field.ext (kernel K2's plain versions) against
openvm_tpu.field.ext: raw Montgomery words equal on seeded random elements,
zeros and edge values included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu.field import ext as jef
from openvm_tpu.stark.prover import _ext_pows_jit
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.field import ext as ef

torch.set_num_threads(1)

P = bb.P


def _elems(seed, n=29):
    """(n + 3, 4) Montgomery words: zero, one, W, then random elements."""
    rng = np.random.default_rng(seed)
    fixed = np.array([[0, 0, 0, 0], [bb.R_MOD_P, 0, 0, 0],
                      [bb.to_monty_int(11), 0, 0, P - 1]], dtype=np.uint32)
    return np.concatenate([fixed, rng.integers(0, P, size=(n, 4),
                                               dtype=np.uint64).astype(np.uint32)])


def _port(a):
    return bb.from_numpy(a, device="cpu")


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out, dtype=np.uint32),
                                  bb.to_numpy(torch_out))


def test_mul_add_sub_equal_jax():
    a, b = _elems(0), _elems(1)[::-1].copy()
    _same(jef.mul(jnp.asarray(a), jnp.asarray(b)), ef.mul(_port(a), _port(b)))
    _same(jef.add(jnp.asarray(a), jnp.asarray(b)), ef.add(_port(a), _port(b)))
    _same(jef.sub(jnp.asarray(a), jnp.asarray(b)), ef.sub(_port(a), _port(b)))
    _same(jef.neg(jnp.asarray(a)), ef.neg(_port(a)))
    # a one-element operand broadcasts
    _same(jef.mul(jnp.asarray(a), jnp.asarray(b[5])), ef.mul(_port(a), _port(b[5])))


def test_inv_equal_jax_and_zero_maps_to_zero():
    a = _elems(2)
    got = ef.inv(_port(a))
    _same(jef.inv(jnp.asarray(a)), got)
    assert bb.to_numpy(got[0]).tolist() == [0, 0, 0, 0]
    one = bb.to_numpy(ef.mul(_port(a[1:]), got[1:]))
    assert (one == np.array([bb.R_MOD_P, 0, 0, 0], dtype=np.uint32)).all()


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_frobenius_equal_jax(k):
    a = _elems(3)
    _same(jef.frobenius(jnp.asarray(a), k), ef.frobenius(_port(a), k))


# short (unrolled), power of two (pure squaring) and long (scan) exponents:
# the three programs of ext.py:122-141
@pytest.mark.parametrize("e", [0, 7, 256, P - 2, 10**12 + 39])
def test_exp_u64_equal_jax(e):
    a = _elems(4, n=5)
    _same(jef.exp_u64(jnp.asarray(a), e), ef.exp_u64(_port(a), e))


def test_scale_and_dot_equal_jax():
    a = _elems(5)
    c = bb.to_monty_np(np.random.default_rng(6).integers(0, P, size=a.shape[0]))
    _same(jef.scale(jnp.asarray(a), jnp.asarray(c)),
          ef.scale(_port(a), _port(c)))
    _same(jef.scale(jnp.asarray(a), jnp.asarray(c[3])),
          ef.scale(_port(a), _port(c[3])))
    b = _elems(7)
    _same(jef.dot(jnp.asarray(a), jnp.asarray(b), axis=0),
          ef.dot(_port(a), _port(b), axis=0))


@pytest.mark.parametrize("n", [1, 5, 16])
def test_powers_equal_jax_ext_pows(n):
    u = _elems(8, n=1)[-1]
    _same(_ext_pows_jit(jnp.asarray(u), n), ef.powers(_port(u), n))
