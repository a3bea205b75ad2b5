"""openvm_tpu_torch.field.babybear against openvm_tpu.field.babybear.

Inputs are made with numpy from a seed and fed to the JAX function (on
XLA:CPU) and to the port's plain version on the CPU; the raw Montgomery
words must be equal, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu.field import babybear as jbb
from openvm_tpu_torch import _build
from openvm_tpu_torch.field import babybear as bb

torch.set_num_threads(1)

P = bb.P
EDGES = np.array([0, 1, 2, P - 1, P - 2, bb.R_MOD_P, bb.R2_MOD_P, 1 << 30,
                  (1 << 31) - 1 - (1 << 27)], dtype=np.uint32)


def _words(seed, n=61):
    rng = np.random.default_rng(seed)
    return np.concatenate([EDGES, rng.integers(0, P, size=n, dtype=np.uint64)
                           .astype(np.uint32)])


def _port(a):
    return bb.from_numpy(a, device="cpu")


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out, dtype=np.uint32),
                                  bb.to_numpy(torch_out))


def test_constants_match():
    for name in ("P", "TWO_ADICITY", "GENERATOR", "R_MOD_P", "R2_MOD_P",
                 "NPRIME"):
        assert getattr(bb, name) == getattr(jbb, name), name
    for bits in (0, 1, 5, 16, 27):
        assert bb.two_adic_generator_int(bits) == jbb.two_adic_generator_int(bits)
    for x in (0, 1, P - 1, 123456789):
        assert bb.to_monty_int(x) == jbb.to_monty_int(x)
        assert bb.from_monty_int(x) == jbb.from_monty_int(x)


@pytest.mark.parametrize("op", ["to_monty", "from_monty", "neg", "inv"])
def test_unary_ops_match_jax(op):
    a = _words(1)
    _same(getattr(jbb, op)(jnp.asarray(a)), getattr(bb, op)(_port(a)))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_ops_match_jax(op):
    a, b = _words(2), _words(3)[::-1].copy()
    _same(getattr(jbb, op)(jnp.asarray(a), jnp.asarray(b)),
          getattr(bb, op)(_port(a), _port(b)))


def test_binary_op_broadcasts_like_jax():
    a = _words(4).reshape(10, 7)
    col = _words(5, n=1)[:10, None].copy()
    _same(jbb.mul(jnp.asarray(a), jnp.asarray(col)), bb.mul(_port(a), _port(col)))


@pytest.mark.parametrize("e", [0, 1, 7, 255, 1 << 20, P - 2])
def test_exp_u64_matches_jax(e):
    a = _words(6)
    _same(jbb.exp_u64(jnp.asarray(a), e), bb.exp_u64(_port(a), e))


def test_inv_of_zero_is_zero_and_inverts():
    a = _words(7)
    got = bb.mul(_port(a), bb.inv(_port(a)))
    want = np.where(a == 0, 0, bb.R_MOD_P).astype(np.uint32)
    np.testing.assert_array_equal(bb.to_numpy(got), want)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_sum_mod_and_dot_match_jax(axis):
    a = _words(8, n=81).reshape(10, 9)
    b = _words(9, n=81).reshape(10, 9)
    _same(jbb.sum_mod(jnp.asarray(a), axis), bb.sum_mod(_port(a), axis))
    _same(jbb.dot(jnp.asarray(a), jnp.asarray(b), axis),
          bb.dot(_port(a), _port(b), axis))


def test_numpy_round_trip_and_host_helpers():
    a = _words(10)
    np.testing.assert_array_equal(bb.to_numpy(_port(a)), a)
    canon = np.array([0, 1, P - 1, 5, 1 << 30], dtype=np.uint64)
    np.testing.assert_array_equal(
        bb.to_monty_np(canon), [jbb.to_monty_int(int(v)) for v in canon])
    _same(jbb.monty(canon), bb.monty(canon, device="cpu"))
    np.testing.assert_array_equal(
        bb.canonical_np(bb.monty(canon, device="cpu")), canon)
    np.testing.assert_array_equal(
        bb.powers_np(31, 37, scale=5), [5 * pow(31, i, P) % P for i in range(37)])
    with pytest.raises(ValueError):
        bb.from_numpy(np.array([P], dtype=np.uint32), device="cpu")


def test_cpu_tensors_take_the_plain_version():
    before = dict(_build.LAUNCHES)
    a, b = _port(_words(11)), _port(_words(12))
    for got, plain in ((bb.mul(a, b), bb.mul_plain(a, b)),
                       (bb.add(a, b), bb.add_plain(a, b)),
                       (bb.sub(a, b), bb.sub_plain(a, b)),
                       (bb.to_monty(a), bb.to_monty_plain(a)),
                       (bb.from_monty(a), bb.from_monty_plain(a))):
        assert got.dtype == torch.int32
        assert torch.equal(got, plain)
    assert _build.LAUNCHES == before
