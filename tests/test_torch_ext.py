"""openvm_tpu_torch.field.ext (kernel K2's plain versions) against
openvm_tpu.field.ext: raw Montgomery words equal on seeded random elements,
zeros and edge values included.  The power series' model is held to the
JAX package's words at n = 1000 through their pinned SHA-256, which
tests/test_torch_ext_jax.py recomputes."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu.field import ext as jef
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


# K2's power series kernel, modelled on the CPU (ext._powers_model: blocks
# of POW_T x POW_E powers, and of 4 x 3 so that n = 1000 has 84 blocks
# whose first powers take every low exponent bit) and run through
# powers_host / powers on CPU tensors, against _ext_pows_jit at n = 1000
# per u: its doubling's first n rows are its result at n.  JAX's compile
# takes about 15 s, so its words are pinned here by SHA-256 (POW_SHA256)
# and held to the pins live by tests/test_torch_ext_jax.py.
POW_U = {"random": _elems(9, n=1)[-1], "zero": np.zeros(4, dtype=np.uint32),
         "one": np.array([bb.R_MOD_P, 0, 0, 0], dtype=np.uint32)}
POW_N = 1000
POW_SHA256 = {
    "random": "554505c82eba441453abd60b5c961c40c7265e22071d431bb11a5f982d02daa1",
    "zero": "93e06ce458847168cb18c9c93d3f4a7a4d557a50d8c144126821415745dfdf8e",
    "one": "15129a559e4cc5106d6eee310ac7eab3b42c4709e84bd2b78df822f50d6bb663"}


def words_sha256(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, dtype=np.uint32).tobytes()).hexdigest()


@pytest.fixture(scope="module")
def jax_pows():
    """_ext_pows_jit's words at POW_N for each u: the doubling's words,
    whose SHA-256 is the pinned one of the JAX package's."""
    out = {k: bb.to_numpy(ef.powers_plain(_port(u), POW_N)) for k, u in POW_U.items()}
    assert {k: words_sha256(v) for k, v in out.items()} == POW_SHA256
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 255, 256, 257, 1000])
@pytest.mark.parametrize("which", ["random", "zero", "one"])
def test_powers_model_equal_jax_ext_pows(jax_pows, n, which):
    u = POW_U[which]
    want = jax_pows[which][:n]
    _same(want, ef._powers_model(u, n))
    _same(want, ef._powers_model(u, n, threads=4, per_thread=3))
    _same(want, ef.powers_host(u.tolist(), n, "cpu"))
    _same(want, ef.powers(_port(u), n))
    if which == "zero":  # u^0 = 1, the rest 0
        assert want[0].tolist() == [bb.R_MOD_P, 0, 0, 0] and not want[1:].any()


def test_mul_pre_model_equals_mul():
    """The series' step product (csrc/ext.cuh mul_pre: b's W-multiples made
    once, four products a coefficient summed in 64 bits, one reduction)."""
    a, b = _elems(11), _elems(12)[::-1].copy()
    a[-1] = b[-1] = P - 1  # the largest sums: 4 (p - 1)^2 < 2^64
    for k in range(len(b)):
        _same(jef.mul(jnp.asarray(a), jnp.asarray(np.broadcast_to(b[k], a.shape))),
              torch.from_numpy(ef._mul_pre_model(a, b[k]).astype(np.int32)))


def test_powers_of_zero_length_and_bad_words():
    u = _elems(10, n=1)[-1]
    for got in (ef._powers_model(u, 0), ef.powers_host(u.tolist(), 0, "cpu"),
                ef.powers_plain(_port(u), 0)):
        assert tuple(got.shape) == (0, 4) and got.dtype == torch.int32
    with pytest.raises(ValueError, match="below p"):
        ef.powers_host([P, 0, 0, 0], 4, "cpu")
    with pytest.raises(ValueError, match="four"):
        ef.powers_host([1, 2, 3], 4, "cpu")
