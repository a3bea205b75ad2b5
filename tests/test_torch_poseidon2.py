"""openvm_tpu_torch.poseidon2 against openvm_tpu.poseidon2: raw words equal.

Also pins the port to the stored vectors of tests/test_bitcompat_fixtures.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import poseidon2 as jp2
from openvm_tpu_torch import poseidon2 as p2
from openvm_tpu_torch.field import babybear as bb

torch.set_num_threads(1)

# tests/test_bitcompat_fixtures.py:21-27
PERM_0_15 = [1952993082, 1617884793, 90683999, 1056283110,
             867545409, 290768337, 1606559591, 1225374373,
             1789096927, 494560864, 1094240052, 1575300684,
             540591577, 1767075193, 341504408, 1747000221]
HASH_ROWS_0 = [792144724, 998142365, 1110522868, 131779120,
               85566828, 51797263, 1511264494, 935419835]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    words = bb.to_monty_np(rng.integers(0, bb.P, size=shape, dtype=np.uint64))
    return jnp.asarray(words), bb.from_numpy(words, device="cpu")


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out, dtype=np.uint32),
                                  bb.to_numpy(torch_out))


def test_grain_constants_equal_jax():
    np.testing.assert_array_equal(p2._RC_ALL, jp2._RC_ALL)
    np.testing.assert_array_equal(p2.INTERNAL_DIAG, jp2.INTERNAL_DIAG)
    assert [int(x) for x in p2._RC_ALL[0][:4]] == \
        [1774958255, 1185780729, 1621102414, 1796380621]


def test_permute_matches_jax():
    js, ts = _inputs((6, 16), 1)
    _same(jp2.permute(js), p2.permute(ts))


def test_permute_lane_major_matches_jax():
    """From LANE_MAJOR_STATES states on, the plain permutation keeps each
    lane contiguous (``_permute_lanes``); a (2, 2050, 16) batch takes that
    path."""
    js, ts = _inputs((2, 2050, 16), 2)
    assert ts[..., 0].numel() >= p2.LANE_MAJOR_STATES
    _same(jp2.permute(js), p2.permute(ts))


@pytest.mark.parametrize("w", [1, 7, 8, 9, 45])
def test_hash_rows_matches_jax(w):
    jm, tm = _inputs((4, w), 10 + w)
    _same(jp2.hash_rows(jm), p2.hash_rows(tm))


def test_compress_pairs_matches_jax():
    (jl, tl), (jr, tr) = _inputs((4, 8), 2), _inputs((4, 8), 3)
    _same(jp2.compress_pairs(jl, jr), p2.compress_pairs(tl, tr))


def test_host_permutation_matches_jax_host():
    rng = np.random.default_rng(4)
    states = rng.integers(0, bb.P, size=(5, 16), dtype=np.uint64)
    jh, th = jp2.Poseidon2Host(), p2.Poseidon2Host()
    np.testing.assert_array_equal(th.permute_batch(states), jh.permute_batch(states))
    np.testing.assert_array_equal(th.permute(states[0]), jh.permute(states[0]))


def test_set_round_constants_swaps_both_packages_alike():
    saved = [(m.BEGIN_RC.copy(), m.PARTIAL_RC.copy(), m.END_RC.copy())
             for m in (jp2, p2)]
    rng = np.random.default_rng(5)
    begin = rng.integers(0, bb.P, size=(4, 16), dtype=np.uint64)
    partial = rng.integers(0, bb.P, size=13, dtype=np.uint64)
    end = rng.integers(0, bb.P, size=(4, 16), dtype=np.uint64)
    js, ts = _inputs((3, 16), 6)
    jm, tm = _inputs((3, 11), 7)
    before = bb.to_numpy(p2.permute(ts))
    try:
        jp2.set_round_constants(begin, partial, end)
        p2.set_round_constants(begin, partial, end)
        swapped = p2.permute(ts)
        assert not np.array_equal(bb.to_numpy(swapped), before)
        _same(jp2.permute(js), swapped)
        _same(jp2.hash_rows(jm), p2.hash_rows(tm))
        np.testing.assert_array_equal(p2.Poseidon2Host().permute(begin[0]),
                                      jp2.Poseidon2Host().permute(begin[0]))
    finally:
        jp2.set_round_constants(*saved[0])
        p2.set_round_constants(*saved[1])
    np.testing.assert_array_equal(bb.to_numpy(p2.permute(ts)), before)
    with pytest.raises(ValueError):
        p2.set_round_constants(begin[:3], partial, end)


def test_pinned_vectors():
    st = bb.monty(np.arange(16), device="cpu")
    assert bb.canonical_np(p2.permute(st)).tolist() == PERM_0_15
    left = bb.monty(np.arange(8).reshape(1, 8), device="cpu")
    right = bb.monty(np.arange(8, 16).reshape(1, 8), device="cpu")
    assert bb.canonical_np(p2.compress_pairs(left, right))[0].tolist() == \
        PERM_0_15[:8]
    m = bb.monty((np.arange(4 * 12).reshape(4, 12) * 7 + 3) % bb.P, device="cpu")
    assert bb.canonical_np(p2.hash_rows(m))[0].tolist() == HASH_ROWS_0


# ---------------------------------------------------------------------------
# K4's internal layer: the diagonal by additions and shifts, lane sums
# reduced once (p2._diag_layer64 and p2._reduce_sum64 model the kernel)
# ---------------------------------------------------------------------------

def _edge_lanes(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([[0, 1, bb.P - 1, bb.P - 2, 2, (bb.P - 1) // 2],
                           rng.integers(0, bb.P, size=58)]).astype(np.int64)
    lanes = np.stack([np.roll(vals, i) for i in range(16)], axis=1)
    return torch.from_numpy(lanes), vals


def test_structured_diagonal_equals_general_products():
    s, vals = _edge_lanes(20)
    diag = torch.from_numpy(p2.INTERNAL_DIAG.astype(np.int64))
    for total in (0, 1, bb.P - 1, int(vals[-1])):
        t = torch.full((s.shape[0],), total, dtype=torch.int64)
        np.testing.assert_array_equal(p2._diag_layer64(s, t).numpy(),
                                      ((s * diag + t[:, None]) % bb.P).numpy())


def test_lane_sum_reduction():
    rng = np.random.default_rng(21)
    v = rng.integers(0, 16 * bb.P, size=2000)
    v[:5] = [0, 1, bb.P, 16 * bb.P - 1, 15 << 31]
    np.testing.assert_array_equal(p2._reduce_sum64(torch.from_numpy(v)).numpy(),
                                  v % bb.P)


def test_structured_permutation_matches_jax():
    js, ts = _inputs((6, 16), 22)
    consts = p2._plain_constants(p2._RC_VERSION, torch.device("cpu"))
    got = p2._monty32(p2._permute64(p2._canonical64(ts), consts, structured_diag=True))
    _same(jp2.permute(js), got)
    st = bb.monty(np.arange(16), device="cpu")
    got = p2._monty32(p2._permute64(p2._canonical64(st), consts, structured_diag=True))
    assert bb.canonical_np(got).tolist() == PERM_0_15


def test_upload_refuses_another_diagonal():
    saved = p2.INTERNAL_DIAG
    try:
        p2.INTERNAL_DIAG = saved.copy()
        p2.INTERNAL_DIAG[3] = 5
        with pytest.raises(ValueError, match="diagonal"):
            p2.upload_constants(torch.device("cpu"))
    finally:
        p2.INTERNAL_DIAG = saved


def test_four_thread_permutation_model_matches_jax():
    """K5's tail permutation, modelled thread by thread (``_permute_quad64``:
    M4 blocks per thread, block and lane sums by xor-shuffles, diagonal by
    Montgomery products), equals JAX's permute and the pinned vector."""
    js, ts = _inputs((7, 16), 23)
    got = p2._permute_quad64(ts.long()).int()
    _same(jp2.permute(js), got)
    st = bb.monty(np.arange(16), device="cpu")
    assert bb.canonical_np(p2._permute_quad64(st.long()).int()).tolist() == PERM_0_15
