"""The port's STARK prover against openvm_tpu's, without a JAX prove: the
openings' dot product and column combination, the K12 model, the codec's
pinned blob and a wrong public value refused.

The instance below (FibonacciAir at 2^5 and 2^3, CubeAir at 2^4 with one
preprocessed column, one cached main partition and a degree-3 transition
constraint) is proved by both packages in tests/test_torch_prover_jax.py,
whose proof bytes are pinned there (``FIXTURE_PROOF_SHA256``); that JAX
prove (about a minute of XLA:CPU compiles) stays in a file of few tests, so
that this one takes a few seconds.  chip_smoke.py proves the same instance
on the card and checks the same hash.
"""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu.stark.prover import _col_comb as jax_col_comb
from openvm_tpu.stark.prover import _open_dot_jit
from openvm_tpu_torch import fri
from openvm_tpu_torch import stark
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import codec, prover as pv

from test_stark_e2e import FibonacciAir as JaxFibonacciAir, fib_trace

torch.set_num_threads(1)

P = bb.P
CONFIG = stark.StarkConfig(fri=stark.FriParameters(
    log_blowup=1, num_queries=4, proof_of_work_bits=2))

# sha256 of openvm_tpu's encode_proof bytes for the instance below
# (``contexts(...)`` under TEST_CONFIG), checked by
# tests/test_torch_prover_jax.py; chip_smoke.py checks it on the card.
FIXTURE_PROOF_SHA256 = \
    "a7febea84f25e9074f2e80382be71111e236adbb861a996c3e3c026133de7e8d"


class FibonacciAir(stark.Air):
    """tests/test_stark_e2e.py's FibonacciAir on the port's Air."""

    name = "fib"
    width = 2
    num_public_values = 3

    def eval(self, b):
        JaxFibonacciAir.eval(self, b)


def cube_air(base):
    """x' = x*y + c on transitions (degree 3 with the selector); y is a
    cached main partition, c = row index preprocessed; x at the first and
    last row public."""

    class CubeAir(base):
        name = "cube"
        width = 1
        cached_main_widths = (1,)
        num_public_values = 2

        def __init__(self, log_n):
            self.log_n = log_n

        def preprocessed_trace(self):
            return np.arange(1 << self.log_n, dtype=np.uint64)[:, None]

        def eval(self, b):
            x, x_next = b.main(0), b.main(0, offset=1)
            y, c = b.main(0, part=0), b.preprocessed(0)
            with b.when_first_row():
                b.assert_eq(x, b.public_value(0))
            with b.when_transition():
                b.assert_eq(x_next, x * y + c)
            with b.when_last_row():
                b.assert_eq(x, b.public_value(1))

    return CubeAir


def cube_trace(log_n, seed):
    n = 1 << log_n
    y = np.random.default_rng(seed).integers(0, P, size=n, dtype=np.uint64)
    x = np.zeros(n, dtype=np.uint64)
    x[0] = 5
    for i in range(n - 1):
        x[i + 1] = (int(x[i]) * int(y[i]) + i) % P
    return x[:, None], y[:, None], [5, int(x[-1])]


def contexts(ctx_cls, last_pv_delta=0, as_tensor=False):
    """FibonacciAir at 2^5 and 2^3, CubeAir at 2^4; traces as canonical
    numpy, or as Montgomery CPU tensors when ``as_tensor``."""
    t5, t3 = fib_trace(32), fib_trace(8)
    x, y, cube_pvs = cube_trace(4, 1)
    pvs = [[0, 1, int(t5[-1, 1])], [0, 1, (int(t3[-1, 1]) + last_pv_delta) % P],
           cube_pvs]

    def m(a):
        return bb.monty(a, device="cpu") if as_tensor else a

    return [ctx_cls(air_id=0, common_main=m(t5), public_values=pvs[0]),
            ctx_cls(air_id=1, common_main=m(t3), public_values=pvs[1]),
            ctx_cls(air_id=2, common_main=m(x), cached_mains=[m(y)],
                    public_values=pvs[2])]


@pytest.fixture(scope="module")
def port_pk():
    return stark.keygen([FibonacciAir(), FibonacciAir(), cube_air(stark.Air)(4)],
                        CONFIG, device="cpu")


def test_wrong_public_value_fails(port_pk):
    tpk = port_pk
    with pytest.raises((stark.VerificationError, AssertionError)):
        proof = stark.prove(tpk, contexts(stark.AirProvingContext, 1),
                            device="cpu")
        stark.verify(tpk.vk, proof)


def test_open_dot_and_col_comb_equal_jax():
    """The openings' dot product (random series, and ``open_many``'s own
    geometric ones for one and two points) and the column combination
    equal the JAX package's."""
    rng = np.random.default_rng(5)

    def words(*shape):
        return bb.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64))

    coeffs, zpows, geos, apows = words(16, 3), words(16, 4), words(2, 16), words(4, 4)

    def t(a):
        return bb.from_numpy(a, device="cpu")

    np.testing.assert_array_equal(
        np.asarray(_open_dot_jit(jnp.asarray(coeffs), jnp.asarray(zpows),
                                 jnp.asarray(geos))),
        bb.to_numpy(pv._open_dot_plain(t(coeffs), t(zpows), t(geos))))
    mults = [7, 31]
    series = bb.to_monty_np(np.asarray([[pow(m, i, P) for i in range(16)] for m in mults],
                                       dtype=np.uint64))
    got = pv.open_many([(t(coeffs), mults), (t(coeffs)[:, 1:], mults[1:])], t(zpows))
    np.testing.assert_array_equal(
        np.asarray(_open_dot_jit(jnp.asarray(coeffs), jnp.asarray(zpows),
                                 jnp.asarray(series))), bb.to_numpy(got[0]))
    np.testing.assert_array_equal(
        np.asarray(_open_dot_jit(jnp.asarray(np.ascontiguousarray(coeffs[:, 1:])),
                                 jnp.asarray(zpows), jnp.asarray(series[1:]))),
        bb.to_numpy(got[1]))
    np.testing.assert_array_equal(
        np.asarray(jax_col_comb(jnp.asarray(coeffs), jnp.asarray(apows))),
        bb.to_numpy(pv._col_comb(t(coeffs), t(apows))))


@pytest.mark.parametrize("threads,max_blocks", [(4, 2), (8, 3), (16, 1000)])
def test_open_kernel_model_equals_plain(threads, max_blocks):
    """K12's job table and index arithmetic, modelled (``pv._open_model``):
    one table of widths 1 to 17 and heights 2^1 to 2^7 (largest first),
    one and two points, a strided column slice, wider matrices than a
    block's threads (column groups), a matrix without rows, and weights'
    powers made from each block's first row and stepped a tile at a time;
    each job's openings read from the flat output at its table offset."""
    rng = np.random.default_rng(threads)

    def words(*shape):
        return bb.from_numpy(bb.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64)),
                             device="cpu")

    zpows = words(1 << 7, 4)
    wide = words(1 << 6, 9)
    jobs = [(words(1 << 7, 2), [1, 5]), (words(2, 1), [3]), (wide[:, 2:7], [11, 13]),
            (words(1 << 5, 17), [P - 1]), (words(1 << 3, 4), [1, 2]), (words(1 << 4, 3), [6]),
            (words(0, 3), [2, 3])]
    shapes = [(int(c.shape[0]), int(c.shape[1]), len(m)) for c, m in jobs][:-1]
    order, rows, blocks, first, total = pv.open_plan(shapes, threads, max_blocks)
    assert [shapes[k][0] * shapes[k][1] for k in order] == sorted(
        (n * w for n, w, _ in shapes), reverse=True)
    assert first == list(np.cumsum([0] + blocks[:-1])) and total == sum(blocks)
    for pos, k in enumerate(order):
        assert rows[pos] % threads == 0 and blocks[pos] <= max_blocks
        assert (blocks[pos] - 1) * rows[pos] < shapes[k][0] <= blocks[pos] * rows[pos]
    for got, want in zip(pv._open_model(jobs, zpows, threads, max_blocks),
                         pv.open_many_plain(jobs, zpows)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_codec_reproduces_pinned_blob():
    """tests/test_bitcompat_fixtures.py:81-140, through the port's codec."""

    def d(s):
        return np.arange(s, s + 8, dtype=np.uint64)

    def ext(s):
        return (s, s + 1, s + 2, s + 3)

    adj = pv.AdjacentOpenedValues(local=[ext(10), ext(20)],
                                  next=[ext(30), ext(40)])
    proof = pv.Proof(
        commitments=pv.Commitments(main_trace=[d(100), d(200)],
                                   after_challenge=[d(300)], quotient=d(400)),
        opening=pv.Opening(
            proof=fri.FriProof(
                commit_phase_commits=[d(500)],
                query_proofs=[fri.QueryProof(
                    input_proof=[fri.BatchOpening(
                        opened_values=[[1, 2, 3], [4, 5]],
                        opening_proof=[d(600)])],
                    commit_phase_openings=[fri.CommitPhaseStep(
                        sibling_value=ext(50), opening_proof=[d(700)])])],
                final_poly=[ext(60)], pow_witness=777),
            values=pv.OpeningValues(
                preprocessed=[adj], main=[[adj]], after_challenge=[[adj]],
                quotient=[[[ext(70), ext(80)]]])),
        per_air=[pv.AirProofData(air_id=0, log_degree=3,
                                 exposed_values_after_challenge=[[ext(90)]],
                                 public_values=[7, 8])],
        air_perm_by_height=[0], log_up_pow_witness=999)
    blob = codec.encode_proof(proof)
    assert len(blob) == 665
    assert hashlib.sha256(blob).hexdigest() == (
        "ca080bacdcea1da8b75aae72aee556cf11cc57b8382a445a8195d7ca9db0b176")
    assert codec.encode_proof(codec.decode_proof(blob)) == blob
    with pytest.raises(codec.CodecError):
        codec.decode_proof(blob + b"\x00")
