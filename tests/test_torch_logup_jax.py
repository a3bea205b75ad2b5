"""K9, K10 and the LogUp fold of K7 against openvm_tpu's LogUp, on
tests/test_torch_logup.py's cases: the balanced sender/receiver pair and
the RV32IM auipc chip's fib(10) trace.

The permutation traces (the port's plain K7 columns, K9 and K10, one AIR at
a time and in one multi-AIR build) equal ``build_perm_trace``'s, and the
LogUp fold in the quotient interpreter's one pass equals
``eval_logup_folded``.  The JAX package's keygen and eager evaluation take
about 30 s, so these tests have a file of their own, queued by ``--dist
loadfile`` after tests/test_aggregation.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvm_tpu.field import babybear as jbb
from openvm_tpu.stark import logup as jlogup
from openvm_tpu.stark.prover import _selectors_on_domain
from openvm_tpu_torch import ntt
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import logup, quotient as qmod
from openvm_tpu_torch.stark.symbolic import SymbolicDag

from test_torch_logup import CASES, P, computed

torch.set_num_threads(1)


@pytest.fixture(params=list(CASES))
def perm_traces(request):
    return computed(request.param)


def test_perm_trace_equal_jax(perm_traces):
    for case in perm_traces:
        assert case["vk"].dag.nodes == case["jvk"].dag.nodes
        assert np.array_equal(case["port"][0], case["jax"][0])
        assert np.array_equal(case["port"][1], case["jax"][1])


def test_perm_trace_shape_and_phi(perm_traces):
    """4 words per chunk and 4 for phi; phi's last row is the cumulative
    sum; the sends and receives of the balanced pair cancel."""
    for case in perm_traces:
        perm, cum = case["port"]
        m = len(case["vk"].interaction_chunks)
        assert perm.shape == (len(case["trace"]), 4 * (m + 1))
        assert np.array_equal(perm[-1, 4 * m:], cum)
    if len(perm_traces) == 2:
        sent, received = (c["port"][1].astype(np.int64) for c in perm_traces)
        assert not ((sent + received) % P).any()


def test_logup_fold_equal_eval_logup_folded():
    """K7's one-pass fold of the LogUp roots (the DAG's last
    len(chunks) + 3 roots) over auipc's quotient domain (lqd 1, next rows
    two apart), against JAX's batched evaluator scaled by 1/Z_H.  The
    sender/receiver pair's fold is held to the JAX package's by its pinned
    proof hash."""
    rng = np.random.default_rng(5)
    for case in computed("auipc"):
        vk, trace = case["vk"], case["trace"]
        lqd = vk.log_quotient_degree
        log_n = len(trace).bit_length() - 1
        log_q = log_n + lqd
        nq = 1 << log_q
        assert lqd >= 1
        main_lde = ntt.coset_lde(bb.monty(trace, device="cpu"), lqd)
        perm_lde = ntt.coset_lde(bb.from_numpy(case["port"][0], device="cpu"), lqd)
        n_logup = len(vk.interaction_chunks) + 3
        tail = SymbolicDag(nodes=vk.dag.nodes,
                           constraint_roots=vk.dag.constraint_roots[-n_logup:],
                           interactions=vk.dag.interactions)
        chs_m = bb.to_monty_np(np.asarray(case["chs"], dtype=np.uint64))
        expo = bb.to_monty_np(bb.from_monty_plain(torch.from_numpy(
            case["port"][1].astype(np.int64))).numpy().astype(np.uint64)[None])
        alpha = bb.from_numpy(bb.to_monty_np(rng.integers(0, P, 4)), device="cpu")
        prog = qmod.compile_dag(tail, n_main=1, has_preprocessed=False,
                                has_perm=True, challenges=chs_m, exposed=expo,
                                alpha=bb.to_numpy(alpha))
        got = qmod.evaluate_plain(prog, [main_lde, perm_lde], log_n, lqd)

        def q_slice(lde):
            rows = ntt.bitrev_perm(log_q)
            return jnp.asarray(bb.to_numpy(lde[:nq])[rows])

        sels = _selectors_on_domain(log_n, log_q, bb.GENERATOR)
        arrs = {"main": [q_slice(main_lde)], "preprocessed": None,
                "perm": q_slice(perm_lde), "publics": jnp.zeros((0,), jnp.uint32),
                "challenges": jnp.asarray(chs_m), "exposed": jnp.asarray(expo),
                "sels": sels}
        want = jlogup.eval_logup_folded(
            case["jvk"].dag, case["jvk"].interaction_chunks,
            {**arrs, "next_step": 1 << lqd}, jnp.asarray(bb.to_numpy(alpha)))
        want = jbb.mul(want, sels["inv_zeroifier"][:, None])
        assert np.array_equal(bb.to_numpy(got), np.asarray(want))


def test_build_perm_traces_equal_per_air_and_jax():
    """The multi-AIR build (one K9 call over the sender, the receiver and
    auipc's fib(10) trace) equals the per-AIR builds and the JAX
    package's build_perm_trace, AIR by AIR."""
    cases = computed("sender_receiver") + computed("auipc")
    chs = cases[0]["chs"]
    plan = logup.perm_plan([c["vk"].dag for c in cases],
                           [c["vk"].interaction_chunks for c in cases],
                           [1] * len(cases), [False] * len(cases))
    record: list = []
    built = logup.build_perm_traces(plan, [[bb.monty(c["trace"], device="cpu")] for c in cases],
                                    [None] * len(cases), [[]] * len(cases), chs, record)
    assert len(record) == len(cases) == 3
    for case, (perm, cum) in zip(cases, built):
        assert np.array_equal(bb.to_numpy(perm), case["port"][0])
        assert np.array_equal(bb.to_numpy(perm), case["jax"][0])
        assert np.array_equal(bb.to_numpy(cum), case["jax"][1])
