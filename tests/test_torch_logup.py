"""K9, K10 and the LogUp fold of K7 against openvm_tpu's LogUp.

The port builds the permutation trace with the quotient interpreter's
columns mode (K7), ``logup.perm_cols`` (K9) and ``logup.perm_scan`` (K10),
here through their plain versions on the CPU, and folds the LogUp
constraints that keygen appends to every DAG in the quotient interpreter's
one pass.  Both are held word for word against ``build_perm_trace`` and
``eval_logup_folded`` on tests/test_stark_e2e.py's SenderAir/ReceiverAir
and on the RV32IM auipc chip's fib(10) trace (whose quotient domain is
twice its trace: lqd 1), and in a pinned case where alpha makes one
denominator zero, which both packages turn into a zero contribution.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import stark as jstark
from openvm_tpu.field import babybear as jbb
from openvm_tpu.stark import logup as jlogup
from openvm_tpu.stark.prover import _selectors_on_domain
from openvm_tpu.vm.circuit import rv32im as jrv
from openvm_tpu_torch import ntt, stark
from openvm_tpu_torch.stark import codec
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import logup, npext as nx, quotient as qmod
from openvm_tpu_torch.stark.symbolic import SymbolicDag
from openvm_tpu_torch.vm.circuit import rv32im as trv
from openvm_tpu_torch.vm.guest import build_fib_program
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

from test_stark_e2e import ReceiverAir as JaxReceiverAir, SenderAir as JaxSenderAir

torch.set_num_threads(1)

P = bb.P
# sha256 of openvm_tpu's encode_proof bytes for tests/test_stark_e2e.py's
# balanced SenderAir/ReceiverAir instance (test_logup_two_airs) under its
# TEST_CONFIG
SENDER_RECEIVER_PROOF_SHA256 = \
    "69e8d8c994a91341064fa0a08d5652c33625279bb434def5e0963fceb46d2528"


class SenderAir(stark.Air):
    name = "sender"
    width = 1

    def eval(self, b):
        b.push_send(7, [b.main(0)], 1)


class ReceiverAir(stark.Air):
    name = "receiver"
    width = 2

    def eval(self, b):
        b.push_receive(7, [b.main(0)], b.main(1))


def sender_receiver():
    send_vals = np.array([3, 5, 5, 7, 3, 3, 9, 9], dtype=np.uint64)[:, None]
    table = np.array([[3, 3], [5, 2], [7, 1], [9, 2]], dtype=np.uint64)
    return [(JaxSenderAir(), SenderAir(), send_vals),
            (JaxReceiverAir(), ReceiverAir(), table)]


def auipc_case():
    pre = PreflightInterpreter(build_fib_program(10)).execute()
    air = trv.AuipcAir()
    return [(jrv.AuipcAir(), air, air.trace(pre.records["rv32_auipc"]))]


def challenges(seed):
    return [tuple(int(x) for x in np.random.default_rng(seed).integers(0, P, 4))
            for seed in (seed, seed + 1)]


def jax_perm_trace(jair, trace, chs):
    vk = jstark.keygen([jair], jstark.StarkConfig()).vk.per_air[0]
    ch = jbb.to_monty(jnp.asarray(np.asarray(chs, dtype=np.uint32)))
    env = {"main": [jbb.to_monty(jnp.asarray((trace % P).astype(np.uint32)))],
           "preprocessed": None, "perm": None,
           "publics": jnp.zeros((0,), jnp.uint32), "challenges": ch,
           "exposed": jnp.zeros((1, 4), jnp.uint32), "sels": None,
           "next_step": 1}
    perm, cum = jlogup.build_perm_trace(vk.dag, env, vk.interaction_chunks, ch)
    return vk, np.asarray(perm), np.asarray(cum)


def port_perm_trace(air, trace, chs):
    vk = stark.keygen([air], stark.StarkConfig(), device="cpu").vk.per_air[0]
    perm, cum = logup.build_perm_trace(vk.dag, vk.interaction_chunks,
                                       [bb.monty(trace, device="cpu")], None,
                                       [], chs)
    return vk, bb.to_numpy(perm), bb.to_numpy(cum)


CASES = {"sender_receiver": sender_receiver, "auipc": auipc_case}


@functools.lru_cache(maxsize=None)
def computed(name):
    """Both packages' permutation traces of one case, computed once."""
    chs = challenges(11)
    out = []
    for jair, air, trace in CASES[name]():
        jvk, jperm, jcum = jax_perm_trace(jair, trace, chs)
        vk, perm, cum = port_perm_trace(air, trace, chs)
        out.append({"trace": trace, "jvk": jvk, "vk": vk, "jax": (jperm, jcum),
                    "port": (perm, cum), "chs": chs})
    return out


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


def test_zero_denominator_contributes_zero():
    """alpha = -(bus + beta * v0) makes row 0's denominator zero; its
    inverse is 0 (babybear.py:234), so row 0's chunk column is 0 in both
    packages, and the other rows are not."""
    (jair, air, trace), _ = sender_receiver()
    beta = challenges(3)[1]
    v0 = int(trace[0, 0])
    bv = nx.nmul_base(np.asarray(beta, dtype=np.uint64), v0)
    bv[0] = (bv[0] + 7) % P
    alpha = tuple(int(x) for x in (P - bv) % P)
    chs = [alpha, beta]
    _, jperm, jcum = jax_perm_trace(jair, trace, chs)
    _, perm, cum = port_perm_trace(air, trace, chs)
    assert np.array_equal(perm, jperm) and np.array_equal(cum, jcum)
    zero_rows = [r for r in range(len(trace)) if not perm[r, :4].any()]
    assert zero_rows == [r for r in range(len(trace)) if trace[r, 0] == v0]
    assert zero_rows and len(zero_rows) < len(trace)


def test_sender_receiver_proof_sha256_pinned():
    """The whole prove with a LogUp phase and an after-challenge round: the
    port's proof bytes of the balanced pair have the SHA-256 of the JAX
    package's proof, and the port's verifier accepts them."""
    cfg = stark.StarkConfig(fri=stark.FriParameters(log_blowup=1, num_queries=4,
                                                    proof_of_work_bits=2))
    (_, sender, sends), (_, receiver, table) = sender_receiver()
    pk = stark.keygen([sender, receiver], cfg, device="cpu")
    proof = stark.prove(pk, [stark.AirProvingContext(air_id=0, common_main=sends),
                             stark.AirProvingContext(air_id=1, common_main=table)],
                        device="cpu")
    stark.verify(pk.vk, proof)
    assert hashlib.sha256(codec.encode_proof(proof)).hexdigest() == \
        SENDER_RECEIVER_PROOF_SHA256
