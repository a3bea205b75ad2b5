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

The permutation traces and the fold against the JAX package's (its keygen
and eager evaluation take about 30 s) are in tests/test_torch_logup_jax.py,
a file of few tests; the cases and their computation are here.

K10's single-pass scan is held through its buffer and a model: the chunk
columns in K9's (N, 4m + 4) buffer (``perm_buffer``), scanned, equal
``_perm_tail_jit`` at 2^1 to 2^12 rows, and ``logup._scan_model`` (tiles,
row sums, the look-back's carries over aggregates and prefixes) equals the
plain scan at forced small tiles and look-back windows.
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
from openvm_tpu.stark.logup import _perm_tail_jit
from openvm_tpu.vm.circuit import rv32im as jrv
from openvm_tpu_torch import stark
from openvm_tpu_torch.stark import codec
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.field import ext as ef
from openvm_tpu_torch.stark import logup, npext as nx, quotient as qmod
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


@pytest.mark.parametrize("log_n,m", [(1, 1), (5, 3), (9, 11), (12, 12)])
def test_perm_buffer_scan_equals_jax_tail(log_n, m):
    """Chunk columns in K9's output view of the (N, 4m + 4) trace: the
    trace around them has phi's 4 columns beside each row, and the scan of
    the view equals the JAX package's ``_perm_tail_jit``."""
    rng = np.random.default_rng(log_n)
    words = bb.to_monty_np(rng.integers(0, P, size=(1 << log_n, 4 * m), dtype=np.uint64))
    perm = logup.perm_buffer(1 << log_n, m, "cpu")
    perm.copy_(bb.from_numpy(words, device="cpu"))
    trace = logup._trace_of(perm)
    assert trace.shape == (1 << log_n, 4 * m + 4)
    assert trace.data_ptr() == perm.data_ptr()
    np.testing.assert_array_equal(bb.to_numpy(trace[:, :4 * m]), words)
    got, cum = logup.perm_scan(perm)
    jmat, jcum = _perm_tail_jit(jnp.asarray(words))
    np.testing.assert_array_equal(bb.to_numpy(got), np.asarray(jmat))
    np.testing.assert_array_equal(bb.to_numpy(cum), np.asarray(jcum))
    with pytest.raises(ValueError, match="perm_buffer"):
        logup._trace_of(bb.from_numpy(words, device="cpu"))


@pytest.mark.parametrize("n,m,tile,window", [(1, 1, 2, 2), (7, 2, 2, 2), (37, 3, 3, 4),
                                             (256, 11, 4, 3), (1000, 12, 16, 32)])
def test_scan_model_equals_plain(n, m, tile, window):
    """K10's tiles, row sums and look-back carries, modelled at forced
    small tiles and windows (so the look-back crosses several windows of
    aggregates before a prefix), with prefixes published at random."""
    rng = np.random.default_rng(n)
    perm = bb.from_numpy(bb.to_monty_np(rng.integers(0, P, size=(n, 4 * m), dtype=np.uint64)),
                         device="cpu")
    want, want_cum = logup.perm_scan_plain(perm)
    for seed in range(3):
        got, cum = logup._scan_model(perm, tile, window, seed)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        np.testing.assert_array_equal(cum.numpy(), want_cum.numpy())


# ---------------------------------------------------------------------------
# K9's one-launch design: batch inversion, delayed reduction, the plan
# ---------------------------------------------------------------------------

def random_words(rng, *shape) -> torch.Tensor:
    return torch.from_numpy(bb.to_monty_np(rng.integers(0, P, size=shape,
                                                        dtype=np.uint64)).astype(np.int64))


@pytest.mark.parametrize("n_its", [3, 4, 11])
def test_batch_inverse_model_zero_denominators(n_its):
    """Montgomery's trick over a row's interactions, PERM_BATCH at a time
    (fewer interactions than a batch, one whole batch, batches with a
    short last one), with a zero denominator at the first, a middle and
    the last interaction of a row and a row of zeros only: equal to the
    per-element inverse, a zero's inverse 0."""
    rng = np.random.default_rng(n_its)
    d = random_words(rng, n_its, 5, 4)
    d[0, 0] = 0
    d[n_its // 2, 1] = 0
    d[n_its - 1, 2] = 0
    d[:, 3] = 0
    got = logup._batch_inv_model(d)
    assert torch.equal(got, ef.inv64(d))
    assert not got[:, 3].any() and not got[0, 0].any() and got[1, 0].all()


def test_delayed_reduction_bounds():
    """The delayed sums stay below 2^64 at the largest words (p - 1
    everywhere: 4 products of (p - 1)^2 a coefficient, the W fold's
    reduced operand, a denominator's 4 fields before each reduction), and
    give the words of the reduced arithmetic."""
    top = [P - 1] * 4
    assert logup._mul_delayed(top, top) == ef.mul64(torch.tensor(top), torch.tensor(top)).tolist()
    with pytest.raises(AssertionError, match="2\\^64"):
        logup._reduce_wide(5 * (P - 1) ** 2)
    rng = np.random.default_rng(2)
    for a, b in zip(random_words(rng, 50, 4).tolist(), random_words(rng, 50, 4).tolist()):
        assert logup._mul_delayed(a, b) == ef.mul64(torch.tensor(a), torch.tensor(b)).tolist()
    for nf in (0, 1, 4, 5, 9):
        fields = torch.full((1, max(nf, 1), 1), P - 1, dtype=torch.int64)[:, :nf]
        bpows = torch.full((max(nf, 1), 4), P - 1, dtype=torch.int64)
        alpha, bus = torch.full((4,), P - 1, dtype=torch.int64), torch.tensor([P - 1])
        want = logup.batched_denoms(fields, bus, alpha, bpows)[0, 0].tolist()
        assert logup._denominator_delayed(top, P - 1, bpows.tolist(), [P - 1] * nf) == want


# (first field row, fields, chunk, is_send) tables: fields 0 to 9, one
# chunk, 12 chunks, sends and receives side by side in a chunk
PERM_LAYOUTS = {
    "mixed": [(0, 2, 0, 1), (3, 0, 0, 0), (4, 4, 1, 1), (9, 1, 2, 0), (11, 3, 2, 1)],
    "one_chunk": [(0, 9, 0, 0), (10, 1, 0, 1)],
    "twelve_chunks": [(3 * i, 2, i, i % 2) for i in range(12)],
}


def perm_layout(rows, shared: bool = False) -> logup.InteractionLayout:
    """Interactions over consecutive output rows; with ``shared``, every
    other field row read a second time by the next interactions (as
    interactions share DAG nodes)."""
    table = np.asarray(rows, dtype=np.int32)
    n_roots = int(max(r[0] + r[1] + 1 for r in rows))
    entries = np.arange(n_roots, dtype=np.int32)
    if shared:
        entries = np.where(entries % 2, entries // 2, entries)
    return logup.InteractionLayout(
        roots=list(range(n_roots)), rows=entries, table=table,
        bus_m=bb.to_monty_np(np.arange(1, len(rows) + 1, dtype=np.uint64) * 7),
        m=int(table[:, 2].max()) + 1, f_max=int(table[:, 1].max()))


@pytest.mark.parametrize("heights", [(70, 1, 300), (1, 129, 128)])
def test_perm_model_equals_plain(heights):
    """K9's launch over one job table of three AIRs (of 1 to 300 rows, so
    blocks of 128 rows end inside an AIR or on its end): delayed
    denominators, the batch inverse, signed chunk sums staged a row, the
    block's flat store.  Row 0 of the mixed AIR has a zero denominator
    (alpha = -bus of its field-less interaction 1): that interaction adds
    0, the others do not change.  The twelve-chunk AIR's interactions
    share output rows."""
    rng = np.random.default_rng(sum(heights))
    names = ("mixed", "one_chunk", "twelve_chunks")
    layouts = [perm_layout(PERM_LAYOUTS[k], shared=k == "twelve_chunks") for k in names]
    cols = [random_words(rng, len(lay.roots), n).int() for lay, n in zip(layouts, heights)]
    bpows = bb.to_monty_np(rng.integers(0, P, size=(9, 4), dtype=np.uint64))
    alpha = bb.to_monty_np(rng.integers(0, P, size=4, dtype=np.uint64))
    alpha[1:] = 0
    alpha[0] = P - int(layouts[0].bus_m[1])
    got = logup._perm_model(cols, layouts, alpha, bpows)
    want = logup.perm_cols_many(cols, layouts, alpha, bpows)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, c, lay in zip(got, cols, layouts):
        assert torch.equal(g, logup.perm_cols_plain(
            c, lay, torch.from_numpy(alpha.astype(np.int64)),
            torch.from_numpy(bpows.astype(np.int64))))


def test_perm_shape():
    """128 threads a block; shared memory for alpha, beta's powers (padded
    to 4 fields at a time) and a row of chunk sums a thread; fewer threads
    when the chunks grow, refused past shared memory."""
    assert logup.perm_shape(11, 9) == (128, 11, 13, (13 + 128 * 11) * 16)
    assert logup.perm_shape(12, 0)[:3] == (128, 13, 5)
    threads, stage_w, _, smem = logup.perm_shape(300, 9)
    assert threads == 32 and stage_w == 301 and smem <= qmod.SMEM_BYTES
    with pytest.raises(ValueError, match="chunks"):
        logup.perm_shape(500, 9)
