"""The quotient interpreter (stark.quotient) against the JAX package's
DeviceOps evaluation and group_closure fold.

A seeded random SymbolicDag of about 200 nodes, with every op, every var
entry, offsets 0 and 1 and next_step 2, is evaluated on an 8-row quotient
domain two ways: the JAX package's DeviceOps (eagerly) and the port's
bytecode interpreter (plain version).  The alpha-folded, 1/Z_H-scaled
results must be equal word for word.

The kernel's plan is held here too: the fold by powers of alpha against
Horner's, the typed slot files against the kernel's shared-memory limit,
the selector tables against the Fermat-inverse selectors, the job table's
map of blocks to (AIR, rows), and ``evaluate_many`` over AIRs of mixed
heights and quotient degrees.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu.field import ext as jef
from openvm_tpu.stark.evaluator import DeviceOps as JaxDeviceOps
from openvm_tpu.stark.prover import _selectors_on_domain
from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu_torch import ntt
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import quotient
from openvm_tpu_torch.field import ext as ef
from openvm_tpu_torch.stark import symbolic
from openvm_tpu_torch.stark.symbolic import SymbolicDag

torch.set_num_threads(1)

P = bb.P
LOG_N, LQD = 2, 1  # trace domain 4 rows, quotient domain 8, next_step 2
N_Q = 1 << (LOG_N + LQD)
MAIN_WIDTHS = (3, 2)


def random_dag(seed, n_ops=170):
    """Leaves of every kind, then n_ops random add/sub/mul/neg nodes whose
    operands mostly come from the last 24 nodes; about 20 roots."""
    rng = np.random.default_rng(seed)
    nodes = [("const", 0), ("const", 1), ("const", P - 1), ("const", 12345)]
    for part, w in enumerate(MAIN_WIDTHS):
        nodes += [("var", "main", part, off, c) for c in range(w)
                  for off in (0, 1)]
    nodes += [("var", "preprocessed", 0, off, c) for c in range(2)
              for off in (0, 1)]
    nodes += [("var", "permutation", 0, off, c) for c in range(2)
              for off in (0, 1)]
    nodes += [("var", "public", 0, 0, k) for k in range(3)]
    nodes += [("var", "challenge", 0, 0, k) for k in range(2)]
    nodes += [("var", "exposed", 0, 0, 0)]
    nodes += [("sel", s) for s in quotient.SELECTORS]
    n_leaves = len(nodes)
    for _ in range(n_ops):
        k = len(nodes)
        lo = max(0, k - 24) if rng.random() < 0.85 else 0
        a, b = (int(x) for x in rng.integers(lo, k, size=2))
        op = ["add", "sub", "mul", "mul", "neg"][int(rng.integers(0, 5))]
        nodes.append(("neg", a) if op == "neg" else (op, a, b))
    roots = sorted(int(x) for x in rng.choice(
        np.arange(n_leaves, len(nodes)), size=18, replace=False))
    # every typed operation, every selector and leaf kind, for certain
    at = {n: i for i, n in enumerate(nodes[:n_leaves])}
    main, perm = at[("var", "main", 1, 1, 0)], at[("var", "permutation", 0, 1, 1)]
    pub, ch = at[("var", "public", 0, 0, 2)], at[("var", "challenge", 0, 0, 1)]
    expo, prep = at[("var", "exposed", 0, 0, 0)], at[("var", "preprocessed", 0, 0, 1)]
    fixed = [("add", main, prep), ("sub", main, pub), ("mul", prep, main),
             ("neg", main), ("add", perm, ch), ("sub", ch, perm),
             ("mul", perm, expo), ("neg", perm), ("add", main, ch),
             ("add", expo, pub), ("sub", perm, main), ("sub", pub, ch),
             ("mul", main, perm), ("mul", ch, prep)]
    fixed += [("mul", at[("sel", s)], perm) for s in quotient.SELECTORS]
    roots += list(range(len(nodes), len(nodes) + len(fixed)))
    nodes += fixed
    # sums and differences that take over a product only they use, with an
    # other operand that dies there (fused) or lives on (ch: not fused)
    for mk in (lambda c, m: ("add", c, m), lambda c, m: ("sub", c, m),
               lambda c, m: ("sub", m, c), lambda c, m: ("add", m, c),
               lambda c, m: ("add", ch, m)):
        nodes.append(("sub", expo, perm))
        nodes.append(("mul", main, perm))
        nodes.append(mk(len(nodes) - 2, len(nodes) - 1))
        roots.append(len(nodes) - 1)
    roots += [2, n_leaves - 1, roots[0]]  # leaves and a repeated root
    return nodes, roots


def random_env(seed):
    rng = np.random.default_rng(seed)

    def words(*shape):
        return bb.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64))

    return {"main": [words(N_Q, w) for w in MAIN_WIDTHS],
            "preprocessed": words(N_Q, 2), "perm": words(N_Q, 8),
            "publics": words(3), "challenges": words(2, 4),
            "exposed": words(1, 4), "alpha": words(4)}


def _jax_fold(dag, env):
    sels = _selectors_on_domain(LOG_N, LOG_N + LQD, bb.GENERATOR)
    jenv = {"main": [jnp.asarray(m) for m in env["main"]],
            "preprocessed": jnp.asarray(env["preprocessed"]),
            "perm": jnp.asarray(env["perm"]),
            "publics": jnp.asarray(env["publics"]),
            "challenges": jnp.asarray(env["challenges"]),
            "exposed": jnp.asarray(env["exposed"]), "sels": sels,
            "next_step": 1 << LQD}
    vals = dag.eval(JaxDeviceOps, jenv, roots=dag.constraint_roots)
    alpha = jnp.asarray(env["alpha"])
    acc = jef.zeros((N_Q,))
    for r in dag.constraint_roots:
        tag, v = vals[r]
        acc = jef.mul(acc, jnp.broadcast_to(alpha, acc.shape))
        v = jef.from_base(jnp.broadcast_to(v, (N_Q,))) if tag == "b" else \
            jnp.broadcast_to(v, (N_Q, 4))
        acc = jef.add(acc, v)
    return np.asarray(jef.scale(acc, sels["inv_zeroifier"]))


@pytest.fixture(scope="module")
def case():
    nodes, roots = random_dag(0)
    env = random_env(1)
    jfold = _jax_fold(JaxDag(nodes=nodes, constraint_roots=roots), env)
    return nodes, roots, env, jfold


def _lde(m):
    """A natural-order quotient-domain matrix stored bit-reversed, as the
    interpreter reads an LDE, under extra rows it must skip."""
    rev = ntt.bitrev_perm(int(m.shape[0]).bit_length() - 1)
    pad = np.full((m.shape[0], m.shape[1]), 7, dtype=np.uint32)
    return bb.from_numpy(np.concatenate([m[rev], pad]), device="cpu")


def test_bytecode_interpreter_equals_jax(case):
    nodes, roots, env, jfold = case
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    prog = quotient.compile_dag(
        dag, n_main=2, has_preprocessed=True, has_perm=True,
        publics=env["publics"], challenges=env["challenges"],
        exposed=env["exposed"], alpha=env["alpha"])
    assert prog.sel_mask == 0b111 and prog.n_sources == 4
    ops = set(prog.code[:, 0].tolist())
    want = set(range(25)) - {quotient.STORE_B}
    assert ops == want, sorted(want ^ ops)
    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    got = quotient.evaluate(prog, sources, LOG_N, LQD)
    np.testing.assert_array_equal(jfold, bb.to_numpy(got))


def _horner(prog_for, sources, alpha, roots):
    """acc * alpha + v_k over the roots, each root's v_k / Z_H from a
    one-root program (its fold is alpha^0 v_k)."""
    acc = torch.zeros((N_Q, 4), dtype=torch.int64)
    for r in roots:
        v = quotient.evaluate_plain(prog_for([r]), sources, LOG_N, LQD).long()
        acc = bb.add64(ef.mul64(acc, alpha.long().expand(N_Q, 4)), v)
    return acc.int()


@pytest.mark.parametrize("pick", ["one_base", "one_ext", "mixed"])
def test_alpha_power_fold_equals_horner(case, pick):
    """Root k of R folded as alpha^(R-1-k) v_k equals Horner's fold, for
    R = 1 and for base and extension roots mixed (v / Z_H is linear, so
    folding the scaled values is the same)."""
    nodes, roots, env, _ = case
    full = SymbolicDag(nodes=nodes, constraint_roots=roots)
    tags = quotient._reachable_tags(full, roots)
    base = [r for r in roots if tags[r] == "b"]
    ext = [r for r in roots if tags[r] == "e"]
    chosen = {"one_base": base[:1], "one_ext": ext[:1],
              "mixed": roots}[pick]
    assert chosen and (pick != "mixed" or (base and ext))

    def prog_for(rs):
        return quotient.compile_dag(
            SymbolicDag(nodes=nodes, constraint_roots=list(rs)), n_main=2,
            has_preprocessed=True, has_perm=True, publics=env["publics"],
            challenges=env["challenges"], exposed=env["exposed"],
            alpha=env["alpha"])

    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    alpha = bb.from_numpy(env["alpha"], device="cpu")
    got = quotient.evaluate_plain(prog_for(chosen), sources, LOG_N, LQD)
    want = _horner(prog_for, sources, alpha, chosen)
    np.testing.assert_array_equal(bb.to_numpy(got), bb.to_numpy(want))


def test_alpha_powers():
    rng = np.random.default_rng(9)
    alpha = bb.to_monty_np(rng.integers(0, P, 4))
    pows = quotient.alpha_powers(alpha, 5)
    a = torch.from_numpy(alpha.astype(np.int64))
    want = torch.from_numpy(bb.to_monty_np(np.asarray([1, 0, 0, 0])).astype(np.int64))
    for k in range(5):
        assert pows[k].tolist() == want.tolist()
        want = ef.mul64(want, a)


@pytest.mark.parametrize("log_n,log_domain", [(2, 2), (3, 4), (4, 5)])
def test_selectors_equal_jax(log_n, log_domain):
    want = _selectors_on_domain(log_n, log_domain, bb.GENERATOR)
    got = quotient.selectors_on_domain(log_n, log_domain, bb.GENERATOR, "cpu")
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), bb.to_numpy(got[k]))


def test_zerofier_table_matches_selectors():
    tab = quotient._zh_table(LOG_N, LQD)
    inv = quotient.selectors_on_domain(LOG_N, LOG_N + LQD, bb.GENERATOR,
                                       "cpu")["inv_zeroifier"]
    q = 1 << LQD
    for j in range(N_Q):
        assert int(tab[q + j % q]) == int(bb.to_numpy(inv[j]))


def test_compile_reuses_slots_and_refuses_too_many(monkeypatch):
    nodes, roots = random_dag(3)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    kw = dict(n_main=2, has_preprocessed=True, has_perm=True,
              publics=[1, 2, 3], challenges=np.ones((2, 4), np.uint32),
              exposed=np.ones((1, 4), np.uint32), alpha=np.ones(4, np.uint32))
    prog = quotient.compile_dag(dag, **kw)
    assert prog.n_base + prog.n_ext < len(nodes) // 3
    monkeypatch.setattr(quotient, "max_lane_words", lambda n: prog.lane_words - 1)
    with pytest.raises(ValueError, match="slot words"):
        quotient.compile_dag(dag, **kw)


@pytest.mark.parametrize("seed", range(4, 10))
def test_typed_slots_fit_the_kernel_plan(seed):
    """Base values take one word and extension values four; every random
    program fits the kernel's shared memory beside its code with a block of
    at least 32 threads, and each opcode writes the slot file of its
    result's type."""
    nodes, roots = random_dag(seed, n_ops=400)
    prog = quotient.compile_dag_code(
        SymbolicDag(nodes=nodes, constraint_roots=roots), n_main=2,
        has_preprocessed=True, has_perm=True)
    n = int(prog.code.shape[0])
    assert prog.lane_words <= quotient.max_lane_words(n)
    t = quotient.block_threads(prog.lane_words, n)
    assert t in quotient.THREADS
    assert prog.lane_words * 4 * t + 16 * n <= quotient.SMEM_BYTES
    assert prog.lane_words == prog.n_base + 4 * prog.n_ext and prog.n_base
    kinds = {"b": set(), "e": set()}
    for op, d, a, b in prog.code.tolist():
        if op in (quotient.CONST_B, quotient.LOAD_B, quotient.SEL,
                  quotient.ADD_BB, quotient.SUB_BB, quotient.MUL_BB,
                  quotient.NEG_B):
            kinds["b"].add(d)
        elif op not in (quotient.FOLD_B, quotient.FOLD_E, quotient.STORE_B,
                        quotient.MULFOLD_BB, quotient.SUBFOLD_EE):
            kinds["e"].add(d)
    assert max(kinds["b"]) < prog.n_base and max(kinds["e"]) < prog.n_ext


def test_batch_inverse():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(1, P, size=64))
    np.testing.assert_array_equal((quotient.batch_inv64(x) * x % P).numpy(),
                                  np.ones(64, dtype=np.int64))


@pytest.mark.parametrize("log_n,lqd", [(0, 1), (2, 0), (2, 1), (3, 2)])
def test_selector_table_equals_selectors(log_n, lqd):
    """The kernel's selector tables (LDE order, batch inverses) equal the
    Fermat-inverse selectors taken in the same order."""
    log_q = log_n + lqd
    sels = quotient.selectors_on_domain(log_n, log_q, bb.GENERATOR, "cpu")
    rev = ntt.bitrev_perm(log_q)
    tab = quotient.selector_table(log_n, lqd, "cpu")
    for k, name in enumerate(("is_first_row", "is_last_row")):
        np.testing.assert_array_equal(bb.to_numpy(tab[k]),
                                      bb.to_numpy(sels[name])[rev])


@pytest.mark.parametrize("lanes", [64, 256])
def test_block_plan_covers_every_row_once(lanes):
    """The kernel's map of blocks to (AIR, rows), modelled: heights 2^1 to
    2^12 and a repeat, largest first; every row of every job is evaluated
    by exactly one block."""
    heights = [1 << k for k in (3, 1, 12, 5, 9, 7, 12, 2, 10, 4, 6, 8, 11)]
    order, first, total = quotient.block_plan(heights, lanes)
    ordered = [heights[k] for k in order]
    assert ordered == sorted(heights, reverse=True)
    seen = [np.zeros(h, dtype=np.int64) for h in heights]
    for b in range(total):
        pos, rows = quotient.block_rows(first, ordered, b, lanes)
        assert rows, f"block {b} evaluates no row"
        seen[order[pos]][rows] += 1
    assert all((s == 1).all() for s in seen)


class _Fib(symbolic.Air):
    name, width, num_public_values = "fib", 2, 3

    def eval(self, b):
        a, c = b.main(0), b.main(1)
        with b.when_first_row():
            b.assert_eq(a, b.public_value(0))
        with b.when_transition():
            b.assert_eq(b.main(0, offset=1), c)
            b.assert_eq(b.main(1, offset=1), a + c)
        with b.when_last_row():
            b.assert_eq(c, b.public_value(2))


class _Cube(symbolic.Air):
    name, width, num_public_values = "cube", 1, 2

    def eval(self, b):
        x, y = b.main(0), b.main(0, part=0)
        with b.when_first_row():
            b.assert_eq(x, b.public_value(0))
        with b.when_transition():
            b.assert_eq(b.main(0, offset=1), x * y * x + b.preprocessed(0))
        with b.when_last_row():
            b.assert_eq(x, b.public_value(1))


def _dag(air):
    builder = symbolic.AirBuilder(air)
    air.eval(builder)
    return SymbolicDag.from_builder(builder)


def test_evaluate_many_mixed_heights_equal_per_air_and_jax():
    """FibonacciAir at 2^3 and 2^1 (lqd 0), CubeAir at 2^2 and 2^1 (lqd 1,
    a preprocessed and a cached part): ``evaluate_many`` equals each AIR's
    ``evaluate_plain`` and, for FibonacciAir at 2^1, JAX's fold."""
    rng = np.random.default_rng(12)

    def words(*shape):
        return bb.to_monty_np(rng.integers(0, P, size=shape, dtype=np.uint64))

    alpha = words(4)
    fib, cube = _dag(_Fib()), _dag(_Cube())
    specs = [(fib, 3, 0, [2]), (cube, 2, 1, [1, 1, 1]), (fib, 1, 0, [2]),
             (cube, 1, 1, [1, 1, 1])]
    progs, sources, mats, pubs = [], [], [], []
    for dag, log_n, lqd, widths in specs:
        cube_like = len(widths) == 3
        pubs.append(words(3))
        progs.append(quotient.compile_dag(
            dag, n_main=2 if cube_like else 1, has_preprocessed=cube_like,
            has_perm=False, publics=pubs[-1], alpha=alpha))
        ms = [words(1 << (log_n + lqd), w) for w in widths]
        mats.append(ms)
        sources.append([_lde(m) for m in ms])
    log_ns = [s[1] for s in specs]
    lqds = [s[2] for s in specs]
    got = quotient.evaluate_many(progs, sources, log_ns, lqds)
    for g, p, s, n, q in zip(got, progs, sources, log_ns, lqds):
        np.testing.assert_array_equal(
            bb.to_numpy(g), bb.to_numpy(quotient.evaluate_plain(p, s, n, q)))
    # JAX's DeviceOps and Horner fold for FibonacciAir at 2^1
    log_n = 1
    sels = _selectors_on_domain(log_n, log_n, bb.GENERATOR)
    jenv = {"main": [jnp.asarray(mats[2][0])], "preprocessed": None,
            "perm": None, "publics": jnp.asarray(pubs[2]), "challenges": None, "exposed": None, "sels": sels, "next_step": 1}
    jdag = JaxDag(nodes=fib.nodes, constraint_roots=fib.constraint_roots)
    vals = jdag.eval(JaxDeviceOps, jenv, roots=fib.constraint_roots)
    acc = jef.zeros((2,))
    for r in fib.constraint_roots:
        tag, v = vals[r]
        acc = jef.mul(acc, jnp.broadcast_to(jnp.asarray(alpha), acc.shape))
        acc = jef.add(acc, jef.from_base(jnp.broadcast_to(v, (2,))) if tag == "b"
                      else jnp.broadcast_to(v, (2, 4)))
    want = np.asarray(jef.scale(acc, sels["inv_zeroifier"]))
    np.testing.assert_array_equal(want, bb.to_numpy(got[2]))
