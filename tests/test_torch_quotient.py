"""The quotient interpreter (stark.quotient) against the JAX package's
DeviceOps evaluation and group_closure fold.

A seeded random SymbolicDag of about 200 nodes, with every op, every var
entry, offsets 0 and 1 and next_step 2, is evaluated on an 8-row quotient
domain two ways: the JAX package's DeviceOps (eagerly) and the port's
bytecode interpreter (plain version).  The alpha-folded, 1/Z_H-scaled
results must be equal word for word.
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


def test_bytecode_interpreter_equals_jax(case):
    nodes, roots, env, jfold = case
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    prog = quotient.compile_dag(
        dag, n_main=2, has_preprocessed=True, has_perm=True,
        publics=env["publics"], challenges=env["challenges"],
        exposed=env["exposed"])
    assert prog.sel_mask == 0b111 and prog.n_sources == 4
    ops = set(prog.code[:, 0].tolist())
    assert ops == set(range(19)), sorted(set(range(19)) - ops)
    # the interpreter reads bit-reversed LDE rows: store the natural-order
    # quotient-domain matrices bit-reversed, under extra rows it must skip
    rev = ntt.bitrev_perm(LOG_N + LQD)
    pad = np.full((N_Q, 1), 7, dtype=np.uint32)

    def lde(m):
        return bb.from_numpy(np.concatenate([m[rev], np.tile(pad, (1, m.shape[1]))]),
                             device="cpu")

    sources = [lde(m) for m in env["main"]] + [lde(env["preprocessed"]),
                                               lde(env["perm"])]
    alpha = bb.from_numpy(env["alpha"], device="cpu")
    got = quotient.evaluate(prog, sources, LOG_N, LQD, alpha)
    np.testing.assert_array_equal(jfold, bb.to_numpy(got))


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
              exposed=np.ones((1, 4), np.uint32))
    prog = quotient.compile_dag(dag, **kw)
    assert prog.n_slots < len(nodes) // 3
    monkeypatch.setattr(quotient, "MAX_SLOTS", prog.n_slots - 1)
    with pytest.raises(ValueError, match="slots"):
        quotient.compile_dag(dag, **kw)
