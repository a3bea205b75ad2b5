"""The quotient interpreter (stark.quotient) against the JAX package's
DeviceOps evaluation and group_closure fold.

A seeded random SymbolicDag of about 200 nodes, with every op, every var
entry, offsets 0 and 1 and next_step 2, is evaluated on an 8-row quotient
domain two ways: the JAX package's DeviceOps (eagerly) and the port's
bytecode interpreter (plain version).  The alpha-folded, 1/Z_H-scaled
results must be equal word for word: tests/test_torch_quotient_jax.py
holds that, in a file of its own (the eager DeviceOps take about 6 s).

The kernel's plan is held here too: the fold by powers of alpha against
Horner's, the typed slot files against the kernel's shared-memory limit,
the selector tables against the Fermat-inverse selectors, the job table's
map of blocks to (AIR, rows), and ``evaluate_many`` over AIRs of mixed
heights and quotient degrees.

A program that does not fit the shared launch is compiled at a budget of
slot words a row, loading its cells, constants and selectors again rather
than holding them: a leaf-heavy DAG at budgets of a few words gives the
same words as without one, every program that fits the shared launch
compiles to the code it compiled to before budgets (pinned by SHA-256: random
DAGs and the VM's AIRs of paths 3 and 4), and the large AIRs (keccakf,
keccak_sponge, modular_muldiv, sw_add_ne, sw_double and fp2_muldiv built as
the JAX package's keygen builds them; sha256's two and Poseidon2Air from the
port) compile within the budget and go to the streamed launch.  keccakf's
and sw_double's budgeted quotient values on a 4-row domain equal the JAX
package's HostOps (tests/test_torch_quotient_jax.py) and its DeviceOps
(here, under OPENVM_SLOW).
"""

import functools
import hashlib
import os
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu.field import ext as jef
from openvm_tpu.stark.evaluator import DeviceOps as JaxDeviceOps, HostOps
from openvm_tpu.stark.logup import append_logup_constraints as jax_append_logup
from openvm_tpu.stark.prover import _selectors_on_domain
from openvm_tpu.stark.symbolic import AirBuilder as JaxAirBuilder
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
    return nodes, roots, random_env(1)


def _lde(m):
    """A natural-order quotient-domain matrix stored bit-reversed, as the
    interpreter reads an LDE, under extra rows it must skip."""
    rev = ntt.bitrev_perm(int(m.shape[0]).bit_length() - 1)
    pad = np.full((m.shape[0], m.shape[1]), 7, dtype=np.uint32)
    return bb.from_numpy(np.concatenate([m[rev], pad]), device="cpu")


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
    nodes, roots, env = case
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
    """Slots are reused; a program past the shared launch's plan is
    compiled at the budget instead, gives the same words, and goes to the
    streamed launch."""
    nodes, roots = random_dag(3)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    env = random_env(4)
    kw = dict(n_main=2, has_preprocessed=True, has_perm=True,
              publics=env["publics"], challenges=env["challenges"],
              exposed=env["exposed"], alpha=env["alpha"])
    prog = quotient.compile_dag(dag, **kw)
    assert prog.n_base + prog.n_ext < len(nodes) // 3
    assert prog.budget == 0 and prog.reloads == 0
    monkeypatch.setattr(quotient, "max_lane_words", lambda n: prog.lane_words - 1)
    big = quotient.compile_dag(dag, **kw)
    assert big.budget == quotient.BUDGET and big.lane_words <= quotient.BUDGET
    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    np.testing.assert_array_equal(
        bb.to_numpy(quotient.evaluate_plain(big, sources, LOG_N, LQD)),
        bb.to_numpy(quotient.evaluate_plain(prog, sources, LOG_N, LQD)))
    plan = quotient.launch_plan([prog, big, prog])
    assert [(idx, streamed, code) for idx, streamed, _, code, _ in plan] == [
        ([0, 2], False, int(prog.code.shape[0])), ([1], True, quotient.CODE_RING)]


def leafy_dag(seed, n_roots=120):
    """random_dag's leaves (every kind) and short roots over leaves picked
    anywhere, so that every leaf is read all through the program."""
    nodes, _ = random_dag(seed, n_ops=18)
    n_leaves = sum(1 for n in nodes if n[0] in ("const", "var", "sel"))
    nodes = nodes[:n_leaves]
    rng = np.random.default_rng(seed)
    roots = []
    for _ in range(n_roots):
        a, b, c = (int(x) for x in rng.integers(0, n_leaves, size=3))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            nodes += [("mul", a, b), ("add", len(nodes), c)]
        elif kind == 1:
            nodes += [("mul", b, c), ("sub", a, len(nodes))]
        elif kind == 2:
            nodes.append(("sub", a, b))
        else:
            nodes += [("neg", a), ("mul", len(nodes), c)]
        roots.append(len(nodes) - 1)
    return nodes, roots


LEAF_OPS = (quotient.CONST_B, quotient.CONST_E, quotient.LOAD_B, quotient.LOAD_E,
            quotient.SEL)


@pytest.mark.parametrize("budget", [16, 20, 32])
def test_budget_reloads_give_the_same_words(budget):
    """A leaf-heavy DAG compiled at a budget of a few words a row loads
    its leaves again (at 16 words every kind of leaf), stays within the
    budget, gives the words it gives without one, through a plain
    interpreter in which base and extension values overlap as they do in
    the kernel's one word file; and apart from the reloads its
    instructions are the unbudgeted program's, in order, with its pool."""
    nodes, roots = leafy_dag(0)
    env = random_env(1)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    kw = dict(n_main=2, has_preprocessed=True, has_perm=True,
              publics=env["publics"], challenges=env["challenges"],
              exposed=env["exposed"], alpha=env["alpha"])
    free = quotient.compile_dag(dag, **kw)
    prog = quotient.compile_dag(dag, budget=budget, **kw)
    assert free.budget == 0 and free.lane_words > 32
    assert prog.budget == budget and prog.lane_words <= budget and prog.reloads
    assert len(prog.code) == len(free.code) + prog.reloads
    np.testing.assert_array_equal(prog.pool, free.pool)
    ops = prog.code[:, 0] & quotient.OPCODE
    reloaded = {int(o) for o in LEAF_OPS
                if (ops == o).sum() > (free.code[:, 0] == o).sum()}
    assert budget != 16 or reloaded == set(LEAF_OPS)
    computed = ~np.isin(ops, LEAF_OPS)
    np.testing.assert_array_equal(
        ops[computed], free.code[~np.isin(free.code[:, 0], LEAF_OPS), 0])
    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    np.testing.assert_array_equal(
        bb.to_numpy(quotient.evaluate_plain(prog, sources, LOG_N, LQD)),
        bb.to_numpy(quotient.evaluate_plain(free, sources, LOG_N, LQD)))


@pytest.mark.parametrize("budget", [12, 32])
def test_budget_spills_give_the_same_words(budget):
    """The random DAG's computed values, mostly extension values, take
    over 130 words a row; at a budget of 12 or 32 words the compiler
    stores the ones read again farthest ahead in the spill file and loads
    them back (SPILL, FILL), and the words are those without a budget."""
    nodes, roots = random_dag(0)
    env = random_env(1)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    kw = dict(n_main=2, has_preprocessed=True, has_perm=True,
              publics=env["publics"], challenges=env["challenges"],
              exposed=env["exposed"], alpha=env["alpha"])
    free = quotient.compile_dag(dag, **kw)
    prog = quotient.compile_dag(dag, budget=budget, **kw)
    ops = prog.code[:, 0] & quotient.OPCODE
    fills = prog.code[ops == quotient.FILL]
    assert prog.lane_words <= budget < free.lane_words
    assert prog.spills == (ops == quotient.SPILL).sum() > 0 and len(fills) >= prog.spills
    assert prog.n_spill > 0 and fills[:, 2].max() + 4 * fills[:, 3].max() <= prog.n_spill
    moved = np.isin(ops, LEAF_OPS + (quotient.SPILL, quotient.FILL))
    np.testing.assert_array_equal(
        ops[~moved], free.code[~np.isin(free.code[:, 0], LEAF_OPS), 0])
    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    np.testing.assert_array_equal(
        bb.to_numpy(quotient.evaluate_plain(prog, sources, LOG_N, LQD)),
        bb.to_numpy(quotient.evaluate_plain(free, sources, LOG_N, LQD)))


def test_loads_run_ahead_of_their_reads(monkeypatch):
    """A budgeted program's loads move ahead of where the compiler emitted
    them (the same instructions, loads earlier), and the first instruction
    to touch a load's slot waits (WAIT).  The plain interpreter writes a
    load into its slot only at the next WAIT, as the streamed launch may:
    the same program without its WAITs fails there."""
    nodes, roots = leafy_dag(0)
    env = random_env(1)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    kw = dict(n_main=2, has_preprocessed=True, has_perm=True,
              publics=env["publics"], challenges=env["challenges"],
              exposed=env["exposed"], alpha=env["alpha"])
    prog = quotient.compile_dag(dag, budget=16, **kw)
    bare = prog.code & [quotient.OPCODE, -1, -1, -1]
    waits = prog.code[:, 0] & quotient.WAIT
    loads = np.isin(bare[:, 0], (quotient.LOAD_B, quotient.LOAD_E))
    assert waits.any() and not (waits & loads).any()
    monkeypatch.setattr(quotient, "_schedule_loads", lambda code: code)
    emitted = quotient.compile_dag(dag, budget=16, **kw).code
    assert sorted(map(tuple, emitted.tolist())) == sorted(map(tuple, bare.tolist()))
    np.testing.assert_array_equal(bare[~loads], emitted[~np.isin(
        emitted[:, 0], (quotient.LOAD_B, quotient.LOAD_E))])
    first = [k for k in range(len(bare)) if loads[k]]
    assert first != [k for k in range(len(emitted)) if emitted[k, 0] in (
        quotient.LOAD_B, quotient.LOAD_E)], "no load moved"
    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    with pytest.raises(TypeError):
        quotient.evaluate_plain(replace(prog, code=bare), sources, LOG_N, LQD)


def _code_sha(prog) -> str:
    return hashlib.sha256(prog.code.tobytes() + np.asarray(
        [prog.n_base, prog.n_ext], np.int64).tobytes()).hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def _vm_airs() -> dict:
    """The port's AIRs of paths 3 to 7 by name (volatile and persistent
    system AIRs, FIB_EXECUTORS, keccak, sha256, int256 and the modular
    chips of secp256k1's prime), without a keygen."""
    from openvm_tpu_torch.vm.guest import FIB_EXECUTORS
    from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine
    airs = {}
    for cfg in (Rv32Config(executors=FIB_EXECUTORS),
                Rv32Config(executors=FIB_EXECUTORS, persistent=True, sha256=True),
                Rv32Config(executors=FIB_EXECUTORS, bigint=True, moduli=(SECP_P,))):
        for air in VirtualMachine(cfg, device="cpu").airs:
            airs.setdefault(air.name, air)
    return airs


@functools.lru_cache(maxsize=None)
def _vm_air_program(name):
    """An AIR's quotient program as the port's keygen and prover compile it
    (AirBuilder, LogUp at degree 3, ``compile_dag_code``)."""
    from openvm_tpu_torch.stark.logup import append_logup_constraints
    air = _vm_airs()[name]
    builder = symbolic.AirBuilder(air)
    air.eval(builder)
    has_perm = bool(builder.interactions)
    append_logup_constraints(builder, 3)
    return quotient.compile_dag_code(
        SymbolicDag.from_builder(builder), n_main=1 + len(air.cached_main_widths),
        has_preprocessed=air.preprocessed_trace() is not None, has_perm=has_perm)


# SHA-256 (first 16 hex digits) of the code and slot counts each program
# compiled to before budgets; every one fits the shared launch, so it must
# compile to the same code now
SHARED_CODE = {
    "dag4": "72a45b36238b319c", "dag5": "5777a960830b0c0f", "dag6": "492a1b1ac6a39519",
    "dag7": "fee758627cfc98e1", "dag8": "93a0c02b76db5e9e", "dag9": "debb7cbd76798546",
    "program": "f6af3a0b9f177156", "connector": "a12f1963d82e8aa5",
    "public_values": "1df7fa94fde6111a", "memory_boundary": "40212afee1967a98",
    "range_checker": "9b0faa18aeb57f43", "bitwise_lookup": "bfd6092de782f4fa",
    "phantom": "93a592262d31384b", "rv32_base_alu": "5952b5c00ea19de2",
    "rv32_less_than": "cbc29b6800e865e4", "rv32_branch_eq": "326d7665ffb3b918",
    "rv32_branch_lt": "8386880eae082cd9", "rv32_jal_lui": "db98551d8ce5d179",
    "rv32_jalr": "da771441975c7210", "rv32_auipc": "e9377ca8a25cc849",
    "rv32_load_store": "0e11c638a500ee3c", "persistent_boundary": "d04d007fe8cf3c92",
    "memory_merkle": "4c9343ff21010399"}


@pytest.mark.parametrize("name", list(SHARED_CODE))
def test_shared_programs_compile_as_before(name):
    if name.startswith("dag"):
        nodes, roots = random_dag(int(name[3:]), n_ops=400)
        prog = quotient.compile_dag_code(SymbolicDag(nodes=nodes, constraint_roots=roots),
                                         n_main=2, has_preprocessed=True, has_perm=True)
    else:
        prog = _vm_air_program(name)
    assert prog.budget == 0 and prog.reloads == 0
    assert prog.lane_words <= quotient.max_lane_words(int(prog.code.shape[0]))
    assert _code_sha(prog) == SHARED_CODE[name]


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


def _naive_root_order(dag, roots):
    """The greedy fold order by rescanning every cone each step."""
    cones = [quotient._cone(dag, r) for r in roots]
    uses: dict = {}
    for c in cones:
        for n in c:
            uses[n] = uses.get(n, 0) + 1
    done: set = set()
    order, left = [], list(range(len(roots)))
    while left:
        k = min(left, key=lambda k: (len(cones[k] - done),
                                     -sum(1 for n in cones[k] if uses[n] == 1)))
        order.append(k)
        left.remove(k)
        done |= cones[k]
        for n in cones[k]:
            uses[n] -= 1
    return order


@pytest.mark.parametrize("seed", [0, 3, 21])
def test_root_order_equals_the_greedy_rescan(seed):
    """The heap's lazily updated keys give the same order as rescanning
    every remaining root's cone at each step (repeated roots included)."""
    nodes, roots = random_dag(seed, n_ops=300)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    assert quotient._root_order(dag, roots) == _naive_root_order(dag, roots)


# ---------------------------------------------------------------------------
# F1: programs too large for shared memory
# ---------------------------------------------------------------------------

SECP_P = (1 << 256) - (1 << 32) - 977
BN254_P = int("21888242871839275222246405745257275088696311157297823662689037894645226208583")
# (AIR, instructions, slot words a row, reloads, spills) of the JAX
# configs' chips that the shared launch cannot hold, compiled at the budget
EXTENSION_AIRS = {"keccakf": (71568, 48, 15194, 93), "keccak_sponge": (14993, 48, 2493, 411),
                  "modular_muldiv_0": (13252, 48, 4053, 46),
                  "sw_add_ne_0": (26865, 48, 5378, 552), "sw_double_0": (30512, 48, 7269, 592),
                  "fp2_muldiv_0": (45093, 48, 17268, 67)}
# the same of the port's sha256 chips and Poseidon2Air (paths 6 and 4), and
# of its int256 chips and the modular chips modular_muldiv_0 is not pinned
# above for (path 7)
LARGE_VM_AIRS = {"sha256": (7734, 48, 1396, 45), "sha256_sponge": (6725, 48, 1125, 184),
                 "poseidon2": (4181, 48, 301, 111),
                 "int256_alu": (4292, 48, 624, 194), "int256_lt": (3221, 48, 465, 72),
                 "int256_mul": (3866, 48, 621, 34), "int256_beq": (1620, 48, 221, 45),
                 "int256_blt": (2004, 48, 290, 19), "int256_shift": (8247, 48, 1227, 43),
                 "modular_addsub_0": (2960, 48, 389, 34), "modular_iseq_0": (2920, 48, 430, 53)}


@functools.lru_cache(maxsize=None)
def _extension(name):
    """(air, JAX DAG, the port's DAG, its code), the DAG built as the JAX
    package's keygen builds it: AirBuilder + append_logup_constraints at
    degree 3."""
    from openvm_tpu.vm.circuit.bigint import Shift256Air
    from openvm_tpu.vm.circuit.ecc import EcAddNeAir, EcDoubleAir
    from openvm_tpu.vm.circuit.fp2 import Fp2MulDivAir
    from openvm_tpu.vm.circuit.keccak import KeccakfAir, KeccakVmAir
    from openvm_tpu.vm.circuit.modular import ModularMulDivAir
    air = {"keccakf": KeccakfAir, "keccak_sponge": KeccakVmAir,
           "modular_muldiv_0": lambda: ModularMulDivAir(SECP_P, 0),
           "sw_add_ne_0": lambda: EcAddNeAir(SECP_P, 0, 0),
           "sw_double_0": lambda: EcDoubleAir(SECP_P, 0, 0),
           "fp2_muldiv_0": lambda: Fp2MulDivAir(BN254_P, 0),
           "int256_shift": Shift256Air}[name]()
    builder = JaxAirBuilder(air)
    air.eval(builder)
    jax_append_logup(builder, 3)
    jdag = JaxDag.from_builder(builder)
    dag = SymbolicDag(nodes=jdag.nodes, constraint_roots=jdag.constraint_roots,
                      interactions=jdag.interactions)
    prog = quotient.compile_dag_code(
        dag, n_main=1 + len(air.cached_main_widths),
        has_preprocessed=air.preprocessed_trace() is not None,
        has_perm=bool(jdag.interactions))
    return air, jdag, dag, prog


@pytest.mark.parametrize("name", list(EXTENSION_AIRS) + list(LARGE_VM_AIRS))
def test_large_air_compiles_within_the_budget(name):
    """Each large AIR compiles within BUDGET slot words a row and goes to
    the streamed launch, beside path 3's programs in the shared launch,
    whose plan it leaves as it was (rv32_load_store's code and
    memory_merkle's slots size it)."""
    prog = _extension(name)[3] if name in EXTENSION_AIRS else _vm_air_program(name)
    n_instr = int(prog.code.shape[0])
    assert (n_instr, prog.lane_words, prog.reloads, prog.spills) == {
        **EXTENSION_AIRS, **LARGE_VM_AIRS}[name]
    assert prog.budget == quotient.BUDGET and prog.lane_words <= quotient.BUDGET
    assert (prog.lane_words * 4 * quotient.THREADS[0] + 16 * quotient.CODE_RING
            <= quotient.SMEM_BYTES)
    shared = [_vm_air_program(n) for n in ("rv32_load_store", "memory_merkle")]
    plan = quotient.launch_plan(shared + [prog])
    assert plan == [([0, 1], False, 198, 564, 128),
                    ([2], True, prog.lane_words, quotient.CODE_RING,
                     quotient.block_threads(prog.lane_words, quotient.CODE_RING))]
    assert plan[0][1:] == quotient.launch_plan(shared)[0][1:]


def _host_ops_quotient(air, jdag, env_words, log_n, lqd, ops=HostOps):
    """The alpha-folded constraints over Z_H at each natural row of the
    quotient domain, through the JAX package's HostOps (canonical ints)."""
    log_q = log_n + lqd
    nq = 1 << log_q
    sels = quotient.selectors_on_domain(log_n, log_q, bb.GENERATOR, "cpu")
    sel_c = {k: bb.to_numpy(bb.from_monty_plain(v)).tolist() for k, v in sels.items()}

    def ext(row):
        return [tuple(int(x) for x in row[4 * i:4 * i + 4]) for i in range(len(row) // 4)]

    alpha = tuple(env_words["alpha"].tolist())
    out = []
    for j in range(nq):
        nxt = (j + (1 << lqd)) % nq
        env = {"main": [([(int(x), 0, 0, 0) for x in m[j]],
                         [(int(x), 0, 0, 0) for x in m[nxt]]) for m in env_words["main"]],
               "preprocessed": None,
               "perm": (ext(env_words["perm"][j]), ext(env_words["perm"][nxt]))
               if env_words["perm"] is not None else None,
               "publics": env_words["publics"].tolist(),
               "challenges": [tuple(c) for c in env_words["challenges"].tolist()],
               "exposed": [tuple(c) for c in env_words["exposed"].tolist()],
               "sels": {k: (v[j], 0, 0, 0) for k, v in sel_c.items()}}
        vals = jdag.eval(ops, env, roots=jdag.constraint_roots)
        acc = (0, 0, 0, 0)
        for r in jdag.constraint_roots:
            acc = tuple(int(x) for x in
                        np.asarray(ops.add(ops.mul(acc, alpha), vals[r])) % P)
        z = sel_c["inv_zeroifier"][j]
        out.append([a * z % P for a in acc])
    return np.asarray(out, dtype=np.uint64)


def _extension_case(name, seed):
    """A random 2-row trace of the AIR (lqd 1: a 4-row quotient domain):
    canonical words for HostOps, and the port's plain quotient of the
    AIR's program over the same values stored as LDEs."""
    air, jdag, dag, prog = _extension(name)
    rng = np.random.default_rng(seed)
    log_n, lqd = 1, 1
    nq = 1 << (log_n + lqd)
    widths = list(air.cached_main_widths) + [air.width]
    n_perm = 4 * (len(jdag.interactions) and max(
        (n[4] for n in jdag.nodes if n[0] == "var" and n[1] == "permutation"),
        default=-1) + 1)
    n_pub = 1 + max((n[4] for n in jdag.nodes if n[0] == "var" and n[1] == "public"),
                    default=-1)
    canon = {"main": [rng.integers(0, P, size=(nq, w), dtype=np.uint64) for w in widths],
             "perm": rng.integers(0, P, size=(nq, n_perm), dtype=np.uint64)
             if n_perm else None,
             "publics": rng.integers(0, P, size=n_pub, dtype=np.uint64),
             "challenges": rng.integers(0, P, size=(2, 4), dtype=np.uint64),
             "exposed": rng.integers(0, P, size=(1, 4), dtype=np.uint64),
             "alpha": rng.integers(0, P, size=4, dtype=np.uint64)}
    bound = quotient.bind(prog, publics=bb.to_monty_np(canon["publics"]),
                          challenges=bb.to_monty_np(canon["challenges"]),
                          exposed=bb.to_monty_np(canon["exposed"]),
                          alpha=bb.to_monty_np(canon["alpha"]))
    mats = canon["main"] + ([canon["perm"]] if n_perm else [])
    got = quotient.evaluate_plain(bound, [_lde(bb.to_monty_np(m)) for m in mats],
                                  log_n, lqd)
    return air, jdag, canon, log_n, lqd, bb.to_numpy(bb.from_monty_plain(got))


@pytest.mark.parametrize("name", ["keccakf", "sw_double_0"])
def test_extension_air_quotient_equals_device_ops(name):
    """The same against the JAX package's DeviceOps: a DAG of up to 56 K
    nodes compiled eagerly on XLA:CPU (minutes; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("compiles every node of the DAG on XLA:CPU; run with OPENVM_SLOW=1")
    air, jdag, canon, log_n, lqd, got = _extension_case(name, 31)
    sels = _selectors_on_domain(log_n, log_n + lqd, bb.GENERATOR)
    nq = 1 << (log_n + lqd)
    jenv = {"main": [jnp.asarray(bb.to_monty_np(m)) for m in canon["main"]],
            "preprocessed": None,
            "perm": None if canon["perm"] is None else jnp.asarray(bb.to_monty_np(canon["perm"])),
            "publics": jnp.asarray(bb.to_monty_np(canon["publics"])),
            "challenges": jnp.asarray(bb.to_monty_np(canon["challenges"])),
            "exposed": jnp.asarray(bb.to_monty_np(canon["exposed"])),
            "sels": sels, "next_step": 1 << lqd}
    vals = jdag.eval(JaxDeviceOps, jenv, roots=jdag.constraint_roots)
    alpha = jnp.asarray(bb.to_monty_np(canon["alpha"]))
    acc = jef.zeros((nq,))
    for r in jdag.constraint_roots:
        tag, v = vals[r]
        acc = jef.mul(acc, jnp.broadcast_to(alpha, acc.shape))
        acc = jef.add(acc, jef.from_base(jnp.broadcast_to(v, (nq,))) if tag == "b"
                      else jnp.broadcast_to(v, (nq, 4)))
    want = np.asarray(jef.scale(acc, sels["inv_zeroifier"]))
    np.testing.assert_array_equal(
        bb.to_monty_np(got.astype(np.uint64)), want)
