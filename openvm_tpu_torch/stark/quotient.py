"""Constraint DAG -> bytecode -> one pass over the rows: the quotient, and
columns of DAG roots.

Port of openvm_tpu/stark/prover.py:272-304 (``_selectors_on_domain``),
:521-568 (``prepare_quotient``/``group_closure``: every constraint of an AIR
evaluated over its quotient domain and Horner-folded by alpha) and :648 (the
``inv_zeroifier`` scale), which the JAX package fuses with XLA into one
program per AIR and shape (kernels K7 and K11).

Here a host compiler turns the DAG into bytecode once per AIR and prove, and
one interpreter evaluates it:
  * ``evaluate`` runs kernel K7+K11 (csrc/quotient.cu) on CUDA tensors: one
    thread per quotient-domain row runs the whole program, folds each root
    as acc = acc * alpha + v in root order, and writes acc / Z_H(x);
  * ``evaluate_plain`` runs the same bytecode with int64 torch operations
    over all rows at once (any device).
All constraint roots are folded in one pass, the LogUp constraints that
keygen appends included: the fold is exact, so the values equal the JAX
package's group-and-shift recombination (prover.py:634-646) and its batched
``logup.eval_logup_folded`` (logup.py:350).  The program's operations are
typed by static tags (base or extension), so the interpreter never
promotes at run time.

The quotient domain is the first 2^log_q rows of a bit-reversed LDE, put
back in natural order (prover.py:528-531): natural row j is LDE row
rev(j); a ``next`` variable reads natural row (j + 2^lqd) mod 2^log_q, so it
wraps (evaluator.py:51).

The columns mode (``compile_columns``, ``evaluate_columns``) runs the same
interpreter over the natural trace domain for a list of base-valued roots
and writes each root's values as one row of an (R, N) matrix: next rows
wrap at N, selectors read as zero, and nothing is folded.  It is the
counterpart of ``dag.eval(DeviceOps, ...)`` in the LogUp phase
(``logup.stack_interactions``, logup.py:155) and in the lookup histograms
(``evaluator.jit_dag_lookup_hist``, evaluator.py:283-289).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build, ntt
from ..field import babybear as bb
from ..field import ext as ef

P = bb.P

# Slots of four words each that the kernel holds per row (quotient.cu).
MAX_SLOTS = 96

# Opcodes; an instruction is (op, dst, a, b) int32.  B = base, E = extension.
# STORE_B (columns mode) writes slot a to output row b.
(CONST_B, CONST_E, LOAD_B, LOAD_E, SEL, ADD_BB, SUB_BB, MUL_BB, NEG_B,
 ADD_EE, SUB_EE, MUL_EE, NEG_E, ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B,
 FOLD_E, STORE_B) = range(20)
SELECTORS = ("is_first_row", "is_last_row", "is_transition")
_EXT_ENTRIES = ("permutation", "challenge", "exposed")


@dataclass
class Program:
    """Bytecode for one AIR's constraints, or for a list of roots.

    code: (n, 4) int32 instructions; pool: uint32 Montgomery words that
    CONST_B/CONST_E read; n_slots: slots the program needs; sel_mask: bit i
    set when SELECTORS[i] is read; n_sources: matrices it loads from, in the
    order main parts, preprocessed, permutation; n_roots: rows a columns
    program writes (0 for a quotient program)."""

    code: np.ndarray
    pool: np.ndarray
    n_slots: int
    sel_mask: int
    n_sources: int
    n_roots: int = 0


def _tags(dag, nodes) -> dict:
    tags = {}
    for i in nodes:
        n = dag.nodes[i]
        op = n[0]
        if op == "var":
            tags[i] = "e" if n[1] in _EXT_ENTRIES else "b"
        elif op in ("const", "sel"):
            tags[i] = "b"
        elif op == "neg":
            tags[i] = tags[n[1]]
        else:
            tags[i] = "e" if "e" in (tags[n[1]], tags[n[2]]) else "b"
    return tags


def _schedule(dag, roots) -> list:
    """Steps ('node', i) and ('root', k): for each root in order, the nodes
    it needs that are not computed yet (operands first), then the root's own
    step (its fold, or its store as output row k)."""
    done: set = set()
    steps = []
    for r, root in enumerate(roots):
        stack = [(root, False)]
        while stack:
            i, expanded = stack.pop()
            if i in done:
                continue
            n = dag.nodes[i]
            kids = (n[1], n[2]) if n[0] in ("add", "sub", "mul") else (
                (n[1],) if n[0] == "neg" else ())
            if expanded or not kids:
                done.add(i)
                steps.append(("node", i))
                continue
            stack.append((i, True))
            for k in reversed(kids):
                if k not in done:
                    stack.append((k, False))
        steps.append(("root", r))
    return steps


def compile_dag(dag, *, n_main: int, has_preprocessed: bool, has_perm: bool,
                publics=(), challenges=None, exposed=None) -> Program:
    """Compile the nodes reachable from the constraint roots to bytecode
    that folds them in root order.  ``publics`` are base Montgomery words,
    ``challenges`` and ``exposed`` (k, 4) extension Montgomery words; the
    program carries them in its constant pool.  Raises when the program
    needs more than MAX_SLOTS."""
    return _compile(dag, dag.constraint_roots, False, n_main=n_main,
                    has_preprocessed=has_preprocessed, has_perm=has_perm,
                    publics=publics, challenges=challenges, exposed=exposed)


def compile_columns(dag, roots, *, n_main: int, has_preprocessed: bool,
                    publics=()) -> Program:
    """Compile ``roots`` (base-valued node ids, repeats allowed) to bytecode
    that writes root k's value as output row k (``evaluate_columns``)."""
    return _compile(dag, list(roots), True, n_main=n_main,
                    has_preprocessed=has_preprocessed, has_perm=False,
                    publics=publics)


def _compile(dag, roots, columns: bool, *, n_main: int, has_preprocessed: bool,
             has_perm: bool, publics=(), challenges=None,
             exposed=None) -> Program:
    steps = _schedule(dag, roots)
    tags = _tags(dag, [i for kind, i in steps if kind == "node"])
    if columns and any(tags[r] != "b" for r in roots):
        raise ValueError("a columns program takes base-valued roots only")
    last_use: dict = {}
    for s, (kind, i) in enumerate(steps):
        if kind == "root":
            last_use[roots[i]] = s
            continue
        n = dag.nodes[i]
        if n[0] in ("add", "sub", "mul"):
            last_use[n[1]] = last_use[n[2]] = s
        elif n[0] == "neg":
            last_use[n[1]] = s

    sources = {("main", k): k for k in range(n_main)}
    if has_preprocessed:
        sources[("preprocessed", 0)] = len(sources)
    if has_perm:
        sources[("permutation", 0)] = len(sources)
    pool: list = []
    pool_index: dict = {}

    def pool_words(words) -> int:
        key = tuple(int(w) for w in words)
        if key not in pool_index:
            pool_index[key] = len(pool)
            pool.extend(key)
        return pool_index[key]

    free: list = []
    n_slots = 0
    slot: dict = {}
    sel_mask = 0
    code = []

    def release(i, s):
        if last_use[i] == s and i in slot:
            heapq.heappush(free, slot.pop(i))

    def alloc(i) -> int:
        nonlocal n_slots
        if free:
            slot[i] = heapq.heappop(free)
        else:
            slot[i] = n_slots
            n_slots += 1
        return slot[i]

    for s, (kind, i) in enumerate(steps):
        if kind == "root":
            k, i = i, roots[i]
            if columns:
                code.append((STORE_B, 0, slot[i], k))
            else:
                code.append((FOLD_E if tags[i] == "e" else FOLD_B, 0, slot[i], 0))
            release(i, s)
            continue
        n = dag.nodes[i]
        op = n[0]
        if op in ("add", "sub", "mul", "neg"):
            a = n[1]
            b = n[2] if op != "neg" else None
            sa = slot[a]
            sb = slot[b] if b is not None else 0
            ta = tags[a]
            tb = tags[b] if b is not None else None
            release(a, s)
            if b is not None and b != a:
                release(b, s)
            d = alloc(i)
            if op == "neg":
                code.append((NEG_E if ta == "e" else NEG_B, d, sa, 0))
            elif ta == tb:
                table = {"add": (ADD_BB, ADD_EE), "sub": (SUB_BB, SUB_EE),
                         "mul": (MUL_BB, MUL_EE)}[op]
                code.append((table[ta == "e"], d, sa, sb))
            elif op == "sub":
                code.append((SUB_EB, d, sa, sb) if ta == "e"
                            else (SUB_BE, d, sa, sb))
            else:  # add, mul commute: extension operand first
                opc = ADD_EB if op == "add" else MUL_EB
                code.append((opc, d, sa, sb) if ta == "e" else (opc, d, sb, sa))
            continue
        d = alloc(i)
        if op == "const":
            code.append((CONST_B, d, pool_words([bb.to_monty_int(n[1])]), 0))
        elif op == "sel":
            which = SELECTORS.index(n[1])
            sel_mask |= 1 << which
            code.append((SEL, d, which, 0))
        else:
            _, entry, part, offset, index = n
            if entry in ("main", "preprocessed", "permutation"):
                src = sources[(entry, part if entry == "main" else 0)]
                code.append((LOAD_E if entry == "permutation" else LOAD_B, d,
                             2 * src + offset,
                             4 * index if entry == "permutation" else index))
            elif entry == "public":
                code.append((CONST_B, d, pool_words([publics[index]]), 0))
            elif entry in ("challenge", "exposed"):
                vals = challenges if entry == "challenge" else exposed
                code.append((CONST_E, d, pool_words(vals[index]), 0))
            else:
                raise KeyError(entry)
    if n_slots > MAX_SLOTS:
        raise ValueError(f"the constraint program needs {n_slots} slots; the "
                         f"quotient kernel holds {MAX_SLOTS}")
    return Program(code=np.asarray(code, dtype=np.int32).reshape(-1, 4),
                   pool=np.asarray(pool, dtype=np.uint32),
                   n_slots=n_slots, sel_mask=0 if columns else sel_mask,
                   n_sources=len(sources), n_roots=len(roots) if columns else 0)


# ---------------------------------------------------------------------------
# Selectors and the zerofier on the quotient domain
# ---------------------------------------------------------------------------

def _zh_table(log_n: int, lqd: int) -> np.ndarray:
    """Z_H(x) = x^n - 1 on the coset g*<w_q> takes 2^lqd values:
    x_j^n = g^n * w_{2^lqd}^(j mod 2^lqd).  Returns Montgomery words
    [Z_H(k) for k < 2^lqd] + [1/Z_H(k) for k < 2^lqd]."""
    gn = pow(bb.GENERATOR, 1 << log_n, P)
    w = bb.two_adic_generator_int(lqd)
    zh = [(gn * pow(w, k, P) - 1) % P for k in range(1 << lqd)]
    inv = [pow(z, P - 2, P) for z in zh]
    return bb.to_monty_np(np.asarray(zh + inv, dtype=np.uint64))


def selectors_on_domain(log_n: int, log_domain: int, shift: int,
                        device) -> dict:
    """Lagrange selectors of the trace domain H (size 2^log_n, shift 1) and
    1/Z_H over the coset shift*<w_{2^log_domain}> in natural order, as
    prover.py:272-304 computes them: (D,) int32 Montgomery words each."""
    d = 1 << log_domain
    w = bb.two_adic_generator_int(log_domain)
    dev = torch.device(device)
    x = torch.from_numpy(bb.to_monty_np(bb.powers_np(w, d, shift))
                         .astype(np.int64)).to(dev)
    x_n = x
    for _ in range(log_n):
        x_n = bb.mul64(x_n, x_n)
    z_h = bb.sub64(x_n, bb.R_MOD_P)
    g_inv = bb.to_monty_int(pow(bb.two_adic_generator_int(log_n), -1, P))
    x_mg = bb.sub64(x, g_inv)
    return {
        "is_first_row": bb.mul64(z_h, ef.bb_inv64(bb.sub64(x, bb.R_MOD_P))).int(),
        "is_last_row": bb.mul64(z_h, ef.bb_inv64(x_mg)).int(),
        "is_transition": x_mg.int(),
        "inv_zeroifier": ef.bb_inv64(z_h).int(),
    }


# ---------------------------------------------------------------------------
# The interpreter: plain version and kernel K7+K11
# ---------------------------------------------------------------------------

def _run_plain(prog: Program, sources: list, rows: tuple, sel_vals: list,
               n: int, alpha64=None, out=None):
    """The bytecode over n rows with int64 torch operations.  ``rows``:
    (local, next) row indices into the sources; FOLD_* fold into the
    returned (n, 4) accumulator by ``alpha64``; STORE_B writes into
    ``out`` (R, n)."""
    dev = rows[0].device
    pool = torch.from_numpy(prog.pool.astype(np.int64)).to(dev)
    slots: list = [None] * max(prog.n_slots, 1)
    acc = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    for op, d, a, b in prog.code.tolist():
        if op == CONST_B:
            slots[d] = pool[a].expand(n)
        elif op == CONST_E:
            slots[d] = pool[a:a + 4].expand(n, 4)
        elif op == LOAD_B:
            slots[d] = sources[a >> 1][rows[a & 1], b].long()
        elif op == LOAD_E:
            slots[d] = sources[a >> 1][rows[a & 1], b:b + 4].long()
        elif op == SEL:
            slots[d] = sel_vals[a]
        elif op == ADD_BB or op == ADD_EE:
            slots[d] = bb.add64(slots[a], slots[b])
        elif op == SUB_BB or op == SUB_EE:
            slots[d] = bb.sub64(slots[a], slots[b])
        elif op == MUL_BB:
            slots[d] = bb.mul64(slots[a], slots[b])
        elif op == MUL_EE:
            slots[d] = ef.mul64(slots[a], slots[b])
        elif op == NEG_B or op == NEG_E:
            slots[d] = bb.sub64(torch.zeros_like(slots[a]), slots[a])
        elif op == ADD_EB or op == SUB_EB:
            e = slots[a].clone()
            f = bb.add64 if op == ADD_EB else bb.sub64
            e[:, 0] = f(e[:, 0], slots[b])
            slots[d] = e
        elif op == SUB_BE:
            e = bb.sub64(torch.zeros_like(slots[b]), slots[b])
            e[:, 0] = bb.add64(e[:, 0], slots[a])
            slots[d] = e
        elif op == MUL_EB:
            slots[d] = ef.scale64(slots[a], slots[b])
        elif op == FOLD_B:
            acc = ef.mul64(acc, alpha64)
            acc[:, 0] = bb.add64(acc[:, 0], slots[a])
        elif op == FOLD_E:
            acc = bb.add64(ef.mul64(acc, alpha64), slots[a])
        elif op == STORE_B:
            out[b] = slots[a]
        else:
            raise ValueError(f"bad opcode {op}")
    return acc


def evaluate_plain(prog: Program, sources: list, log_n: int, lqd: int,
                   alpha: torch.Tensor) -> torch.Tensor:
    """The program over every row of the quotient domain with int64 torch
    operations.  ``sources``: bit-reversed LDE matrices (at least 2^log_q
    rows) in the program's source order; ``alpha`` (4,) Montgomery words.
    Returns (2^log_q, 4) int32: the alpha-folded constraints over Z_H."""
    log_q = log_n + lqd
    nq = 1 << log_q
    dev = alpha.device
    rev = torch.from_numpy(ntt.bitrev_perm(log_q)).to(dev)
    rows = (rev, torch.roll(rev, -(1 << lqd), 0))  # local, next
    sels = selectors_on_domain(log_n, log_q, bb.GENERATOR, dev)
    sel_vals = [sels[name].long() for name in SELECTORS]
    acc = _run_plain(prog, sources, rows, sel_vals, nq, alpha64=alpha.long())
    return ef.scale64(acc, sels["inv_zeroifier"].long()).int()


def _check_sources(sources: list, rows: int) -> None:
    for k, m in enumerate(sources):
        if m.dim() != 2 or m.dtype != torch.int32 or m.stride(1) != 1:
            raise ValueError(f"source {k} must be (N, W) int32 with unit "
                             "column stride")
        if m.shape[0] < rows:
            raise ValueError(f"source {k} has {m.shape[0]} rows < {rows}")


def _source_tables(sources: list, dev) -> tuple:
    """Device tables of the sources' base pointers and row strides."""
    ptrs = torch.tensor([m.data_ptr() for m in sources] or [0],
                        dtype=torch.int64, device=dev)
    strides = torch.tensor([m.stride(0) for m in sources] or [0],
                           dtype=torch.int64, device=dev)
    return ptrs, strides


def evaluate(prog: Program, sources: list, log_n: int, lqd: int,
             alpha: torch.Tensor) -> torch.Tensor:
    """Kernel K7+K11 (csrc/quotient.cu) on CUDA tensors, ``evaluate_plain``
    on CPU tensors; same arguments and result as ``evaluate_plain``.

    One thread per quotient-domain row, taken in the LDE's bit-reversed
    order so the local loads of neighbouring threads are neighbouring rows.
    Bound by operations for a constraint-heavy AIR (every node is a
    Montgomery product or add per row; selector and zerofier inverses are
    two Fermat inverses per row) and by bytes for a narrow one (each row
    reads its local and next cells and writes 16 bytes)."""
    dev = _build.kernel_device(alpha, *sources)
    if len(sources) != prog.n_sources:
        raise ValueError(f"program reads {prog.n_sources} matrices, "
                         f"{len(sources)} given")
    if dev.type == "cpu":
        return evaluate_plain(prog, sources, log_n, lqd, alpha)
    log_q = log_n + lqd
    nq = 1 << log_q
    _check_sources(sources, nq)
    alpha = alpha.contiguous()
    _build.check_words(alpha, "alpha", dev)
    code = torch.from_numpy(prog.code).to(dev)
    pool = torch.from_numpy(prog.pool.view(np.int32)).to(dev)
    ptrs, strides = _source_tables(sources, dev)
    xs = ntt.lde_points(log_q, dev)
    zh = bb.from_numpy(_zh_table(log_n, lqd), device=dev)
    g_inv = bb.to_monty_int(pow(bb.two_adic_generator_int(log_n), -1, P))
    out = torch.empty((nq, 4), dtype=torch.int32, device=dev)
    _build.launch("quotient", "ovt_quotient", dev, code.data_ptr(),
                  code.shape[0], pool.data_ptr(), ptrs.data_ptr(),
                  strides.data_ptr(), xs.data_ptr(), zh.data_ptr(), g_inv,
                  alpha.data_ptr(), log_q, lqd, prog.sel_mask, out.data_ptr())
    return out


def evaluate_columns_plain(prog: Program, sources: list,
                           log_n: int) -> torch.Tensor:
    """A columns program over the natural trace domain with int64 torch
    operations.  ``sources``: natural-order (2^log_n, W) Montgomery
    matrices in the program's source order.  Returns (R, 2^log_n) int32."""
    n = 1 << log_n
    dev = sources[0].device
    local = torch.arange(n, device=dev)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    out = torch.empty((prog.n_roots, n), dtype=torch.int64, device=dev)
    _run_plain(prog, sources, (local, torch.roll(local, -1)), [zero] * 3, n,
               out=out)
    return out.int()


def evaluate_columns(prog: Program, sources: list, log_n: int) -> torch.Tensor:
    """Kernel K7 in its columns mode (csrc/quotient.cu) on CUDA tensors,
    ``evaluate_columns_plain`` on CPU tensors; same arguments and result.

    One thread per trace row runs the whole program and stores each root's
    value in its output row, so neighbouring threads write neighbouring
    words.  Bound by bytes when the roots are columns and small
    expressions, as interaction fields are: each row reads its cells and
    writes 4 bytes per root."""
    if not sources:
        raise ValueError("a columns program reads at least one matrix")
    dev = _build.kernel_device(*sources)
    if len(sources) != prog.n_sources or prog.n_roots == 0:
        raise ValueError(f"not a columns program over {len(sources)} matrices")
    if dev.type == "cpu":
        return evaluate_columns_plain(prog, sources, log_n)
    n = 1 << log_n
    _check_sources(sources, n)
    code = torch.from_numpy(prog.code).to(dev)
    pool = torch.from_numpy(prog.pool.view(np.int32)).to(dev)
    ptrs, strides = _source_tables(sources, dev)
    out = torch.empty((prog.n_roots, n), dtype=torch.int32, device=dev)
    _build.launch("quotient_columns", "ovt_quotient_columns", dev,
                  code.data_ptr(), code.shape[0], pool.data_ptr(),
                  ptrs.data_ptr(), strides.data_ptr(), log_n, out.data_ptr())
    return out
