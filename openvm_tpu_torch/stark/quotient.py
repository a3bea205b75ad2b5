"""Constraint DAG -> bytecode -> one pass over the rows: the quotient, and
columns of DAG roots.

Port of openvm_tpu/stark/prover.py:272-304 (``_selectors_on_domain``),
:521-568 (``prepare_quotient``/``group_closure``: every constraint of an AIR
evaluated over its quotient domain and Horner-folded by alpha) and :648 (the
``inv_zeroifier`` scale), which the JAX package fuses with XLA into one
program per AIR and shape (kernels K7 and K11).

Here a host compiler turns the DAG into bytecode once per AIR (the code
does not depend on the prove's values, so a prover keeps it with its
proving key), ``bind`` fills the program's constant pool with one prove's
values, and one interpreter evaluates it:
  * ``evaluate_many`` runs kernel K7+K11 (csrc/quotient.cu) on CUDA
    tensors: one launch for every AIR of a prove, each thread evaluating
    one quotient-domain row with its value slots in shared memory beside
    its job's code, and one more launch, with the code streamed from
    global memory, for the programs too large to share the first without
    shrinking its blocks (Poseidon2Air, sha256's, keccakf, the ECC and Fp2
    chips), which the compiler fits in BUDGET slot words a row by loading
    cells, constants and selectors again rather than holding them and by
    spilling computed values, and whose sources it reads column-major;
    ``evaluate`` is the one-AIR case;
  * ``evaluate_plain`` runs the same bytecode with int64 torch operations
    over all rows at once (any device).
Both fold root k of R as alpha^(R-1-k) v_k, with the powers of alpha in the
pool: exact field arithmetic, so the words equal Horner's acc * alpha + v
and the JAX package's group-and-shift recombination (prover.py:634-646)
and batched ``logup.eval_logup_folded`` (logup.py:350).  All constraint
roots are folded in one pass, the LogUp constraints that keygen appends
included.  The program's operations are typed by static tags (base or
extension), and base and extension values live in separate slot files (one
shared word file in a budgeted program), so the interpreter never promotes
at run time and a base value takes one word.

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
from dataclasses import dataclass, replace

import numpy as np
import torch

from .. import _build, ntt
from ..field import babybear as bb
from ..field import ext as ef

P = bb.P

# The kernel's plan (csrc/quotient.cu): each thread takes one row; a row's
# slots take ``lane_words`` words (one per base slot, four per extension
# slot), in the block's shared memory.  The shared launch stages each job's
# code (16 bytes an instruction) beside its rows' slots; a program fits it
# when two blocks of THREADS[0] threads, with its code, fit one SM
# (``max_lane_words``).  A larger one is compiled at BUDGET slot words a row
# (reloading loaded cells, constants and selectors rather than holding
# them, spilling computed values) and runs in the streamed launch, its code
# streamed from global memory through a ring of CODE_RING instructions
# beside its slots, in blocks of STREAM_THREADS threads (None:
# ``block_threads``'s choice).  BUDGET is the fastest of 48-384 words on
# path 5's keccakf job (chip_smoke.py ``stream_timing``, PERF.md): at 48
# words and 128 threads, 8 blocks of the kernel's 63 registers a thread
# fill an SM, and the interpreter's time falls with the warps it holds.
SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
THREADS = (128, 64, 32)
BUDGET = 48
STREAM_THREADS = None
CODE_RING = 128


def max_lane_words(n_instr: int) -> int:
    """The most slot words a row a program of ``n_instr`` instructions may
    take in the shared launch: two blocks of THREADS[0] threads, each with
    the code and 1 KB reserved, fit one SM (negative when the code alone
    does not)."""
    return (SM_SMEM_BYTES // 2 - 1024 - 16 * n_instr) // (4 * THREADS[0])


# Opcodes; an instruction is (op, dst, a, b) int32.  B = base, E = extension;
# slot operands index the base or the extension slot file as the opcode
# types them.  FOLD_* read their power of alpha at pool word b; STORE_B
# (columns mode) writes base slot a to output row b.  MADD_EB, MSUB_EB and
# MRSUB_EB fuse an extension add or sub with a product it alone uses:
# dst = dst + a*b, dst - a*b, a*b - dst (a extension, b base, dst the other
# operand's slot, which the instruction takes over).  MULFOLD_BB and
# SUBFOLD_EE fold a root computed only for its fold: acc += alpha^e * (a*b)
# or (a - b), with alpha^e at pool word dst.  SPILL (w, a, t) stores slot a
# (base when t is 0, extension when 1) at spill word w of the row, FILL
# (d, w, t) loads it back into slot d (budgeted programs only).
(CONST_B, CONST_E, LOAD_B, LOAD_E, SEL, ADD_BB, SUB_BB, MUL_BB, NEG_B,
 ADD_EE, SUB_EE, MUL_EE, NEG_E, ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B,
 FOLD_E, STORE_B, MADD_EB, MSUB_EB, MRSUB_EB, MULFOLD_BB,
 SUBFOLD_EE, SPILL, FILL) = range(27)
SELECTORS = ("is_first_row", "is_last_row", "is_transition")
_WRITES_B = {CONST_B, LOAD_B, SEL, ADD_BB, SUB_BB, MUL_BB, NEG_B}
_WRITES_E = {CONST_E, LOAD_E, ADD_EE, SUB_EE, MUL_EE, NEG_E, ADD_EB, SUB_EB,
             SUB_BE, MUL_EB, MADD_EB, MSUB_EB, MRSUB_EB}
_EXT_ENTRIES = ("permutation", "challenge", "exposed")
# A budgeted program's instruction op | WAIT waits for its thread's loads
# in flight before it runs: the streamed launch issues a load and goes on,
# and the compiler moves loads ahead of their reads (``_schedule_loads``).
WAIT = 256
OPCODE = 255
LOAD_AHEAD = 8
# Each opcode's slot operands: (field, type) read, and the type written to
# field 1 (d); SPILL and FILL take their type from field 3.
_B, _E = "b", "e"
_READS = {
    **{op: ((2, _B), (3, _B)) for op in (ADD_BB, SUB_BB, MUL_BB, MULFOLD_BB)},
    **{op: ((2, _E), (3, _E)) for op in (ADD_EE, SUB_EE, MUL_EE, SUBFOLD_EE)},
    **{op: ((2, _E), (3, _B)) for op in (ADD_EB, SUB_EB, MUL_EB)},
    **{op: ((1, _E), (2, _E), (3, _B)) for op in (MADD_EB, MSUB_EB, MRSUB_EB)},
    NEG_B: ((2, _B),), NEG_E: ((2, _E),), SUB_BE: ((2, _B), (3, _E)),
    FOLD_B: ((2, _B),), STORE_B: ((2, _B),), FOLD_E: ((2, _E),)}

# The job table of one launch: JOB_WORDS int64 per AIR (csrc/quotient.cu).
(J_CODE, J_NINSTR, J_POOL, J_SRC, J_NBASE, J_LOGQ, J_LQD, J_SEL, J_OUT,
 J_FIRST, J_LAST, J_ZH, J_BLOCK0, J_GINV) = range(14)
JOB_WORDS = 16


@dataclass
class Program:
    """Bytecode for one AIR's constraints, or for a list of roots.

    code: (n, 4) int32 instructions; n_base, n_ext: base and extension
    slots; sel_mask: bit i set when SELECTORS[i] is read; n_sources:
    matrices it loads from, in the order main parts, preprocessed,
    permutation; n_roots: rows a columns program writes (0 for a quotient
    program); n_folds: constraint roots a quotient program folds;
    pool_spec: what each constant-pool entry holds ("word", w),
    ("public", i), ("challenge", i), ("exposed", i) or ("alpha", e)
    (alpha^e); pool: the uint32 Montgomery words ``bind`` filled in, None
    until then; budget: the slot words a row the program was compiled
    within, for the streamed launch (0: compiled without one, for the
    shared launch); reloads: instructions that load a cell, constant or
    selector again because it gave up its slot; spills: SPILL instructions;
    n_spill: spill words a row."""

    code: np.ndarray
    n_base: int
    n_ext: int
    sel_mask: int
    n_sources: int
    n_roots: int = 0
    n_folds: int = 0
    pool_spec: tuple = ()
    pool: np.ndarray | None = None
    budget: int = 0
    reloads: int = 0
    spills: int = 0
    n_spill: int = 0

    @property
    def lane_words(self) -> int:
        """Shared-memory words one row's slots take in the kernel: the base
        file and the extension file behind it, or, for a budgeted program,
        the one file both share (``_WordFile``)."""
        if self.budget:
            return max(self.n_base, 4 * self.n_ext)
        return self.n_base + 4 * self.n_ext

    @property
    def ext_offset(self) -> int:
        """Words a row before the extension file (J_NBASE)."""
        return 0 if self.budget else self.n_base


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


def _kids(node) -> tuple:
    if node[0] in ("add", "sub", "mul"):
        return node[1], node[2]
    return (node[1],) if node[0] == "neg" else ()


def _fusions(dag, tags: dict, roots) -> dict:
    """Extension adds and subs that take over a product only they use:
    {node: (product, other operand, opcode)}, the product (extension times
    base) then never evaluated on its own."""
    uses: dict = {}
    for i in tags:
        for k in _kids(dag.nodes[i]):
            uses[k] = uses.get(k, 0) + 1
    for r in roots:
        uses[r] = uses.get(r, 0) + 1
    fused = {}
    for i in tags:
        n = dag.nodes[i]
        if n[0] not in ("add", "sub") or tags[i] != "e":
            continue
        for pos in (2, 1):
            m, other = n[pos], n[3 - pos]
            mn = dag.nodes[m]
            if (mn[0] == "mul" and uses[m] == 1 and m != other
                    and tags[other] == "e"
                    and sorted((tags[mn[1]], tags[mn[2]])) == ["b", "e"]):
                opc = MADD_EB if n[0] == "add" else (MSUB_EB if pos == 2 else MRSUB_EB)
                fused[i] = (m, other, opc)
                break
    return fused


def _need(dag, upto: int, tags: dict, kids_of) -> list:
    """Sethi-Ullman numbers in words: the slot words a node's tree needs
    when its larger child is evaluated first (sharing ignored).  Nodes are
    topologically ordered, so one forward pass suffices."""
    need = [0] * (upto + 1)
    for i in range(upto + 1):
        w = 4 if tags.get(i) == "e" else 1
        kids = kids_of(i)
        if not kids:
            need[i] = w
            continue
        first, *rest = sorted(kids, key=lambda k: -need[k])
        wf = 4 if tags.get(first) == "e" else 1
        need[i] = max(need[first], wf + (need[rest[0]] if rest else 0), w)
    return need


def _schedule(dag, roots, tags: dict, kids_of) -> list:
    """Steps ('node', i) and ('root', k): for each root in order, the nodes
    it needs that are not computed yet (operands first, the operand with the
    larger Sethi-Ullman number first, so that fewer slots are live), then
    the root's own step (its fold, or its store as output row k).
    ``kids_of(i)``: the operands node i is evaluated from."""
    need = _need(dag, max(roots, default=0), tags, kids_of)
    done: set = set()
    steps = []
    for r, root in enumerate(roots):
        stack = [(root, False)]
        while stack:
            i, expanded = stack.pop()
            if i in done:
                continue
            kids = kids_of(i)
            if expanded or not kids:
                done.add(i)
                steps.append(("node", i))
                continue
            stack.append((i, True))
            # the larger need on top of the stack; ties keep operand order
            for k in sorted(reversed(kids), key=lambda k: need[k]):
                if k not in done:
                    stack.append((k, False))
        steps.append(("root", r))
    return steps


def _cone(dag, root) -> set:
    seen, stack = set(), [root]
    while stack:
        i = stack.pop()
        if i not in seen:
            seen.add(i)
            stack.extend(_kids(dag.nodes[i]))
    return seen


def _root_order(dag, roots) -> list:
    """A fold order for the roots (any order folds to the same words, since
    root k is scaled by its own power of alpha): greedily the root whose
    cone needs the fewest nodes not computed yet, ties to the one that
    retires the most nodes no other remaining root uses, then to the lower
    index, so that fewer values are live at once.  The keys only fall as
    roots are taken, so a heap with lazy updates finds each next root
    without rescanning every cone (keccakf's 3,508 roots in about a
    second)."""
    cones = [_cone(dag, r) for r in roots]
    holders: dict = {}  # node -> the root positions whose cone holds it
    for k, c in enumerate(cones):
        for n in c:
            holders.setdefault(n, []).append(k)
    uses = {n: len(h) for n, h in holders.items()}  # roots not taken yet
    left = [len(c) for c in cones]  # nodes not computed yet
    alone = [sum(1 for n in c if uses[n] == 1) for c in cones]
    heap = [(left[k], -alone[k], k) for k in range(len(roots))]
    heapq.heapify(heap)
    taken = [False] * len(roots)
    done: set = set()
    order = []
    while heap:
        key = heapq.heappop(heap)
        k = key[2]
        if taken[k] or key != (left[k], -alone[k], k):
            continue
        order.append(k)
        taken[k] = True
        moved = set()
        for n in cones[k]:
            if n not in done:
                done.add(n)
                for j in holders[n]:
                    if not taken[j]:
                        left[j] -= 1
                        moved.add(j)
            uses[n] -= 1
            if uses[n] == 1:
                j = next(j for j in holders[n] if not taken[j])
                alone[j] += 1
                moved.add(j)
        for j in moved:
            heapq.heappush(heap, (left[j], -alone[j], j))
    return order


def _reachable_tags(dag, roots) -> dict:
    seen, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        stack.extend(_kids(dag.nodes[i]))
    return _tags(dag, sorted(seen))


def compile_dag(dag, *, n_main: int, has_preprocessed: bool, has_perm: bool,
                publics=(), challenges=None, exposed=None, alpha=None,
                budget: int | None = None) -> Program:
    """Compile the nodes reachable from the constraint roots to bytecode
    that folds them by powers of ``alpha``, and bind the pool.  ``publics``
    are base Montgomery words, ``challenges`` and ``exposed`` (k, 4) and
    ``alpha`` (4,) extension Montgomery words.  A program whose slots need
    more words a row than ``max_lane_words`` allows beside its code is
    compiled at BUDGET slot words a row for the streamed launch (at
    ``budget``, when given, whatever its size)."""
    return bind(compile_dag_code(dag, n_main=n_main,
                                 has_preprocessed=has_preprocessed,
                                 has_perm=has_perm, budget=budget),
                publics=publics, challenges=challenges, exposed=exposed,
                alpha=alpha)


def compile_dag_code(dag, *, n_main: int, has_preprocessed: bool,
                     has_perm: bool, budget: int | None = None) -> Program:
    """``compile_dag`` without the values: the same code for every prove."""
    return _compile(dag, list(dag.constraint_roots), False, n_main=n_main,
                    has_preprocessed=has_preprocessed, has_perm=has_perm,
                    budget=budget)


def compile_columns(dag, roots, *, n_main: int, has_preprocessed: bool,
                    publics=(), selectors: bool = False,
                    budget: int | None = None) -> Program:
    """Compile ``roots`` (base-valued node ids, repeats allowed) to bytecode
    that writes root k's value as output row k (``evaluate_columns``).  The
    selectors read as zero, unless ``selectors``: then as the natural
    domain's 0/1 is_first_row, is_last_row and is_transition (the
    constraint checker, ``stark.debug``).  ``budget`` as ``compile_dag``
    takes it."""
    return bind(compile_columns_code(dag, roots, n_main=n_main,
                                     has_preprocessed=has_preprocessed,
                                     selectors=selectors, budget=budget),
                publics=publics)


def compile_columns_code(dag, roots, *, n_main: int, has_preprocessed: bool,
                         selectors: bool = False, budget: int | None = None) -> Program:
    """``compile_columns`` without the values: the same code for every
    prove."""
    return _compile(dag, list(roots), True, n_main=n_main,
                    has_preprocessed=has_preprocessed, has_perm=False,
                    selectors=selectors, budget=budget)


class _TypedFiles:
    """The shared launch's slot files: a base file and an extension file,
    each value holding the lowest free slot of its type from its step to
    its last read."""

    def __init__(self, tags: dict):
        self.tags = tags
        self.slot: dict = {}
        self.free = {"b": [], "e": []}
        self.count = {"b": 0, "e": 0}

    def alloc(self, i, pinned=()) -> int:
        t = self.tags[i]
        if self.free[t]:
            self.slot[i] = heapq.heappop(self.free[t])
        else:
            self.slot[i] = self.count[t]
            self.count[t] += 1
        return self.slot[i]

    def release(self, i) -> None:
        heapq.heappush(self.free[self.tags[i]], self.slot.pop(i))

    def take_over(self, i, c) -> None:
        self.slot[i] = self.slot.pop(c)

    def hold(self, k) -> None:
        pass

    def shape(self) -> tuple:
        return self.count["b"], self.count["e"]


class _WordFile:
    """A budgeted program's one slot file of ``budget`` words a row: base
    slot w is word w, extension slot g words 4g to 4g + 3 (the streamed
    launch's layout).  A leaf (a loaded cell, constant or selector) takes
    the highest free word, an extension value the highest free group, a
    computed base value the lowest free word.  When no word or group is
    free, the leaf read again farthest ahead gives its slot up, and the
    compiler emits its instruction again before its next read, or the
    computed value read again farthest ahead, when much farther, is stored
    to the spill file (SPILL, once) and loaded back (FILL) before its next
    read (``_evict_one``).  ``next_read`` and ``spill`` (emits a SPILL) are set by the
    compiler; spill words are numbered base words first, then extension
    groups, by ``spill_words`` at the end."""

    def __init__(self, tags: dict, budget: int, leaves: set):
        self.tags, self.budget, self.leaves = tags, budget, leaves
        self.slot: dict = {}
        self.owner = [None] * budget  # word -> the value in it
        # lazy heaps: free words and free groups, highest first; the lowest
        # free words; values in slots read again farthest ahead first, leaves
        # and computed values apart
        self.free = [-w for w in range(budget)]
        self.low = list(range(budget))
        self.groups = [-g for g in range(budget // 4)]
        heapq.heapify(self.free)
        heapq.heapify(self.groups)
        self.held = {True: [], False: []}
        self.top = {"b": 0, "e": 0}
        self.spilled: dict = {}  # computed value -> its spill slot (of its type)
        self.spill_free = {"b": [], "e": []}
        self.spill_count = {"b": 0, "e": 0}
        self.next_read = self.spill = None

    def _cells(self, v) -> range:
        s = self.slot[v]
        return range(s, s + 1) if self.tags[v] == "b" else range(4 * s, 4 * s + 4)

    def _put(self, i, slot: int) -> int:
        self.slot[i] = slot
        for w in self._cells(i):
            self.owner[w] = i
        t = self.tags[i]
        self.top[t] = max(self.top[t], slot + 1)
        return slot

    def _vacate(self, v) -> None:
        for w in self._cells(v):
            self.owner[w] = None
            heapq.heappush(self.free, -w)
            heapq.heappush(self.low, w)
        g = self._cells(v)[0] >> 2
        if all(self.owner[w] is None for w in range(4 * g, 4 * g + 4)):
            heapq.heappush(self.groups, -g)
        del self.slot[v]

    def release(self, i) -> None:
        """Value i is read no more: its slot and its spill slot are free."""
        self._vacate(i)
        if i in self.spilled:
            heapq.heappush(self.spill_free[self.tags[i]], self.spilled.pop(i))

    def take_over(self, i, c) -> None:
        s = self.slot[c]
        self.release(c)
        self._put(i, s)

    def hold(self, k) -> None:
        if k in self.slot:
            heapq.heappush(self.held[k in self.leaves], (-self.next_read(k), k))

    def _give_up(self, v) -> None:
        """Value v leaves its slot; a computed value not yet in the spill
        file is stored there first."""
        if v not in self.leaves and v not in self.spilled:
            t = self.tags[v]
            if self.spill_free[t]:
                self.spilled[v] = heapq.heappop(self.spill_free[t])
            else:
                self.spilled[v] = self.spill_count[t]
                self.spill_count[t] += 1
            self.spill(v)
        self._vacate(v)

    def alloc(self, i, pinned=()) -> int:
        if self.tags[i] == "e":
            while self.groups:
                g = -heapq.heappop(self.groups)
                if all(self.owner[w] is None for w in range(4 * g, 4 * g + 4)):
                    return self._put(i, g)
            self._evict_group(pinned)
        else:
            heap, sign = (self.free, -1) if i in self.leaves else (self.low, 1)
            while heap:
                w = sign * heapq.heappop(heap)
                if self.owner[w] is None:
                    return self._put(i, w)
            self._evict_one(pinned)
        return self.alloc(i, pinned)

    def _fail(self):
        raise ValueError(f"a row's operands pass {self.budget} slot words")

    def _farthest(self, leaf: bool, pinned):
        """(next read, value) of the leaves or the computed values in slots
        read again farthest ahead, not pinned; None when there is none."""
        heap, aside, found = self.held[leaf], [], None
        while heap:
            key, v = heap[0]
            if v not in self.slot or -key != self.next_read(v):
                heapq.heappop(heap)  # stale
            elif v in pinned:
                aside.append(heapq.heappop(heap))
            else:
                found = (-key, v)
                break
        for e in aside:
            heapq.heappush(heap, e)
        return found

    def _evict_one(self, pinned) -> None:
        """The leaf read again farthest ahead gives its slot up (one load
        again), unless a computed value is read again more than twice as
        far ahead, or as far and is in the spill file already (a SPILL, if
        not yet stored, and a FILL)."""
        leaf = self._farthest(True, pinned)
        comp = self._farthest(False, pinned)
        if comp and (not leaf or comp[0] > leaf[0] * (1 if comp[1] in self.spilled else 2)):
            self._give_up(comp[1])
        elif leaf:
            self._give_up(leaf[1])
        else:
            self._fail()

    def _evict_group(self, pinned) -> None:
        """Of the groups that hold no operand of the instruction, the one
        whose values need the fewest SPILLs and, of those, are read again
        farthest ahead, gives them up."""
        best, best_key = None, None
        for g in range(self.budget // 4):
            values = {self.owner[w] for w in range(4 * g, 4 * g + 4)} - {None}
            if values & set(pinned):
                continue
            key = (-sum(1 for v in values if v not in self.leaves and v not in self.spilled),
                   min((self.next_read(v) for v in values), default=len(self.owner) << 40))
            if best_key is None or key > best_key:
                best, best_key = g, key
        if best is None:
            self._fail()
        for v in {self.owner[w] for w in range(4 * best, 4 * best + 4)} - {None}:
            self._give_up(v)

    def spill_words(self) -> tuple:
        """(base spill words, extension spill groups)."""
        return self.spill_count["b"], self.spill_count["e"]

    def shape(self) -> tuple:
        return self.top["b"], self.top["e"]


def _touched(ins) -> tuple:
    """(words read, words written) of one instruction of a budgeted
    program as bit masks: base slot w is word w, extension slot g words 4g
    to 4g + 3."""
    op, d = ins[0] & OPCODE, ins[1]

    def cells(slot, t):
        return 1 << slot if t == _B else 15 << 4 * slot

    if op in (SPILL, FILL):
        t = _E if ins[3] else _B
        return (cells(ins[2], t), 0) if op == SPILL else (0, cells(d, t))
    reads = 0
    for field, t in _READS.get(op, ()):
        reads |= cells(ins[field], t)
    if op in _WRITES_B:
        return reads, cells(d, _B)
    return reads, (cells(d, _E) if op in _WRITES_E else 0)


def _schedule_loads(code: np.ndarray, ahead: int = LOAD_AHEAD) -> np.ndarray:
    """A budgeted program's code with each load moved up to ``ahead``
    instructions earlier, past instructions that neither read nor write its
    slot, and WAIT set on the first instruction after it that touches a
    word a load in flight writes: the streamed launch issues a load without
    waiting, so its latency overlaps the instructions between."""
    rows = code.tolist()
    touched = [_touched(ins) for ins in rows]
    for i in range(len(rows)):
        if rows[i][0] not in (LOAD_B, LOAD_E):
            continue
        dest, j = touched[i][1], i
        while j > 0 and i - j < ahead and not (touched[j - 1][0] | touched[j - 1][1]) & dest:
            j -= 1
        if j < i:
            rows.insert(j, rows.pop(i))
            touched.insert(j, touched.pop(i))
    pending = 0
    for k, (reads, writes) in enumerate(touched):
        if (reads | writes) & pending:
            rows[k][0] |= WAIT
            pending = 0
        if rows[k][0] & OPCODE in (LOAD_B, LOAD_E):
            pending |= writes
    return np.asarray(rows, dtype=np.int32).reshape(-1, 4)


def _compile(dag, roots, columns: bool, *, n_main: int, has_preprocessed: bool,
             has_perm: bool, selectors: bool = False, budget: int | None = None) -> Program:
    """The program of ``roots``: compiled without a budget when that fits
    the shared launch beside its code (``max_lane_words``), else at
    ``budget`` slot words a row (BUDGET unless given)."""
    tags = _reachable_tags(dag, roots)
    if columns and any(tags[r] != "b" for r in roots):
        raise ValueError("a columns program takes base-valued roots only")
    fused = _fusions(dag, tags, roots)

    def factors(m) -> tuple:  # (extension, base) operands of a product
        a, b = dag.nodes[m][1], dag.nodes[m][2]
        return (a, b) if tags[a] == "e" else (b, a)

    def kids_of(i) -> tuple:
        if i in fused:
            m, other, _ = fused[i]
            return (other,) + factors(m)
        return _kids(dag.nodes[i])

    if columns:
        steps = _schedule(dag, roots, tags, kids_of)
    else:
        order = _root_order(dag, roots)
        steps = [(kind, order[i] if kind == "root" else i) for kind, i in
                 _schedule(dag, [roots[k] for k in order], tags, kids_of)]
    reads: dict = {}  # node -> the steps that read it, in order
    for s, (kind, i) in enumerate(steps):
        for k in ((roots[i],) if kind == "root" else kids_of(i)):
            reads.setdefault(k, []).append(s)
    last_use = {k: r[-1] for k, r in reads.items()}
    # loaded cells, constants and selectors: what a budget may emit again
    leaves = {i for i in tags if dag.nodes[i][0] in ("const", "sel", "var")}

    sources = {("main", k): k for k in range(n_main)}
    if has_preprocessed:
        sources[("preprocessed", 0)] = len(sources)
    if has_perm:
        sources[("permutation", 0)] = len(sources)
    spec: list = []
    spec_at: dict = {}
    n_words = [0]

    def pool_entry(key, width: int) -> int:
        if key not in spec_at:
            spec_at[key] = n_words[0]
            spec.append(key)
            n_words[0] += width
        return spec_at[key]

    def emit(files) -> Program:
        """The code of the schedule with its slots from ``files``
        (``_TypedFiles`` or ``_WordFile``)."""
        slot = files.slot
        at = dict.fromkeys(reads, 0)  # node -> its next read, an index into reads
        leaf_code: dict = {}  # leaf -> (opcode, a, b)
        sel_mask = 0
        code = []
        n_reloads = 0

        def next_read(k) -> int:
            r = reads[k]
            return r[at[k]] if at[k] < len(r) else len(steps)

        def spill(v):
            code.append((SPILL, files.spilled[v], slot[v], int(tags[v] == "e")))

        files.next_read, files.spill = next_read, spill

        def release(i, s):
            if last_use[i] == s and i in slot:
                files.release(i)

        def use(k, pinned) -> int:
            """Slot of operand k: if it gave its slot up, its leaf
            instruction emitted again, or a FILL from the spill file."""
            nonlocal n_reloads
            if k not in slot:
                if k in leaf_code:
                    op, a, b = leaf_code[k]
                    code.append((op, files.alloc(k, pinned), a, b))
                    n_reloads += 1
                else:
                    code.append((FILL, files.alloc(k, pinned), files.spilled[k],
                                 int(tags[k] == "e")))
                files.hold(k)
            return slot[k]

        def advance(ks, s):
            for k in ks:
                r = reads[k]
                while at[k] < len(r) and r[at[k]] <= s:
                    at[k] += 1
            for k in ks:
                files.hold(k)

        n_roots = len(roots)
        folded: set = set()  # root steps a fused instruction already folded
        for s, (kind, i) in enumerate(steps):
            if kind == "root":
                if s in folded:
                    continue
                k, i = i, roots[i]
                si = use(i, (i,))
                if columns:
                    code.append((STORE_B, 0, si, k))
                else:
                    apow = pool_entry(("alpha", n_roots - 1 - k), 4)
                    code.append((FOLD_E if tags[i] == "e" else FOLD_B, 0, si, apow))
                advance((i,), s)
                release(i, s)
                continue
            n = dag.nodes[i]
            op = n[0]
            nxt = steps[s + 1] if s + 1 < len(steps) else None
            if (not columns and i not in fused and nxt is not None
                    and nxt[0] == "root" and roots[nxt[1]] == i
                    and last_use[i] == s + 1 and op in ("mul", "sub")
                    and tags[n[1]] == tags[n[2]]
                    and (op, tags[n[1]]) in (("mul", "b"), ("sub", "e"))):
                # a root computed only for its fold: fold it as it is computed
                sa, sb = use(n[1], n[1:3]), use(n[2], n[1:3])
                advance(n[1:3], s)
                release(n[1], s)
                if n[2] != n[1]:
                    release(n[2], s)
                apow = pool_entry(("alpha", n_roots - 1 - nxt[1]), 4)
                code.append((MULFOLD_BB if op == "mul" else SUBFOLD_EE, apow, sa, sb))
                folded.add(s + 1)
                continue
            if i in fused:
                m, c, opc = fused[i]
                ea, eb = factors(m)
                sc, sa, sb = (use(k, (c, ea, eb)) for k in (c, ea, eb))
                advance((c, ea, eb), s)
                if last_use[c] == s:  # the fused op takes over c's slot
                    for k in {ea, eb} - {c}:
                        release(k, s)
                    files.take_over(i, c)
                    files.hold(i)
                    code.append((opc, slot[i], sa, sb))
                    continue
                # c lives on: the product into a temporary, then the add or sub
                for k in {ea, eb}:
                    release(k, s)
                tmp = ("product", i)
                tags[tmp] = "e"
                t = files.alloc(tmp, (c,))
                code.append((MUL_EB, t, sa, sb))
                files.release(tmp)
                d = files.alloc(i)
                files.hold(i)
                code.append((ADD_EE, d, sc, t) if opc == MADD_EB else
                            (SUB_EE, d, sc, t) if opc == MSUB_EB else
                            (SUB_EE, d, t, sc))
                continue
            if op in ("add", "sub", "mul", "neg"):
                a = n[1]
                b = n[2] if op != "neg" else None
                ks = (a,) if b is None else (a, b)
                sa = use(a, ks)
                sb = use(b, ks) if b is not None else 0
                advance(ks, s)
                ta = tags[a]
                tb = tags[b] if b is not None else None
                release(a, s)
                if b is not None and b != a:
                    release(b, s)
                d = files.alloc(i)
                files.hold(i)
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
            d = files.alloc(i)
            if op == "const":
                ins = (CONST_B, pool_entry(("word", bb.to_monty_int(n[1])), 1), 0)
            elif op == "sel":
                which = SELECTORS.index(n[1])
                sel_mask |= 1 << which
                ins = (SEL, which, 0)
            else:
                _, entry, part, offset, index = n
                if entry in ("main", "preprocessed", "permutation"):
                    src = sources[(entry, part if entry == "main" else 0)]
                    ins = (LOAD_E if entry == "permutation" else LOAD_B,
                           2 * src + offset,
                           4 * index if entry == "permutation" else index)
                elif entry == "public":
                    ins = (CONST_B, pool_entry(("public", index), 1), 0)
                elif entry in ("challenge", "exposed"):
                    ins = (CONST_E, pool_entry((entry, index), 4), 0)
                else:
                    raise KeyError(entry)
            leaf_code[i] = ins
            code.append((ins[0], d) + ins[1:])
            files.hold(i)
        n_base, n_ext = files.shape()
        code = np.asarray(code, dtype=np.int32).reshape(-1, 4)
        n_spill = 0
        if isinstance(files, _WordFile):
            # extension spill groups after the base spill words
            words, groups = files.spill_words()
            ext = np.isin(code[:, 0], (SPILL, FILL)) & (code[:, 3] == 1)
            code[ext & (code[:, 0] == SPILL), 1] = words + 4 * code[ext & (code[:, 0] == SPILL), 1]
            code[ext & (code[:, 0] == FILL), 2] = words + 4 * code[ext & (code[:, 0] == FILL), 2]
            n_spill = words + 4 * groups
            code = _schedule_loads(code)
        return Program(code=code, n_base=n_base, n_ext=n_ext,
                       sel_mask=0 if columns and not selectors else sel_mask,
                       n_sources=len(sources), n_roots=n_roots if columns else 0,
                       n_folds=0 if columns else n_roots, pool_spec=tuple(spec),
                       budget=getattr(files, "budget", 0), reloads=n_reloads,
                       spills=int(((code[:, 0] & OPCODE) == SPILL).sum()),
                       n_spill=n_spill)

    if budget is None:
        # an instruction or more a node step: past max_lane_words' code
        # limit, the typed program cannot fit
        if sum(kind == "node" for kind, _ in steps) <= (SM_SMEM_BYTES // 2 - 1024) // 16:
            prog = emit(_TypedFiles(tags))
            if prog.lane_words <= max_lane_words(int(prog.code.shape[0])):
                return prog
        budget = BUDGET
    # the pool comes out the same either way: a reload reads its leaf's
    # entry again
    spec.clear()
    spec_at.clear()
    n_words[0] = 0
    return emit(_WordFile(tags, budget, leaves))


def alpha_powers(alpha, n: int) -> np.ndarray:
    """(n, 4) uint32 Montgomery words of alpha^0 .. alpha^(n-1); ``alpha``
    (4,) Montgomery words."""
    a = tuple(bb.from_monty_int(int(w)) for w in np.asarray(alpha).reshape(4))
    out, cur = [], (1, 0, 0, 0)
    for _ in range(n):
        out.append(cur)
        cur = bb.ext_mul_int(cur, a)
    return bb.to_monty_np(np.asarray(out, dtype=np.uint64).reshape(n, 4))


def bind(prog: Program, publics=(), challenges=None, exposed=None,
         alpha=None) -> Program:
    """``prog`` with its pool filled from one prove's values (Montgomery
    words, as ``compile_dag`` takes them)."""
    apows = None
    words: list = []
    for kind, x in prog.pool_spec:
        if kind == "word":
            words.append(x)
        elif kind == "public":
            words.append(int(publics[x]))
        elif kind in ("challenge", "exposed"):
            vals = challenges if kind == "challenge" else exposed
            if vals is None:
                raise ValueError(f"the program reads {kind} {x}; none given")
            words.extend(int(w) for w in np.asarray(vals[x]).reshape(4))
        else:  # alpha
            if alpha is None:
                raise ValueError("a quotient program folds by powers of "
                                 "alpha; give alpha")
            if apows is None:
                apows = alpha_powers(alpha, prog.n_folds)
            words.extend(int(w) for w in apows[x])
    return replace(prog, pool=np.asarray(words, dtype=np.uint32))


# ---------------------------------------------------------------------------
# Selectors and the zerofier on the quotient domain
# ---------------------------------------------------------------------------

def _zh_values(log_n: int, lqd: int) -> list:
    """Z_H(x) = x^n - 1 on the coset g*<w_q> takes 2^lqd values:
    x_j^n = g^n * w_{2^lqd}^(j mod 2^lqd); canonical, k < 2^lqd."""
    gn = pow(bb.GENERATOR, 1 << log_n, P)
    w = bb.two_adic_generator_int(lqd)
    return [(gn * pow(w, k, P) - 1) % P for k in range(1 << lqd)]


def _zh_table(log_n: int, lqd: int) -> np.ndarray:
    """Montgomery words [Z_H(k) for k < 2^lqd] + [1/Z_H(k) for k < 2^lqd]."""
    zh = _zh_values(log_n, lqd)
    inv = [pow(z, P - 2, P) for z in zh]
    return bb.to_monty_np(np.asarray(zh + inv, dtype=np.uint64))


def batch_inv64(x: torch.Tensor) -> torch.Tensor:
    """Inverses of nonzero canonical int64 values (a power-of-two count) on
    their device by a product tree: pairwise products up to one Fermat
    inverse, then back down, two products an element per level."""
    levels = [x]
    while levels[-1].shape[0] > 1:
        a = levels[-1]
        levels.append(a[0::2] * a[1::2] % P)
    inv = torch.full((1,), pow(int(levels[-1][0]), P - 2, P), dtype=torch.int64,
                     device=x.device)
    for lvl in reversed(levels[:-1]):
        out = torch.empty_like(lvl)
        out[0::2] = inv * lvl[1::2] % P
        out[1::2] = inv * lvl[0::2] % P
        inv = out
    return inv


_SELECTOR_TABLES: dict = {}


def selector_table(log_n: int, lqd: int, device) -> torch.Tensor:
    """(2, 2^log_q) int32 Montgomery words of is_first_row and is_last_row
    over the quotient domain in LDE (bit-reversed) row order, built once per
    (log_n, lqd) on ``device``: row r is the point x_r = g w_q^rev(r), with
    Z_H(x_r) / (x_r - 1) and Z_H(x_r) / (x_r - w_n^-1), both denominators
    inverted in one batch (``batch_inv64``)."""
    key = (log_n, lqd, torch.device(device))
    if key in _SELECTOR_TABLES:
        return _SELECTOR_TABLES[key]
    log_q = log_n + lqd
    x = ntt.lde_points(log_q, device).long() * bb.RINV_MOD_P % P
    # Z_H(x_r) depends on rev(r) mod 2^lqd, the top lqd bits of r reversed
    top = torch.arange(1 << lqd, device=x.device).repeat_interleave(1 << log_n)
    rev_top = torch.from_numpy(ntt.bitrev_perm(lqd)).to(x.device)[top]
    zh = torch.tensor(_zh_values(log_n, lqd), dtype=torch.int64, device=x.device)[rev_top]
    g_inv = pow(bb.two_adic_generator_int(log_n), -1, P)
    inv = batch_inv64(torch.cat([(x + P - 1) % P, (x + P - g_inv) % P]))
    nq = 1 << log_q
    tab = torch.stack([zh * inv[:nq] % P, zh * inv[nq:] % P])
    _SELECTOR_TABLES[key] = (tab * bb.R_MOD_P % P).int()
    return _SELECTOR_TABLES[key]


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
               n: int, out=None):
    """The bytecode over n rows with int64 torch operations.  ``rows``:
    (local, next) row indices into the sources; FOLD_* add alpha^e v into
    the returned (n, 4) accumulator, alpha^e from the pool; STORE_B writes
    into ``out`` (R, n).  A budgeted program is run as the streamed launch
    runs it: its slot files overlap as the kernel's one word file does
    (``_WordFile``: a write to base slot w clears extension slot w // 4, a
    write to extension slot g base slots 4g to 4g + 3), and a load lands
    in its slot only at the next instruction marked WAIT
    (``_schedule_loads``), so reading a value the compiler let another
    overwrite, or a load before its WAIT, fails here as it would go wrong
    on the card."""
    if prog.pool is None:
        raise ValueError("the program's pool is not bound")
    dev = rows[0].device
    pool = torch.from_numpy(prog.pool.astype(np.int64)).to(dev)
    bs: list = [None] * max(prog.lane_words, 1)
    es: list = [None] * max(prog.n_ext, 1)
    spill: dict = {}  # spill word -> the value stored there
    acc = torch.zeros((n, 4), dtype=torch.int64, device=dev)
    landing: list = []  # budgeted: loads in flight, written at the next WAIT
    for op, d, a, b in prog.code.tolist():
        if op & WAIT:
            for is_e, slot, value in landing:
                _overwrite(bs, es, is_e, slot)
                (es if is_e else bs)[slot] = value
            landing.clear()
        op &= OPCODE
        if op == CONST_B:
            bs[d] = pool[a].expand(n)
        elif op == CONST_E:
            es[d] = pool[a:a + 4].expand(n, 4)
        elif op == LOAD_B:
            bs[d] = sources[a >> 1][rows[a & 1], b].long()
        elif op == LOAD_E:
            es[d] = sources[a >> 1][rows[a & 1], b:b + 4].long()
        elif op == SEL:
            bs[d] = sel_vals[a]
        elif op == ADD_BB:
            bs[d] = bb.add64(bs[a], bs[b])
        elif op == SUB_BB:
            bs[d] = bb.sub64(bs[a], bs[b])
        elif op == MUL_BB:
            bs[d] = bb.mul64(bs[a], bs[b])
        elif op == NEG_B:
            bs[d] = bb.sub64(torch.zeros_like(bs[a]), bs[a])
        elif op == ADD_EE:
            es[d] = bb.add64(es[a], es[b])
        elif op == SUB_EE:
            es[d] = bb.sub64(es[a], es[b])
        elif op == MUL_EE:
            es[d] = ef.mul64(es[a], es[b])
        elif op == NEG_E:
            es[d] = bb.sub64(torch.zeros_like(es[a]), es[a])
        elif op == ADD_EB or op == SUB_EB:
            e = es[a].clone()
            f = bb.add64 if op == ADD_EB else bb.sub64
            e[:, 0] = f(e[:, 0], bs[b])
            es[d] = e
        elif op == SUB_BE:
            e = bb.sub64(torch.zeros_like(es[b]), es[b])
            e[:, 0] = bb.add64(e[:, 0], bs[a])
            es[d] = e
        elif op == MUL_EB:
            es[d] = ef.scale64(es[a], bs[b])
        elif op == MADD_EB:
            es[d] = bb.add64(es[d], ef.scale64(es[a], bs[b]))
        elif op == MSUB_EB:
            es[d] = bb.sub64(es[d], ef.scale64(es[a], bs[b]))
        elif op == MRSUB_EB:
            es[d] = bb.sub64(ef.scale64(es[a], bs[b]), es[d])
        elif op == MULFOLD_BB:
            acc = bb.add64(acc, ef.scale64(pool[d:d + 4].expand(n, 4),
                                           bb.mul64(bs[a], bs[b])))
        elif op == SUBFOLD_EE:
            acc = bb.add64(acc, ef.mul64(bb.sub64(es[a], es[b]),
                                         pool[d:d + 4].expand(n, 4)))
        elif op == FOLD_B:
            acc = bb.add64(acc, ef.scale64(pool[b:b + 4].expand(n, 4), bs[a]))
        elif op == FOLD_E:
            acc = bb.add64(acc, ef.mul64(es[a], pool[b:b + 4].expand(n, 4)))
        elif op == STORE_B:
            out[b] = bs[a]
        elif op == SPILL:
            spill[d] = es[a] if b else bs[a]
        elif op == FILL:
            if b:
                es[d] = spill[a]
            else:
                bs[d] = spill[a]
        else:
            raise ValueError(f"bad opcode {op}")
        if prog.budget and (op in _WRITES_B or op in _WRITES_E or op == FILL):
            is_e = op in _WRITES_E or (op == FILL and b)
            _overwrite(bs, es, is_e, d)
            if op in (LOAD_B, LOAD_E):  # in flight until the next WAIT
                landing.append((is_e, d, (es if is_e else bs)[d]))
                (es if is_e else bs)[d] = None
    return acc


def _overwrite(bs: list, es: list, is_e: bool, d: int) -> None:
    """A write to slot d of a budgeted program destroys the values of the
    other type in the same words of its one word file."""
    if is_e:
        bs[4 * d:4 * d + 4] = [None] * 4
    elif d >> 2 < len(es):
        es[d >> 2] = None


def evaluate_plain(prog: Program, sources: list, log_n: int,
                   lqd: int, lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """The bound program over rows lo..hi-1 (natural order; the whole
    quotient domain by default) with int64 torch operations.  ``sources``:
    bit-reversed LDE matrices (at least 2^log_q rows) in the program's
    source order.  Each row reads its local LDE row and its next, which
    wraps past the domain's last row to its first.  Returns (hi - lo, 4)
    int32: the alpha-folded constraints over Z_H."""
    log_q = log_n + lqd
    nq = 1 << log_q
    hi = nq if hi is None else hi
    dev = sources[0].device
    rev = torch.from_numpy(ntt.bitrev_perm(log_q)).to(dev)
    idx = torch.arange(lo, hi, device=dev)
    rows = (rev[idx], rev[(idx + (1 << lqd)) % nq])  # local, next
    sels = selectors_on_domain(log_n, log_q, bb.GENERATOR, dev)
    sel_vals = [sels[name][lo:hi].long() for name in SELECTORS]
    acc = _run_plain(prog, sources, rows, sel_vals, hi - lo)
    return ef.scale64(acc, sels["inv_zeroifier"][lo:hi].long()).int()


def evaluate_many_plain(progs: list, sources: list, log_ns: list,
                        lqds: list) -> list:
    """``evaluate_plain`` for each AIR: the plain counterpart of
    ``evaluate_many``."""
    return [evaluate_plain(p, s, n, q)
            for p, s, n, q in zip(progs, sources, log_ns, lqds)]


def block_threads(lane_words: int, n_instr: int) -> int:
    """Threads of a kernel block: of THREADS, the one that keeps the most
    threads resident on an SM (its 228 KB of shared memory, 1 KB reserved
    a block, at most 32 blocks), the larger on a tie; a block's code and its
    rows' slots must fit its 227 KB."""
    best, best_resident = 0, 0
    for t in THREADS:
        per_block = lane_words * 4 * t + 16 * n_instr
        if per_block > SMEM_BYTES:
            continue
        resident = min(SM_SMEM_BYTES // (per_block + 1024), 32) * t
        if resident > best_resident:
            best, best_resident = t, resident
    if not best:
        raise ValueError(f"{lane_words} slot words a row and {n_instr} "
                         "instructions do not fit the kernel's shared memory")
    return best


def launch_plan(progs: list) -> list:
    """The launches of one interpreter call: per launch (positions of its
    programs, streamed, slot words a row, code capacity, threads).  The
    programs compiled without a budget share the first launch, whose
    blocks stage their job's code (up to the largest program's) beside
    their rows' slots; the budgeted ones share the streamed launch, whose
    blocks stream their code through a ring of CODE_RING instructions
    beside their slots, in blocks of STREAM_THREADS threads (``block_threads``'s choice when
    None).  A block runs one job, so each job puts its extension file
    after its own base file (or, budgeted, in the same file)."""
    plan = []
    for streamed in (False, True):
        idx = [k for k, p in enumerate(progs) if bool(p.budget) == streamed]
        if not idx:
            continue
        lane_words = max(max(progs[k].lane_words for k in idx), 1)
        code_cap = CODE_RING if streamed else max(int(progs[k].code.shape[0]) for k in idx)
        threads = block_threads(lane_words, code_cap)
        if streamed and STREAM_THREADS:
            threads = STREAM_THREADS
            if lane_words * 4 * threads + 16 * code_cap > SMEM_BYTES:
                raise ValueError(f"{lane_words} slot words a row do not fit "
                                 f"{threads} threads' shared memory")
        plan.append((idx, streamed, lane_words, code_cap, threads))
    return plan


def block_plan(heights: list, lanes: int) -> tuple:
    """The kernel's map of blocks to jobs: (order, first, total).  Jobs
    run largest first (ties in input order); job order[k] takes
    ceil(height / lanes) blocks from block first[k] on; ``total`` blocks in
    all.  Block b belongs to the last k with first[k] <= b and evaluates
    rows (b - first[k]) * lanes + l for l < lanes that lie below the
    height (``block_rows``)."""
    order = sorted(range(len(heights)), key=lambda k: -heights[k])
    first, total = [], 0
    for k in order:
        first.append(total)
        total += -(-heights[k] // lanes)
    return order, first, total


def block_rows(first: list, heights_in_order: list, b: int, lanes: int):
    """(position in the plan, rows) of block b, as the kernel finds them: a
    scan over the job table's first blocks, then the block's lanes below
    the job's height."""
    k = 0
    while k + 1 < len(first) and b >= first[k + 1]:
        k += 1
    row0 = (b - first[k]) * lanes
    return k, [row0 + l for l in range(lanes) if row0 + l < heights_in_order[k]]


def _check_sources(sources: list, rows: int) -> None:
    for k, m in enumerate(sources):
        if m.dim() != 2 or m.dtype != torch.int32 or m.stride(1) != 1:
            raise ValueError(f"source {k} must be (N, W) int32 with unit "
                             "column stride")
        if m.shape[0] < rows:
            raise ValueError(f"source {k} has {m.shape[0]} rows < {rows}")


def upload_code(progs: list, device) -> torch.Tensor:
    """Every program's code, concatenated in order, on ``device``: the
    part of ``evaluate_many``'s tables that is the same in every prove."""
    code = np.concatenate([p.code for p in progs]) if progs else \
        np.zeros((0, 4), np.int32)
    return torch.from_numpy(np.ascontiguousarray(code)).to(device)


def transpose_plain(m: torch.Tensor, n: int) -> torch.Tensor:
    """(W, n) int32: the first n rows of an (N, W) matrix, column-major."""
    return m[:n].t().contiguous()


def transpose(m: torch.Tensor, n: int) -> torch.Tensor:
    """``transpose_plain`` by csrc/quotient.cu's transpose_kernel on a CUDA
    tensor (32 x 32 tiles through shared memory; bound by its bytes, each
    word read and written once), on the CPU by the plain version.  The
    streamed launch reads its sources so (``_launch``): a warp's load of
    one cell of 32 neighbouring rows is then one 128-byte access."""
    if m.dim() != 2 or m.dtype != torch.int32 or m.stride(1) != 1 or m.shape[0] < n:
        raise ValueError("transpose takes an (N, W) int32 matrix of at least n rows "
                         "with unit column stride")
    if m.device.type == "cpu":
        return transpose_plain(m, n)
    out = torch.empty((int(m.shape[1]), n), dtype=torch.int32, device=m.device)
    _build.launch("quotient_transpose", "ovt_transpose", m.device, m.data_ptr(),
                  m.stride(0), out.data_ptr(), n, int(m.shape[1]))
    return out


def _launch(kernel: str, fn_name: str, progs: list, sources: list,
            log_qs: list, lqds: list, quotient: bool, code, dev):
    """Build the job tables, pool and source tables, copy them to the card
    in one non-blocking copy from pinned memory, and launch: one launch for
    the programs compiled without a budget, one streamed launch for the
    budgeted ones (``launch_plan``), whose sources are first copied
    column-major (``transpose``).  Returns the output of each job, in the
    order given."""
    for p, src, log_q in zip(progs, sources, log_qs):
        if len(src) != p.n_sources:
            raise ValueError(f"program reads {p.n_sources} matrices, "
                             f"{len(src)} given")
        if p.pool is None:
            raise ValueError("the program's pool is not bound")
        _check_sources(src, 1 << log_q)
    heights = [1 << q for q in log_qs]

    code_off = np.cumsum([0] + [int(p.code.shape[0]) for p in progs])
    pool_parts, pool_off, n_pool = [], [], 0
    src_words, src_off = [], []
    if quotient:
        out = torch.empty((sum(heights), 4), dtype=torch.int32, device=dev)
    outs, out_ptr, row = [], [], 0
    cols = []  # kept until the launches are enqueued
    for k, p in enumerate(progs):
        pool_off.append(n_pool)
        pool_parts.append(p.pool)
        n_pool += int(p.pool.shape[0])
        if quotient:
            zh = _zh_table(log_qs[k] - lqds[k], lqds[k])[1 << lqds[k]:]
            pool_parts.append(zh)
            n_pool += int(zh.shape[0])
            outs.append(out[row:row + heights[k]])
            row += heights[k]
        else:
            outs.append(torch.empty((p.n_roots, heights[k]), dtype=torch.int32,
                                    device=dev))
        out_ptr.append(outs[-1].data_ptr())
        src_off.append(len(src_words) // 2)
        for m in sources[k]:
            if p.budget:  # the streamed launch reads column-major copies
                cols.append(transpose(m, heights[k]))
                src_words += [cols[-1].data_ptr(), heights[k]]
            else:
                src_words += [m.data_ptr(), m.stride(0)]

    launches = []
    for idx, streamed, lane_words, code_cap, threads in launch_plan(progs):
        order, first, total = block_plan([heights[k] for k in idx], threads)
        jobs = np.zeros((len(idx), JOB_WORDS), dtype=np.int64)
        for pos, o in enumerate(order):
            k = idx[o]
            p, j = progs[k], jobs[pos]
            j[J_CODE], j[J_NINSTR] = code_off[k], p.code.shape[0]
            j[J_POOL], j[J_SRC] = pool_off[k], src_off[k]
            j[J_NBASE] = p.ext_offset
            j[J_LOGQ], j[J_LQD], j[J_SEL] = log_qs[k], lqds[k], p.sel_mask
            j[J_OUT], j[J_BLOCK0] = out_ptr[k], first[pos]
            if quotient:
                log_n = log_qs[k] - lqds[k]
                j[J_ZH] = pool_off[k] + int(p.pool.shape[0])
                j[J_GINV] = bb.to_monty_int(pow(bb.two_adic_generator_int(log_n), -1, P))
                if p.sel_mask & 3:
                    tab = selector_table(log_n, lqds[k], dev)
                    j[J_FIRST], j[J_LAST] = tab[0].data_ptr(), tab[1].data_ptr()
        launches.append((jobs, threads, total, lane_words * 4 * threads + 16 * code_cap,
                         code_cap, streamed, max(progs[k].n_spill for k in idx)))

    sections = [np.asarray(src_words or [0, 0], dtype=np.int64).view(np.uint8),
                np.concatenate(pool_parts + [np.zeros(1, np.uint32)])
                .astype(np.uint32).view(np.uint8)]
    if code is None:
        code_np = np.concatenate([p.code for p in progs]).astype(np.int32)
        sections.append(code_np.view(np.uint8).ravel())
    sections += [jobs.view(np.uint8).ravel() for jobs, *_ in launches]
    tables, offs = _build.upload(sections, dev)
    base = tables.data_ptr()
    code_ptr = base + offs[2] if code is None else code.data_ptr()
    xs = ntt.lde_points(max(log_qs), dev) if quotient else tables
    spills = []
    for (jobs, threads, total, smem, code_cap, streamed, n_spill), off in zip(
            launches, offs[len(sections) - len(launches):]):
        # the streamed launch's spill file: n_spill words for each of its rows
        spills.append(torch.empty(max(n_spill * total * threads, 1), dtype=torch.int32,
                                  device=dev))
        _build.launch(kernel, fn_name, dev, base + off, len(jobs), code_ptr,
                      base + offs[1], base + offs[0], xs.data_ptr(), threads,
                      total, smem, code_cap, int(streamed), spills[-1].data_ptr())
    # the tables must outlive the launch: PyTorch's caching allocator holds
    # a freed block for the stream's later work, and the kernel runs first
    return outs


def evaluate_many(progs: list, sources: list, log_ns: list, lqds: list,
                  code: torch.Tensor | None = None) -> list:
    """Kernel K7+K11 (csrc/quotient.cu) over every AIR of a prove in one
    launch on CUDA tensors, ``evaluate_many_plain`` on CPU tensors.
    ``progs`` bound programs, ``sources`` their matrices (as
    ``evaluate_plain`` takes them); ``code``, when given, is
    ``upload_code(progs)`` kept from an earlier prove.  Returns one
    (2^log_q, 4) int32 tensor per AIR, in the order given.

    Blocks map to (AIR, row range) through a job table (``block_plan``);
    each thread evaluates one row, in LDE order, so neighbouring threads
    load neighbouring rows.  Budgeted programs take a second launch, with
    their code streamed from global memory (``launch_plan``).  Bound by
    operations for a constraint-heavy AIR
    (every node a Montgomery product or add a row; the fold a scale or an
    extension product by a power of alpha) and by bytes for a narrow one
    (each row reads its local and next cells and writes 16 bytes)."""
    if not progs:
        return []
    dev = _build.kernel_device(*(m for s in sources for m in s))
    if dev.type == "cpu":
        return evaluate_many_plain(progs, sources, log_ns, lqds)
    log_qs = [n + q for n, q in zip(log_ns, lqds)]
    return _launch("quotient", "ovt_quotient", progs, sources, log_qs,
                   list(lqds), True, code, dev)


def evaluate(prog: Program, sources: list, log_n: int, lqd: int) -> torch.Tensor:
    """``evaluate_many`` of one AIR: kernel K7+K11 on CUDA tensors,
    ``evaluate_plain`` on CPU tensors."""
    return evaluate_many([prog], [sources], [log_n], [lqd])[0]


def evaluate_columns_plain(prog: Program, sources: list,
                           log_n: int) -> torch.Tensor:
    """A columns program over the natural trace domain with int64 torch
    operations.  ``sources``: natural-order (2^log_n, W) Montgomery
    matrices in the program's source order.  Returns (R, 2^log_n) int32.
    A selector the program's ``sel_mask`` names reads as the natural
    domain's 0/1 value, the others as zero."""
    n = 1 << log_n
    dev = sources[0].device
    local = torch.arange(n, device=dev)
    one = bb.to_monty_int(1)
    natural = (local == 0, local == n - 1, local != n - 1)
    sels = [torch.where(natural[k], one, 0) if prog.sel_mask >> k & 1
            else torch.zeros(n, dtype=torch.int64, device=dev) for k in range(3)]
    out = torch.empty((prog.n_roots, n), dtype=torch.int64, device=dev)
    _run_plain(prog, sources, (local, torch.roll(local, -1)), sels, n, out=out)
    return out.int()


def evaluate_columns(prog: Program, sources: list, log_n: int) -> torch.Tensor:
    """Kernel K7 in its columns mode (csrc/quotient.cu) on CUDA tensors,
    ``evaluate_columns_plain`` on CPU tensors; same arguments and result.

    The quotient kernel's interpreter with one job over the natural rows
    (in the streamed launch for a budgeted program): each
    thread stores its rows' root values in their output rows, so
    neighbouring threads write neighbouring words.  Bound by bytes when the
    roots are columns and small expressions, as interaction fields are:
    each row reads its cells and writes 4 bytes per root."""
    if not sources:
        raise ValueError("a columns program reads at least one matrix")
    dev = _build.kernel_device(*sources)
    if len(sources) != prog.n_sources or prog.n_roots == 0:
        raise ValueError(f"not a columns program over {len(sources)} matrices")
    if dev.type == "cpu":
        return evaluate_columns_plain(prog, sources, log_n)
    return _launch("quotient_columns", "ovt_quotient_columns", [prog],
                   [sources], [log_n], [0], False, None, dev)[0]
