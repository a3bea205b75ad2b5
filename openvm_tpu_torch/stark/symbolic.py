"""Symbolic AIR constraint system (host).

Copy of openvm_tpu/stark/symbolic.py:1-440: AIR constraints are built by
tracing a builder over symbolic row variables, deduplicated into a DAG, and
evaluated with any backend through ``SymbolicDag.eval(ops, env, roots)``:
in the port, ``stark.evaluator.HostOps`` at zeta in the verifier.  The
prover does not walk the DAG node by node: it compiles it to bytecode for
the quotient interpreter (``stark.quotient``).

Entries mirror the reference: Preprocessed | Main(part) | Permutation
(after-challenge, ext-valued) | PublicValue | Challenge | Exposed, each with
row offset 0 (local) or 1 (next).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

P = 2013265921
EXT_W = 11  # x^4 - 11

# ---------------------------------------------------------------------------
# Expression nodes (hash-consed)
# ---------------------------------------------------------------------------


class Expr:
    """Base symbolic expression over BabyBear (possibly extension-valued)."""

    _ids = itertools.count()

    def __init__(self):
        self.id = next(Expr._ids)

    # python operator sugar -------------------------------------------------
    def __add__(self, other):
        return Add(self, _lift(other))

    def __radd__(self, other):
        return Add(_lift(other), self)

    def __sub__(self, other):
        return Sub(self, _lift(other))

    def __rsub__(self, other):
        return Sub(_lift(other), self)

    def __mul__(self, other):
        return Mul(self, _lift(other))

    def __rmul__(self, other):
        return Mul(_lift(other), self)

    def __neg__(self):
        return Neg(self)

    def key(self):
        raise NotImplementedError


def _lift(x) -> "Expr":
    if isinstance(x, Expr):
        return x
    return Constant(int(x) % P)


class Constant(Expr):
    def __init__(self, value: int):
        super().__init__()
        self.value = value % P

    def key(self):
        return ("const", self.value)


class Var(Expr):
    """A trace cell: (entry, part, offset, index).

    entry: 'preprocessed' | 'main' | 'permutation' | 'public' | 'challenge'
           | 'exposed'
    part: partition index for main (cached mains then common main); phase for
          challenge/exposed/permutation (always 0 here).
    offset: 0 = local row, 1 = next row (ignored for scalars).
    index: column / value index.
    """

    def __init__(self, entry: str, part: int, offset: int, index: int):
        super().__init__()
        self.entry = entry
        self.part = part
        self.offset = offset
        self.index = index

    def key(self):
        return ("var", self.entry, self.part, self.offset, self.index)


class Selector(Expr):
    """is_first_row | is_last_row | is_transition."""

    def __init__(self, which: str):
        super().__init__()
        self.which = which

    def key(self):
        return ("sel", self.which)


class Add(Expr):
    def __init__(self, a: Expr, b: Expr):
        super().__init__()
        self.a, self.b = a, b

    def key(self):
        return ("add", self.a.id, self.b.id)


class Sub(Expr):
    def __init__(self, a: Expr, b: Expr):
        super().__init__()
        self.a, self.b = a, b

    def key(self):
        return ("sub", self.a.id, self.b.id)


class Mul(Expr):
    def __init__(self, a: Expr, b: Expr):
        super().__init__()
        self.a, self.b = a, b

    def key(self):
        return ("mul", self.a.id, self.b.id)


class Neg(Expr):
    def __init__(self, a: Expr):
        super().__init__()
        self.a = a

    def key(self):
        return ("neg", self.a.id)


def degree(e: Expr, cache=None) -> int:
    """Polynomial degree in the row variables (selectors count as degree 1)."""
    if cache is None:
        cache = {}
    if e.id in cache:
        return cache[e.id]
    if isinstance(e, Constant):
        d = 0
    elif isinstance(e, Var):
        d = 0 if e.entry in ("public", "challenge", "exposed") else 1
    elif isinstance(e, Selector):
        # is_transition is degree 1; first/last-row selectors are
        # (z_h)/(linear) of degree n-1 but the backend treats them as 1.
        d = 1
    elif isinstance(e, (Add, Sub)):
        d = max(degree(e.a, cache), degree(e.b, cache))
    elif isinstance(e, Mul):
        d = degree(e.a, cache) + degree(e.b, cache)
    elif isinstance(e, Neg):
        d = degree(e.a, cache)
    else:
        raise TypeError(type(e))
    cache[e.id] = d
    return d


# ---------------------------------------------------------------------------
# Interactions (LogUp bus messages)
# ---------------------------------------------------------------------------


@dataclass
class Interaction:
    """count * 1/(alpha + bus + sum_i beta^(i+1) fields[i]) added to the bus.

    is_send=True contributes +count, False (receive) contributes -count,
    mirroring the reference's send/receive convention on its buses
    (reference crates/vm/src/system/memory/offline_checker/bus.rs).
    """

    bus: int
    fields: list  # list[Expr]
    count: Expr
    is_send: bool


# ---------------------------------------------------------------------------
# AIR base class + builder
# ---------------------------------------------------------------------------


class Air:
    """An AIR: declares widths and evaluates constraints on a builder.

    Subclasses set `width` (common main), optionally `preprocessed` (a numpy
    (H, W) canonical matrix or None), `num_public_values`, and implement
    `eval(builder)`.
    """

    name: str = "air"
    width: int = 0
    cached_main_widths: tuple = ()
    num_public_values: int = 0

    def preprocessed_trace(self):
        return None

    def pad_to(self, trace, height: int):
        """Extend a built trace to `height` rows (fixed-height proving,
        reference NATIVE_MAX_TRACE_HEIGHTS role).  Default zero rows —
        valid for is_valid-gated chips; chips whose padding rows carry
        real data (ungated permutation tables) override."""
        import numpy as np
        n = len(trace)
        assert n <= height, f"{self.name}: trace {n} exceeds fixed {height}"
        if n == height:
            return trace
        return np.vstack([trace, np.zeros((height - n, trace.shape[1]),
                                          dtype=trace.dtype)])

    def eval(self, builder: "AirBuilder") -> None:
        raise NotImplementedError


class AirBuilder:
    def __init__(self, air: Air):
        self.air = air
        self.constraints: list[Expr] = []
        self.interactions: list[Interaction] = []
        self._condition_stack: list[Expr] = []

    # variables -------------------------------------------------------------
    def main(self, index: int, offset: int = 0, part: Optional[int] = None) -> Var:
        if part is None:
            part = len(self.air.cached_main_widths)  # common main partition
        return Var("main", part, offset, index)

    def main_row(self, offset: int = 0, part: Optional[int] = None):
        width = (self.air.width if part is None
                 else self.air.cached_main_widths[part])
        return [self.main(i, offset, part) for i in range(width)]

    def preprocessed(self, index: int, offset: int = 0) -> Var:
        return Var("preprocessed", 0, offset, index)

    def public_value(self, index: int) -> Var:
        return Var("public", 0, 0, index)

    def is_first_row(self) -> Selector:
        return Selector("is_first_row")

    def is_last_row(self) -> Selector:
        return Selector("is_last_row")

    def is_transition(self) -> Selector:
        return Selector("is_transition")

    # constraints -----------------------------------------------------------
    def _apply_conditions(self, e: Expr) -> Expr:
        for c in self._condition_stack:
            e = Mul(c, e)
        return e

    def assert_zero(self, e) -> None:
        self.constraints.append(self._apply_conditions(_lift(e)))

    def assert_eq(self, a, b) -> None:
        self.assert_zero(_lift(a) - _lift(b))

    def assert_bool(self, e) -> None:
        e = _lift(e)
        self.assert_zero(e * (e - 1))

    def when(self, condition) -> "_When":
        return _When(self, _lift(condition))

    def when_first_row(self) -> "_When":
        return self.when(self.is_first_row())

    def when_last_row(self) -> "_When":
        return self.when(self.is_last_row())

    def when_transition(self) -> "_When":
        return self.when(self.is_transition())

    # interactions ----------------------------------------------------------
    def push_send(self, bus: int, fields, count) -> None:
        self.interactions.append(
            Interaction(bus, [_lift(f) for f in fields], _lift(count), True))

    def push_receive(self, bus: int, fields, count) -> None:
        self.interactions.append(
            Interaction(bus, [_lift(f) for f in fields], _lift(count), False))


class _When:
    def __init__(self, builder: AirBuilder, condition: Expr):
        self.builder = builder
        self.condition = condition

    def __enter__(self):
        self.builder._condition_stack.append(self.condition)
        return self.builder

    def __exit__(self, *exc):
        self.builder._condition_stack.pop()
        return False


# ---------------------------------------------------------------------------
# DAG: dedup + topological node list (serializable; keygen output)
# ---------------------------------------------------------------------------


@dataclass
class SymbolicDag:
    """Flattened, deduplicated expression DAG.

    nodes: list of tuples:
      ('const', value) | ('var', entry, part, offset, index) | ('sel', which)
      | ('add', i, j) | ('sub', i, j) | ('mul', i, j) | ('neg', i)
    constraint_roots: node indices asserted to vanish on the trace domain.
    interactions: list of (bus, [field_root...], count_root, is_send).
    """

    nodes: list = field(default_factory=list)
    constraint_roots: list = field(default_factory=list)
    interactions: list = field(default_factory=list)

    @staticmethod
    def from_builder(b: AirBuilder) -> "SymbolicDag":
        dag = SymbolicDag()
        memo: dict = {}
        key_index: dict = {}

        def visit(e: Expr) -> int:
            if e.id in memo:
                return memo[e.id]
            if isinstance(e, (Add, Sub, Mul)):
                ia, ib = visit(e.a), visit(e.b)
                node = (type(e).__name__.lower(), ia, ib)
            elif isinstance(e, Neg):
                node = ("neg", visit(e.a))
            elif isinstance(e, Constant):
                node = ("const", e.value)
            elif isinstance(e, Var):
                node = ("var", e.entry, e.part, e.offset, e.index)
            elif isinstance(e, Selector):
                node = ("sel", e.which)
            else:
                raise TypeError(type(e))
            if node in key_index:
                idx = key_index[node]
            else:
                idx = len(dag.nodes)
                dag.nodes.append(node)
                key_index[node] = idx
            memo[e.id] = idx
            return idx

        for c in b.constraints:
            dag.constraint_roots.append(visit(c))
        for it in b.interactions:
            dag.interactions.append(
                (it.bus, [visit(f) for f in it.fields], visit(it.count),
                 it.is_send))
        return dag

    def max_degree(self) -> int:
        degs = [0] * len(self.nodes)
        for i, n in enumerate(self.nodes):
            op = n[0]
            if op == "const":
                degs[i] = 0
            elif op == "var":
                degs[i] = 0 if n[1] in ("public", "challenge", "exposed") else 1
            elif op == "sel":
                degs[i] = 1
            elif op in ("add", "sub"):
                degs[i] = max(degs[n[1]], degs[n[2]])
            elif op == "mul":
                degs[i] = degs[n[1]] + degs[n[2]]
            elif op == "neg":
                degs[i] = degs[n[1]]
        return max((degs[r] for r in self.constraint_roots), default=0)

    def eval(self, ops, env, roots=None) -> list:
        """Evaluate nodes with a backend `ops` and environment `env`.

        ops provides: const(v), var(entry, part, offset, index), sel(which),
        add(a,b), sub(a,b), mul(a,b), neg(a).  Returns values per node.
        If `roots` is given, only the subgraph reachable from those node
        indices is evaluated (others stay None).
        """
        if roots is not None:
            needed = set()
            stack = list(roots)
            while stack:
                i = stack.pop()
                if i in needed:
                    continue
                needed.add(i)
                n = self.nodes[i]
                if n[0] in ("add", "sub", "mul"):
                    stack += [n[1], n[2]]
                elif n[0] == "neg":
                    stack.append(n[1])
            indices = sorted(needed)
        else:
            indices = range(len(self.nodes))
        vals: list[Any] = [None] * len(self.nodes)
        for i in indices:
            n = self.nodes[i]
            op = n[0]
            if op == "const":
                vals[i] = ops.const(n[1])
            elif op == "var":
                vals[i] = ops.var(env, n[1], n[2], n[3], n[4])
            elif op == "sel":
                vals[i] = ops.sel(env, n[1])
            elif op == "add":
                vals[i] = ops.add(vals[n[1]], vals[n[2]])
            elif op == "sub":
                vals[i] = ops.sub(vals[n[1]], vals[n[2]])
            elif op == "mul":
                vals[i] = ops.mul(vals[n[1]], vals[n[2]])
            elif op == "neg":
                vals[i] = ops.neg(vals[n[1]])
        return vals
