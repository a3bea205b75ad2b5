"""K8, the lookup histograms, against openvm_tpu's ``jit_dag_lookup_hist``.

A tiny synthetic AIR sends to the range, bitwise and tuple buses, with
pinned rows: bits 0, bits above 30, indices past the range and tuple
tables (dropped), indices that wrap in uint32 (tuple and bitwise: the
fields are canonical, below p < 2^31, so a range index (1 << 30) - 1 +
value cannot wrap), counts whose bin sum wraps in uint32, a zero count
over out-of-range fields, a next-row field that wraps at the last row and
a receive (not counted).  The port's interpreter columns mode and K8's
plain version give the same three tables as the JAX package and as a
python-int reference.  The VM's own fib(10) tables are checked in
test_torch_vm.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from openvm_tpu import stark as jstark
from openvm_tpu.field import babybear as jbb
from openvm_tpu.stark.evaluator import jit_dag_lookup_hist
from openvm_tpu_torch import stark
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import lookup
from openvm_tpu_torch.stark import quotient as qmod

torch.set_num_threads(1)

P = bb.P
RANGE_BUS, BITWISE_BUS, TUPLE_BUS = 3, 4, 10
RANGE_H = 1 << 16  # RangeCheckerAir's table (vm/circuit/system.py)
TUPLE_SIZES = (256, 2048)
M32 = (1 << 32) - 1


def lookup_air(base):
    class LookupAir(base):
        """[value, bits, x, y, z, is_xor, count]"""

        name = "lookup"
        width = 7

        def eval(self, b):
            v, bits, x, y, z, xr, cnt = (b.main(i) for i in range(7))
            b.push_send(RANGE_BUS, [v, bits], cnt)
            b.push_send(BITWISE_BUS, [x, y, z, xr], cnt)
            b.push_send(TUPLE_BUS, [x, y], cnt)
            b.push_send(RANGE_BUS, [b.main(0, offset=1) + x, 8], 1)
            b.push_receive(RANGE_BUS, [v, 3], cnt)

    return LookupAir()


def lookup_trace() -> np.ndarray:
    rng = np.random.default_rng(7)
    n = 16
    t = np.zeros((n, 7), dtype=np.uint64)
    bits = rng.integers(2, 17, size=n)  # bin 2 (bits 1, value 1) is rows 7-9's
    t[:, 0] = [int(rng.integers(0, 1 << int(k))) for k in bits]
    t[:, 1] = bits
    t[:, 2:4] = rng.integers(0, 256, size=(n, 2))
    t[:, 5] = rng.integers(0, 2, size=n)
    t[:, 4] = np.where(t[:, 5] == 1, t[:, 2] ^ t[:, 3], 0)
    t[:, 6] = rng.integers(1, 4, size=n)
    t[0, :2] = (123, 0)                  # bits 0: index 0
    t[1, :2] = (5, 31)                   # bits > 30: dropped
    t[2, :2] = (7, 40)
    t[3, :2] = (40000, 15)               # past range_h: dropped
    t[4, 2:4] = (300, 5)                 # past the tuple and bitwise tables
    t[5, 2:4] = ((1 << 21) + 5, 9)       # tuple index wraps into the table
    t[6, 2:6] = ((1 << 23) + 1, 3, 0, 1)  # both wrap into their tables
    for r in (7, 8, 9):                  # bin sums wrap in uint32
        t[r] = (1, 1, 1, 2, 3, 1, P - 1)
    t[10] = (P - 1, 77, P - 2, P - 3, 0, 5, 0)  # count 0: nothing
    t[15, 0] = P - 9                     # read as row 14's next row
    # row 15's next row wraps to row 0
    return t


def reference_tables(t: np.ndarray) -> list:
    """jit_dag_lookup_hist's semantics over python ints."""
    rh, bh = [0] * RANGE_H, [0] * (2 * 65536)
    th = [0] * (TUPLE_SIZES[0] * TUPLE_SIZES[1])
    n = len(t)

    def add(tab, idx, cnt):
        if cnt and idx < len(tab):
            tab[idx] = (tab[idx] + cnt) & M32

    for r in range(n):
        v, bits, x, y, z, xr, cnt = (int(a) for a in t[r])
        add(rh, 0 if bits == 0 else ((1 << min(bits, 30)) - 1 + v) & M32, cnt)
        add(bh, ((x * 256 + y) * 2 + xr) & M32, cnt)
        add(th, (x * TUPLE_SIZES[1] + y) & M32, cnt)
        add(rh, (1 << 8) - 1 + (int(t[(r + 1) % n, 0]) + x) % P, 1)
    return [np.asarray(a, dtype=np.uint64) for a in (rh, bh, th)]


@pytest.fixture(scope="module")
def tables():
    t = lookup_trace()
    kind_of = {RANGE_BUS: "range", BITWISE_BUS: "bitwise", TUPLE_BUS: "tuple"}
    jvk = jstark.keygen([lookup_air(jstark.Air)], jstark.StarkConfig()).vk.per_air[0]
    jsends = [(kind_of[bus], frs, cr) for (bus, frs, cr, s) in jvk.dag.interactions
              if s and bus in kind_of]
    n = len(t)
    env = {"main": [jbb.to_monty(jnp.asarray(t.astype(np.uint32)))],
           "preprocessed": None, "perm": None,
           "publics": jnp.zeros((64,), jnp.uint32),
           "challenges": jnp.zeros((2, 4), jnp.uint32),
           "exposed": jnp.zeros((1, 4), jnp.uint32),
           "sels": {k: jbb.zeros((n,)) for k in
                    ("is_first_row", "is_last_row", "is_transition")},
           "next_step": 1}
    jax_tabs = [np.asarray(a, dtype=np.uint64) for a in jit_dag_lookup_hist(
        jvk.dag, env, jsends, n, RANGE_H, TUPLE_SIZES)]

    vk = stark.keygen([lookup_air(stark.Air)], stark.StarkConfig(),
                      device="cpu").vk.per_air[0]
    sends = [(kind_of[bus], frs, cr) for (bus, frs, cr, s) in vk.dag.interactions
             if s and bus in kind_of]
    layout = lookup.send_layout(sends)
    prog = qmod.compile_columns(vk.dag, layout.roots, n_main=1,
                                has_preprocessed=False, publics=[0] * 64)
    cols = qmod.evaluate_columns(prog, [bb.monty(t, device="cpu")], 4)
    tabs = lookup.new_tables(RANGE_H, TUPLE_SIZES[0] * TUPLE_SIZES[1], "cpu")
    lookup.lookup_hist(cols, layout, tabs, TUPLE_SIZES[1])
    return {"trace": t, "jax": jax_tabs, "port": lookup.tables_to_host(tabs),
            "ref": reference_tables(t), "layout": layout, "cols": cols}


@pytest.mark.parametrize("k", [0, 1, 2], ids=["range", "bitwise", "tuple"])
def test_tables_equal_jax(tables, k):
    assert np.array_equal(tables["port"][k], tables["jax"][k])


@pytest.mark.parametrize("k", [0, 1, 2], ids=["range", "bitwise", "tuple"])
def test_tables_equal_reference(tables, k):
    assert np.array_equal(tables["port"][k], tables["ref"][k])


def test_pinned_out_of_range_sends(tables):
    rh, bh, th = tables["port"]
    t = tables["trace"]
    # the three rows of count p - 1 into one bin wrap in uint32
    assert rh[(1 << 1) - 1 + 1] == (3 * (P - 1)) & M32 < 3 * (P - 1)
    # bits 0 counts into bin 0
    assert rh[0] >= t[0, 6]
    # the wrapped tuple and bitwise indices land in their tables
    assert th[10240 + 9] >= t[5, 6] and th[2048 + 3] >= t[6, 6]
    assert bh[512 + 2 * 3 + 1] >= t[6, 6]
    # a table one bin shorter drops what the last bin held, nothing else
    layout, cols = tables["layout"], tables["cols"]
    short = lookup.new_tables(RANGE_H - 1, TUPLE_SIZES[0] * TUPLE_SIZES[1], "cpu")
    lookup.lookup_hist(cols, layout, short, TUPLE_SIZES[1])
    assert np.array_equal(lookup.tables_to_host(short)[0], rh[:-1])


def test_columns_layout_reads_every_field(tables):
    """Bitwise sends read x, y and is_xor; range and tuple x and y."""
    layout = tables["layout"]
    assert layout.table[:, 0].tolist() == [lookup.RANGE, lookup.BITWISE,
                                          lookup.TUPLE, lookup.RANGE]
    assert tables["cols"].shape == (len(layout.roots), 16)


# ---------------------------------------------------------------------------
# K8's one-launch design: the CPU model of its order of adds, its plan
# ---------------------------------------------------------------------------

def case_trace(name: str) -> np.ndarray:
    """32 rows of LookupAir's [value, bits, x, y, z, is_xor, count] that
    stress one part of the kernel."""
    rng = np.random.default_rng(len(name))
    n = 32
    t = np.zeros((n, 7), dtype=np.uint64)
    t[:, 2:4] = rng.integers(0, 256, size=(n, 2))
    t[:, 6] = rng.integers(1, 4, size=n)
    if name == "skewed":       # 30 of 32 rows to bin 0 of every table
        t[:30, :6] = 0
        t[30:, :2] = (5, 9)
    elif name == "wrap":       # every row's count p - 1 into one bin each
        t[:, :6] = (3, 14, 0, 1, 0, 0)
        t[:, 6] = P - 1
    elif name == "edge":       # the last bin of each table and the first past it
        rows = [(0, 16, 255, 255, 0, 1), (1, 16, 256, 0, 0, 0),
                (0, 16, 255, 2047, 0, 1), (1, 16, 256, 0, 0, 0)]
        for r in range(n):
            t[r, :6] = rows[r % 4]
    else:                      # tuple and bitwise indices that wrap in uint32
        t[:, 2] = [((1 << 21) + 5, (1 << 23) + 1)[r % 2] for r in range(n)]
        t[:, 3] = (9, 3)[0]
        t[:, 1] = 1
    return t


MODEL_CASES = ("skewed", "wrap", "edge", "wrapping_index")


@pytest.fixture(scope="module")
def model_tables():
    """Per case: JAX's tables, the plain version's and the kernel model's
    (on one block and on more blocks than units)."""
    kind_of = {RANGE_BUS: "range", BITWISE_BUS: "bitwise", TUPLE_BUS: "tuple"}
    jvk = jstark.keygen([lookup_air(jstark.Air)], jstark.StarkConfig()).vk.per_air[0]
    jsends = [(kind_of[bus], frs, cr) for (bus, frs, cr, s) in jvk.dag.interactions
              if s and bus in kind_of]
    vk = stark.keygen([lookup_air(stark.Air)], stark.StarkConfig(),
                      device="cpu").vk.per_air[0]
    sends = [(kind_of[bus], frs, cr) for (bus, frs, cr, s) in vk.dag.interactions
             if s and bus in kind_of]
    layout = lookup.send_layout(sends)
    prog = qmod.compile_columns(vk.dag, layout.roots, n_main=1,
                                has_preprocessed=False, publics=[0] * 64)
    out = {}
    for name in MODEL_CASES:
        t = case_trace(name)
        n = len(t)
        env = {"main": [jbb.to_monty(jnp.asarray(t.astype(np.uint32)))],
               "preprocessed": None, "perm": None,
               "publics": jnp.zeros((64,), jnp.uint32),
               "challenges": jnp.zeros((2, 4), jnp.uint32),
               "exposed": jnp.zeros((1, 4), jnp.uint32),
               "sels": {k: jbb.zeros((n,)) for k in
                        ("is_first_row", "is_last_row", "is_transition")},
               "next_step": 1}
        jax_tabs = [np.asarray(a, dtype=np.uint64) for a in jit_dag_lookup_hist(
            jvk.dag, env, jsends, n, RANGE_H, TUPLE_SIZES)]
        cols = qmod.evaluate_columns(prog, [bb.monty(t, device="cpu")], 5)
        got = {}
        for key, fn in (("plain", lambda c, tb: lookup.lookup_hist_plain(
                            c, layout, tb, TUPLE_SIZES[1])),
                        ("model", lambda c, tb: lookup._hist_model(
                            [c], [layout], tb, TUPLE_SIZES[1]))):
            tabs = lookup.new_tables(RANGE_H, TUPLE_SIZES[0] * TUPLE_SIZES[1], "cpu")
            fn(cols, tabs)
            fn(cols, tabs)  # a second call adds into the first call's counts
            got[key] = lookup.tables_to_host(tabs)
        out[name] = {"jax": [2 * a & M32 for a in jax_tabs], **got, "trace": t}
    return out


@pytest.mark.parametrize("name", MODEL_CASES)
def test_hist_model_equals_plain_and_jax(model_tables, name):
    """K8's order of adds (warp merges, private bins flushed per block,
    the rest straight to the tables) gives the plain version's words and
    twice JAX's tables (two calls add into the same tables)."""
    case = model_tables[name]
    for k in range(3):
        assert np.array_equal(case["model"][k], case["plain"][k])
        assert np.array_equal(case["model"][k], case["jax"][k])


def test_hist_model_pins(model_tables):
    """What each case is there for shows in the tables."""
    rh, bh, th = model_tables["skewed"]["model"]
    t = model_tables["skewed"]["trace"]
    assert rh[0] >= 2 * t[:30, 6].sum() and bh[0] == th[0] == 2 * t[:30, 6].sum()
    rh = model_tables["wrap"]["model"][0]
    assert rh[(1 << 14) - 1 + 3] == (64 * (P - 1)) & M32
    rh, bh, th = model_tables["edge"]["model"]
    assert rh[RANGE_H - 1] > 0 and bh[2 * 65536 - 1] > 0 and th[-1] > 0
    rh, bh, th = model_tables["wrapping_index"]["model"]
    x = (1 << 23) + 1
    assert th[5 * 2048 + 9] > 0 and th[(x * 2048 + 9) & M32] > 0
    assert bh[((x * 256 + 9) * 2) & M32] > 0


def test_private_slots():
    """The range table's private bins are the first RANGE_SEG values of
    each bit width (bits 14 value 0, path 3's hottest bin, among them);
    the bitwise table's its first BITWISE_HEAD bins."""
    seg = lookup.RANGE_SEG
    assert lookup.private_slot(lookup.RANGE, 0, RANGE_H) == 0
    assert lookup.private_slot(lookup.RANGE, (1 << 14) - 1, RANGE_H) == 14 * seg
    assert lookup.private_slot(lookup.RANGE, (1 << 15) - 1 + 13, RANGE_H) == 15 * seg + 13
    assert lookup.private_slot(lookup.RANGE, (1 << 10) - 1 + seg, RANGE_H) is None
    assert lookup.private_slot(lookup.RANGE, RANGE_H - 1, RANGE_H) == 16 * seg
    assert lookup.private_slot(lookup.BITWISE, lookup.BITWISE_HEAD - 1, RANGE_H) \
        == 17 * seg + lookup.BITWISE_HEAD - 1
    assert lookup.private_slot(lookup.BITWISE, lookup.BITWISE_HEAD, RANGE_H) is None
    assert lookup.private_slot(lookup.TUPLE, 0, RANGE_H) is None


def mixed_air_cols(heights, seed=3):
    """Columns of three sends (range, bitwise, tuple) at ``heights``, most
    rows on bits 14 value 0, counts up to p - 1."""
    rng = np.random.default_rng(seed)
    out = []
    for n in heights:
        v = rng.integers(0, 300, size=(7, n)).astype(np.uint64)
        v[1] = rng.integers(0, 17, size=n)
        v[2] = rng.integers(0, 3, size=n)
        hot = rng.random(n) < 0.9
        v[0, hot], v[1, hot] = 0, 14
        v[3:6, hot] = 0
        v[6] = rng.integers(0, P, size=n)
        out.append(bb.monty(v, device="cpu"))
    return out


MIXED_LAYOUT = lookup.SendLayout(roots=list(range(7)), table=np.asarray(
    [(lookup.RANGE, 0, 1, 1, 2), (lookup.BITWISE, 3, 4, 5, 2), (lookup.TUPLE, 3, 4, 4, 6)],
    dtype=np.int32))


@pytest.mark.parametrize("sms", [1, 2])
def test_many_equals_per_air_calls(sms):
    """Three AIRs of 1, 300 and 1000 rows in one call equal the per-AIR
    calls in order, and the kernel model over the one plan (one block
    walking every unit, or one block a unit) equals both."""
    cols = mixed_air_cols((1, 300, 1000))
    sizes = (RANGE_H, TUPLE_SIZES[0] * TUPLE_SIZES[1])
    many, each, model = (lookup.new_tables(*sizes, "cpu") for _ in range(3))
    lookup.lookup_hist_many(cols, [MIXED_LAYOUT] * 3, many, TUPLE_SIZES[1])
    for c in cols:
        lookup.lookup_hist(c, MIXED_LAYOUT, each, TUPLE_SIZES[1])
    lookup._hist_model(cols, [MIXED_LAYOUT] * 3, model, TUPLE_SIZES[1], sms=sms)
    for a, b, m in zip(many, each, model):
        assert torch.equal(a, b) and torch.equal(a, m)
    assert int(many[0][(1 << 14) - 1]) != 0


def test_hist_plan_maps_units_to_airs():
    """Units of HIST_THREADS rows, largest AIR first; persistent blocks
    (HIST_BLOCKS_PER_SM an SM) walk them; every row of every AIR, from 1
    row to 2^20, lies in exactly one unit, and units past an AIR's end
    hold no row."""
    heights = [1, 1000, 1 << 20, 33]
    order, first, units, blocks = lookup.hist_plan(heights, 132)
    assert order == [2, 1, 3, 0]
    assert units == sum(-(-h // lookup.HIST_THREADS) for h in heights)
    assert blocks == min(units, 132 * lookup.HIST_BLOCKS_PER_SM)
    seen = [0] * len(heights)
    for u in range(units):
        pos, rows = qmod.block_rows(first, [heights[o] for o in order], u,
                                    lookup.HIST_THREADS)
        assert rows and rows[0] == (u - first[pos]) * lookup.HIST_THREADS
        seen[order[pos]] += len(rows)
    assert seen == heights
    assert lookup.hist_plan([5], 132)[3] == 1
