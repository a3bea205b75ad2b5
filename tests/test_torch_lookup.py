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
