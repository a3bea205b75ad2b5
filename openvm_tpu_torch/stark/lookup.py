"""Lookup-multiplicity histograms of the range, bitwise and tuple buses.

Port of openvm_tpu/stark/evaluator.py:253-323 (``jit_dag_lookup_hist``),
the histogram half of ``VirtualMachine._lookup_multiplicities``
(vm/machine.py:591-660).  An AIR's sends are evaluated over its natural
trace by the quotient interpreter's columns mode (K7, ``stark.quotient``);
``lookup_hist`` (kernel K8, csrc/lookup.cu) adds their canonical counts
into three uint32 tables kept on the device across AIRs:

  range    (range_h,)            index (1 << min(bits, 30)) - 1 + value,
                                 or 0 when bits is 0
  bitwise  (2 * 65536,)          index (x * 256 + y) * 2 + is_xor
  tuple    (max(sizes product, 1),)  index x * sizes[1] + y

Indices wrap in uint32, a row whose count is 0 adds nothing, and an index
past its table is dropped (``mode="drop"``, evaluator.py:304-313).  The
tables hold uint32 bit patterns in int32 tensors; ``tables_to_host`` reads
them as uint64 numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..field import babybear as bb

P = bb.P
RANGE, BITWISE, TUPLE = 0, 1, 2
KINDS = {"range": RANGE, "bitwise": BITWISE, "tuple": TUPLE}
BITWISE_BINS = 2 * 65536
_M32 = (1 << 32) - 1


@dataclass
class SendLayout:
    """roots: the columns program's roots; table: (S, 5) int32 [kind, row
    of x (value), row of y (bits), row of is_xor, row of count]."""

    roots: list
    table: np.ndarray


def send_layout(sends: list) -> SendLayout:
    """``sends``: [(kind name, field roots, count root)] as
    ``jit_dag_lookup_hist`` takes them."""
    roots, rows = [], []
    for kind, frs, cr in sends:
        k = KINDS[kind]
        base = len(roots)
        if k == BITWISE:
            roots += [frs[0], frs[1], frs[3], cr]
            rows.append((k, base, base + 1, base + 2, base + 3))
        else:
            roots += [frs[0], frs[1], cr]
            rows.append((k, base, base + 1, base + 1, base + 2))
    return SendLayout(roots=roots,
                      table=np.asarray(rows, dtype=np.int32).reshape(-1, 5))


def new_tables(range_h: int, tuple_total: int, device) -> tuple:
    """Zeroed (range, bitwise, tuple) tables on ``device``."""
    return tuple(torch.zeros(n, dtype=torch.int32, device=device)
                 for n in (range_h, BITWISE_BINS, max(tuple_total, 1)))


def tables_to_host(tables: tuple) -> list:
    """The tables' uint32 values as uint64 numpy arrays, one copy each."""
    return [t.cpu().numpy().view(np.uint32).astype(np.uint64) for t in tables]


def lookup_hist_plain(cols: torch.Tensor, layout: SendLayout, tables: tuple,
                      sizes1: int) -> tuple:
    """Add one AIR's sends into ``tables`` in place, plain PyTorch (int64
    sums wrapped to uint32).  cols: (R, N) Montgomery output of the columns
    program over ``layout.roots``."""
    c = bb.from_monty_plain(cols).long()
    acc = [(t.long() & _M32) for t in tables]
    for kind, rx, ry, rz, rc in layout.table.tolist():
        count, x, y = c[rc], c[rx], c[ry]
        if kind == RANGE:
            high = torch.bitwise_left_shift(torch.ones_like(y),
                                            torch.clamp(y, max=30))
            idx = torch.where(y == 0, 0, (high - 1 + x) & _M32)
        elif kind == TUPLE:
            idx = (x * sizes1 + y) & _M32
        else:
            idx = ((x * 256 + y) * 2 + c[rz]) & _M32
        live = (count != 0) & (idx < acc[kind].shape[0])
        acc[kind].index_add_(0, idx[live], count[live])
    for t, a in zip(tables, acc):
        a &= _M32
        t.copy_(torch.where(a >= 1 << 31, a - (1 << 32), a).int())
    return tables


def lookup_hist(cols: torch.Tensor, layout: SendLayout, tables: tuple,
                sizes1: int) -> tuple:
    """Kernel K8 (csrc/lookup.cu) on CUDA tensors, ``lookup_hist_plain`` on
    CPU tensors: one AIR's sends added into ``tables`` in place."""
    dev = _build.kernel_device(cols, *tables)
    if dev.type == "cpu":
        return lookup_hist_plain(cols, layout, tables, sizes1)
    for name, t in zip(("cols", "range", "bitwise", "tuple"), (cols,) + tuple(tables)):
        _build.check_words(t, name, dev)
    if cols.shape[0] != len(layout.roots) or tables[1].shape[0] != BITWISE_BINS:
        raise ValueError("cols must hold the layout's roots; the bitwise table "
                         f"{BITWISE_BINS} bins")
    n = int(cols.shape[1])
    table = torch.from_numpy(layout.table).to(dev)
    _build.launch("lookup_hist", "ovt_lookup_hist", dev, cols.data_ptr(), n,
                  table.data_ptr(), int(table.shape[0]), tables[0].data_ptr(),
                  int(tables[0].shape[0]), tables[1].data_ptr(),
                  tables[2].data_ptr(), int(tables[2].shape[0]), sizes1)
    return tables
