"""Lookup-multiplicity histograms of the range, bitwise and tuple buses.

Port of openvm_tpu/stark/evaluator.py:253-323 (``jit_dag_lookup_hist``),
the histogram half of ``VirtualMachine._lookup_multiplicities``
(vm/machine.py:591-660).  An AIR's sends are evaluated over its natural
trace by the quotient interpreter's columns mode (K7, ``stark.quotient``);
``lookup_hist_many`` (kernel K8, csrc/lookup.cu) adds every AIR's
canonical counts, in one launch, into three uint32 tables on the device:

  range    (range_h,)            index (1 << min(bits, 30)) - 1 + value,
                                 or 0 when bits is 0
  bitwise  (2 * 65536,)          index (x * 256 + y) * 2 + is_xor
  tuple    (max(sizes product, 1),)  index x * sizes[1] + y

Indices wrap in uint32, a row whose count is 0 adds nothing, and an index
past its table is dropped (``mode="drop"``, evaluator.py:304-313).
``_hist_model`` models the kernel's order of adds on the CPU: warps of
lanes merged by equal bins, private bins per block.  The tables hold
uint32 bit patterns in int32 tensors; ``tables_to_host`` reads them as
uint64 numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..field import babybear as bb
from . import quotient as qmod

P = bb.P
RANGE, BITWISE, TUPLE = 0, 1, 2
KINDS = {"range": RANGE, "bitwise": BITWISE, "tuple": TUPLE}
BITWISE_BINS = 2 * 65536
_M32 = (1 << 32) - 1


@dataclass
class SendLayout:
    """roots: the columns program's roots, the distinct DAG nodes the sends
    read; table: (S, 5) int32 [kind, row of x (value), row of y (bits),
    row of is_xor, row of count]."""

    roots: list
    table: np.ndarray


def send_layout(sends: list) -> SendLayout:
    """``sends``: [(kind name, field roots, count root)] as
    ``jit_dag_lookup_hist`` takes them.  A node that several sends read
    (a count, a shared limb) is one row of the columns output."""
    row_of: dict = {}

    def row(node) -> int:
        return row_of.setdefault(node, len(row_of))

    rows = []
    for kind, frs, cr in sends:
        k = KINDS[kind]
        x, y = row(frs[0]), row(frs[1])
        rows.append((k, x, y, row(frs[3]) if k == BITWISE else y, row(cr)))
    return SendLayout(roots=list(row_of),
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
        count = c[rc]
        idx = _indices(c, kind, rx, ry, rz, sizes1)
        live = (count != 0) & (idx < acc[kind].shape[0])
        acc[kind].index_add_(0, idx[live], count[live])
    for t, a in zip(tables, acc):
        a &= _M32
        t.copy_(torch.where(a >= 1 << 31, a - (1 << 32), a).int())
    return tables


# The kernel's job table (csrc/lookup.cu H_*): HIST_JOB_WORDS int64 an AIR.
# A unit is HIST_THREADS rows of one AIR, a thread a row; HIST_BLOCKS_PER_SM
# persistent blocks an SM walk the units.  Each block keeps RANGE_SEG
# private bins for each bit width of the range table and BITWISE_HEAD for
# the bitwise table's head.
H_COLS, H_N, H_SEND, H_NSENDS, H_BLOCK0 = range(5)
HIST_JOB_WORDS = 8
HIST_THREADS = 256
HIST_BLOCKS_PER_SM = 4
RANGE_SEG = 256
BITWISE_HEAD = 512
WARP = 32


def send_table(layouts: list) -> tuple:
    """Every AIR's sends in one (S, 5) int32 table, and each AIR's first
    row: the part of the kernel's tables that depends on the AIRs only."""
    tabs = [lay.table for lay in layouts]
    first = np.cumsum([0] + [len(t) for t in tabs])[:-1].tolist()
    table = np.concatenate(tabs) if tabs else np.zeros((0, 5), np.int32)
    return np.ascontiguousarray(table, dtype=np.int32), first


def hist_plan(heights: list, sms: int) -> tuple:
    """The kernel's map of units to AIRs: (order, first, units, blocks).
    Units of HIST_THREADS rows, largest AIR first (``quotient.block_plan``);
    ``blocks`` persistent blocks, HIST_BLOCKS_PER_SM an SM at most, and
    block b takes units b, b + blocks, ..."""
    order, first, units = qmod.block_plan(heights, HIST_THREADS)
    return order, first, units, max(1, min(units, sms * HIST_BLOCKS_PER_SM))


def _indices(c: torch.Tensor, kind: int, rx: int, ry: int, rz: int,
             sizes1: int) -> torch.Tensor:
    """One send's uint32 index per row (int64), from canonical columns."""
    x, y = c[rx], c[ry]
    if kind == RANGE:
        high = torch.bitwise_left_shift(torch.ones_like(y), torch.clamp(y, max=30))
        return torch.where(y == 0, 0, (high - 1 + x) & _M32)
    if kind == TUPLE:
        return (x * sizes1 + y) & _M32
    return ((x * 256 + y) * 2 + c[rz]) & _M32


def private_slot(kind: int, idx: int, range_h: int) -> int | None:
    """The private bin of a kept index, as the kernel's ``add_key`` picks
    it, or None for a bin added in device memory: a range bin (1 << b) - 1
    + v with v < RANGE_SEG is slot b * RANGE_SEG + v; a bitwise bin below
    BITWISE_HEAD follows the range table's slots."""
    if kind == RANGE:
        b = (idx + 1).bit_length() - 1
        v = idx + 1 - (1 << b)
        return b * RANGE_SEG + v if v < RANGE_SEG else None
    if kind == BITWISE and idx < BITWISE_HEAD:
        return range_h.bit_length() * RANGE_SEG + idx
    return None


def _hist_model(cols_list: list, layouts: list, tables: tuple, sizes1: int,
                sms: int = 1) -> tuple:
    """K8's arithmetic modelled on the CPU over the same plan
    (``hist_plan``): each block walks its units; per send, a warp's 32
    lanes with a live send on the same (table, index) are merged into one
    add by the lowest of them; adds to a private bin (``private_slot``)
    go to the block's copy, flushed into the table when the block ends;
    the rest straight to the table, all in wrapping uint32.  Adds into
    ``tables`` in place, as ``lookup_hist_plain`` does for each AIR."""
    range_h = int(tables[0].shape[0])
    limits = (range_h, BITWISE_BINS, int(tables[2].shape[0]))
    acc = [[int(v) & _M32 for v in t.tolist()] for t in tables]
    canon = [bb.from_monty_plain(c).long() for c in cols_list]
    order, first, units, blocks = hist_plan([int(c.shape[1]) for c in cols_list], sms)
    n_priv = range_h.bit_length() * RANGE_SEG + BITWISE_HEAD
    for blk in range(blocks):
        priv = [0] * n_priv
        for u in range(blk, units, blocks):
            pos = max(k for k in range(len(first)) if first[k] <= u)
            a = order[pos]
            c, n = canon[a], int(cols_list[a].shape[1])
            row0 = (u - first[pos]) * HIST_THREADS
            for kind, rx, ry, rz, rc in layouts[a].table.tolist():
                for w0 in range(row0, row0 + HIST_THREADS, WARP):
                    rows = [j for j in range(w0, w0 + WARP) if j < n]
                    if not rows:
                        continue
                    r = torch.tensor(rows)
                    idx = _indices(c[:, r], kind, rx, ry, rz, sizes1).tolist()
                    groups: dict = {}
                    for i, cnt in zip(idx, c[rc, r].tolist()):
                        if cnt and i < limits[kind]:
                            groups[i] = (groups.get(i, 0) + cnt) & _M32
                    for i, total in groups.items():
                        slot = private_slot(kind, i, range_h)
                        if slot is None:
                            acc[kind][i] = (acc[kind][i] + total) & _M32
                        else:
                            priv[slot] = (priv[slot] + total) & _M32
        for slot, v in enumerate(priv):
            if not v:
                continue
            if slot < range_h.bit_length() * RANGE_SEG:
                b, off = divmod(slot, RANGE_SEG)
                acc[RANGE][(1 << b) - 1 + off] = (acc[RANGE][(1 << b) - 1 + off] + v) & _M32
            else:
                i = slot - range_h.bit_length() * RANGE_SEG
                acc[BITWISE][i] = (acc[BITWISE][i] + v) & _M32
    for t, a in zip(tables, acc):
        t.copy_(torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in a],
                             dtype=torch.int32))
    return tables


def lookup_hist_many(cols_list: list, layouts: list, tables: tuple, sizes1: int) -> tuple:
    """Kernel K8 (csrc/lookup.cu) over every AIR in one launch on CUDA
    tensors, ``lookup_hist_plain`` for each AIR in order on CPU tensors:
    the AIRs' sends added into ``tables`` in place.  ``cols_list``: each
    AIR's (R, N) columns output over its layout's roots.  The job table
    and ``send_table(layouts)`` go up in one copy."""
    if not cols_list:
        return tables
    dev = _build.kernel_device(*cols_list, *tables)
    if dev.type == "cpu":
        for cols, layout in zip(cols_list, layouts):
            lookup_hist_plain(cols, layout, tables, sizes1)
        return tables
    for name, t in zip(("range", "bitwise", "tuple"), tables):
        _build.check_words(t, name, dev)
    for cols, layout in zip(cols_list, layouts):
        _build.check_words(cols, "cols", dev)
        if cols.shape[0] != len(layout.roots):
            raise ValueError("cols must hold the layout's roots")
    range_h, tuple_h = int(tables[0].shape[0]), int(tables[2].shape[0])
    if tables[1].shape[0] != BITWISE_BINS or range_h + BITWISE_BINS + tuple_h >= _M32:
        raise ValueError(f"the bitwise table must have {BITWISE_BINS} bins, and the "
                         "three tables fewer than 2^32 - 1 together")
    live = [k for k, c in enumerate(cols_list)
            if c.shape[1] and len(layouts[k].table)]
    if not live:
        return tables
    sends, first_send = send_table(layouts)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    order, first, units, blocks = hist_plan([int(cols_list[k].shape[1]) for k in live],
                                            sms)
    jobs = np.zeros((len(live), HIST_JOB_WORDS), dtype=np.int64)
    for pos, o in enumerate(order):
        k = live[o]
        jobs[pos, [H_COLS, H_N, H_SEND, H_NSENDS, H_BLOCK0]] = (
            cols_list[k].data_ptr(), cols_list[k].shape[1], first_send[k],
            len(layouts[k].table), first[pos])
    buf, offs = _build.upload([jobs, sends], dev)
    _build.launch("lookup_hist", "ovt_lookup_hist", dev, buf.data_ptr(), len(jobs),
                  units, blocks, buf.data_ptr() + offs[1], tables[0].data_ptr(), range_h,
                  tables[1].data_ptr(), tables[2].data_ptr(), tuple_h, sizes1)
    return tables


def lookup_hist(cols: torch.Tensor, layout: SendLayout, tables: tuple,
                sizes1: int) -> tuple:
    """``lookup_hist_many`` of one AIR: kernel K8 on CUDA tensors,
    ``lookup_hist_plain`` on CPU tensors."""
    return lookup_hist_many([cols], [layout], tables, sizes1)
