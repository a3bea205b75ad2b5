"""LogUp permutation argument: constraint synthesis and the permutation trace.

Host half, a copy of openvm_tpu/stark/logup.py:36-132
(``chunk_interactions``, ``append_logup_constraints``) and :442-444
(``num_logup_constraints``), so that ``keygen`` gives the same DAG and
verifying key as the JAX package.

Device half, a port of logup.py:155-336 (``stack_interactions``,
``batched_denoms``, ``_perm_block``, ``build_perm_trace``,
``_perm_tail_jit``):
  * the interaction fields and counts are evaluated over the natural trace
    by the quotient interpreter's columns mode (K7, ``stark.quotient``);
  * ``perm_cols_many`` (kernel K9, csrc/logup.cu) turns every AIR's into
    its chunk columns sum sign * count / denominator in one launch,
    written straight into the first 4m columns of each (N, 4m + 4)
    permutation trace;
  * ``perm_scan`` (kernel K10) writes phi, their running row sum, into the
    last 4 columns of that buffer in place, and returns its last row, the
    cumulative sum.
The JAX package's pow2 bucketing of the interaction, field and chunk axes
and its row floor (logup.py:284-313) only share XLA compiles: padded
interactions count 0 and padded rows are sliced off, so they change no
value and are not ported.  Its batched ``eval_logup_folded`` (:350) is
the quotient interpreter folding the LogUp roots that keygen appends to
every DAG, in the same pass as the AIR's own constraints.

Scheme: challenges alpha = ch[0], beta = ch[1] (extension).  Interaction i
has denominator alpha + bus_i + sum_j beta^(j+1) field_{i,j} and signed
count +count (send) or -count (receive).  Interactions are chunked so each
chunk constraint stays within the configured max constraint degree; each
chunk gets a permutation column, phi is their running sum, and its last
value is exposed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..field import babybear as bb
from ..field import ext as ef
from . import npext as nx
from . import quotient as qmod
from .symbolic import AirBuilder, Interaction, Var, degree

P = bb.P


def chunk_interactions(interactions: list[Interaction],
                       max_constraint_degree: int) -> list[list[int]]:
    """Greedily chunk interaction indices keeping constraint degree bounded."""
    chunks: list[list[int]] = []
    cur: list[int] = []
    cur_denom_deg = 0

    def d_deg(it: Interaction) -> int:
        return max([degree(f) for f in it.fields], default=0)

    for i, it in enumerate(interactions):
        dd = max(d_deg(it), 1)
        cd = degree(it.count)
        # chunk constraint degree ~ 1 + sum(denom degs) (LHS) — keep <= max
        new_deg = 1 + cur_denom_deg + dd
        rhs_deg = cd + cur_denom_deg  # conservative
        if cur and max(new_deg, rhs_deg) > max_constraint_degree:
            chunks.append(cur)
            cur = []
            cur_denom_deg = 0
        cur.append(i)
        cur_denom_deg += dd
    if cur:
        chunks.append(cur)
    return chunks


def append_logup_constraints(builder: AirBuilder,
                             max_constraint_degree: int) -> int:
    """Append LogUp constraints for builder.interactions; returns num chunks.

    Permutation columns are Var('permutation', 0, offset, j), challenges
    Var('challenge', 0, 0, {0,1}), the exposed cumulative sum
    Var('exposed', 0, 0, 0); all three are extension-valued.
    """
    its = builder.interactions
    if not its:
        return 0
    chunks = chunk_interactions(its, max_constraint_degree)
    alpha = Var("challenge", 0, 0, 0)
    beta = Var("challenge", 0, 0, 1)

    # beta powers by log-depth products; hash-consing shares the table
    # across all denominators (the DAG must equal the JAX package's).
    bpows = {0: None, 1: beta}

    def bpow(k: int):
        if k not in bpows:
            h = k // 2
            bpows[k] = bpow(h) * bpow(k - h)
        return bpows[k]

    def denom(it: Interaction):
        acc = alpha + it.bus
        for j, f in enumerate(it.fields):
            acc = acc + bpow(j + 1) * f
        return acc

    def signed_count(it: Interaction):
        return it.count if it.is_send else -it.count

    num_chunks = len(chunks)
    for j, chunk in enumerate(chunks):
        denoms = [denom(its[i]) for i in chunk]
        perm_j = Var("permutation", 0, 0, j)
        lhs = perm_j
        for d in denoms:
            lhs = lhs * d
        rhs = None
        for a, i in enumerate(chunk):
            term = signed_count(its[i])
            for b2, _ in enumerate(chunk):
                if b2 != a:
                    term = term * denoms[b2]
            rhs = term if rhs is None else rhs + term
        builder.constraints.append(lhs - rhs)

    phi = Var("permutation", 0, 0, num_chunks)
    phi_next = Var("permutation", 0, 1, num_chunks)
    perm_sum_local = None
    perm_sum_next = None
    for j in range(num_chunks):
        pl = Var("permutation", 0, 0, j)
        pn = Var("permutation", 0, 1, j)
        perm_sum_local = pl if perm_sum_local is None else perm_sum_local + pl
        perm_sum_next = pn if perm_sum_next is None else perm_sum_next + pn

    first = builder.is_first_row()
    trans = builder.is_transition()
    last = builder.is_last_row()
    builder.constraints.append(first * (phi - perm_sum_local))
    builder.constraints.append(trans * (phi_next - phi - perm_sum_next))
    builder.constraints.append(last * (phi - Var("exposed", 0, 0, 0)))
    return num_chunks


def num_logup_constraints(vk) -> int:
    """Number of constraint roots appended by append_logup_constraints."""
    return (len(vk.interaction_chunks) + 3) if vk.dag.interactions else 0


# ---------------------------------------------------------------------------
# The permutation trace (device half)
# ---------------------------------------------------------------------------


@dataclass
class InteractionLayout:
    """Where an AIR's interactions sit in the output of its columns program.

    roots: the distinct DAG nodes the interactions read (fields and
    counts), in order of first use: output row k is roots[k]; rows: for
    each interaction in order, the output rows of its fields then of its
    count; table: (I, 4) int32 [its first entry in rows, number of fields,
    chunk, is_send]; bus_m: (I,) Montgomery words of the bus ids; m:
    chunks; f_max: the most fields of one interaction."""

    roots: list
    rows: np.ndarray
    table: np.ndarray
    bus_m: np.ndarray
    m: int
    f_max: int


def interaction_layout(dag, chunks: list) -> InteractionLayout:
    """An AIR's interactions over a columns program of their distinct
    nodes: an AIR's fields repeat nodes (rv32_base_alu's 112 fields and
    counts are 50 nodes), so each is evaluated, stored and read once."""
    chunk_of = {i: j for j, chunk in enumerate(chunks) for i in chunk}
    row_of: dict = {}
    rows, table = [], []
    for i, (_, frs, cr, is_send) in enumerate(dag.interactions):
        table.append((len(rows), len(frs), chunk_of[i], int(is_send)))
        rows.extend(row_of.setdefault(node, len(row_of)) for node in list(frs) + [cr])
    table = np.asarray(table, dtype=np.int32).reshape(-1, 4)
    if np.any(np.diff(table[:, 2]) < 0):
        raise ValueError("interaction chunks must be contiguous and ascending")
    bus_m = np.asarray([bb.to_monty_int(bus % P) for (bus, _, _, _)
                        in dag.interactions], dtype=np.uint32)
    return InteractionLayout(
        roots=list(row_of), rows=np.asarray(rows, dtype=np.int32), table=table,
        bus_m=bus_m, m=len(chunks),
        f_max=max((len(frs) for (_, frs, _, _) in dag.interactions), default=0))


def beta_powers(beta, f_max: int) -> np.ndarray:
    """(f_max, 4) Montgomery words beta^1 .. beta^f_max, exact host values
    (the JAX package's ``_beta_pows``, logup.py:218, by another product
    order); ``beta`` canonical (4,)."""
    pows = np.zeros((max(f_max, 1), 4), dtype=np.uint64)
    cur = np.asarray(beta, dtype=np.uint64)
    for j in range(f_max):
        pows[j] = cur
        cur = nx.nmul(cur, np.asarray(beta, dtype=np.uint64))
    return bb.to_monty_np(pows)


def stack_interactions(cols: torch.Tensor, layout: InteractionLayout) -> tuple:
    """(fields (I, F, N) zero-padded along F, signed counts (I, N) with
    receives negated, bus_m (I,)) as int64 Montgomery words, from the
    columns program's (R, N) output (logup.py:155-187)."""
    n = cols.shape[1]
    n_its = layout.table.shape[0]
    c = cols.long()
    fields = torch.zeros((n_its, max(layout.f_max, 1), n), dtype=torch.int64,
                         device=cols.device)
    sc = torch.empty((n_its, n), dtype=torch.int64, device=cols.device)
    rows = torch.from_numpy(layout.rows.astype(np.int64)).to(cols.device)
    for i, (first, nf, _, is_send) in enumerate(layout.table.tolist()):
        fields[i, :nf] = c[rows[first:first + nf]]
        count = c[rows[first + nf]]
        sc[i] = count if is_send else bb.sub64(torch.zeros_like(count), count)
    bus_m = torch.from_numpy(layout.bus_m.astype(np.int64)).to(cols.device)
    return fields, sc, bus_m


def batched_denoms(fields, bus_m, alpha, beta_pows) -> torch.Tensor:
    """d_i = alpha + bus_i + sum_j beta^(j+1) fields[i, j] -> (I, N, 4)
    int64 (logup.py:231); alpha (4,), beta_pows (F, 4) Montgomery."""
    n_its, f_max, n = fields.shape
    acc = alpha.long().expand(n_its, 4).clone()
    acc[:, 0] = bb.add64(acc[:, 0], bus_m)
    acc = acc[:, None, :].expand(n_its, n, 4)
    bp = beta_pows.long()
    for j in range(f_max):
        acc = bb.add64(acc, bb.mul64(fields[:, j, :, None], bp[j]))
    return acc


def perm_cols_plain(cols: torch.Tensor, layout: InteractionLayout,
                    alpha: torch.Tensor, beta_pows: torch.Tensor) -> torch.Tensor:
    """(N, 4m) int32 chunk columns sum_i sign_i count_i / d_i
    (logup.py:247-263), plain PyTorch."""
    fields, sc, bus_m = stack_interactions(cols, layout)
    d = batched_denoms(fields, bus_m, alpha, beta_pows)
    contrib = ef.scale64(ef.inv64(d), sc)  # (I, N, 4)
    n = cols.shape[1]
    perm = torch.zeros((layout.m, n, 4), dtype=torch.int64, device=cols.device)
    for i, chunk in enumerate(layout.table[:, 2].tolist()):
        perm[chunk] = bb.add64(perm[chunk], contrib[i])
    return perm.permute(1, 0, 2).reshape(n, 4 * layout.m).int()


def perm_buffer(n: int, m: int, device) -> torch.Tensor:
    """The (N, 4m) chunk columns of a new (N, 4m + 4) permutation trace:
    the view K9 writes and K10 reads, phi's 4 columns beside each row."""
    return torch.empty((n, 4 * m + 4), dtype=torch.int32, device=device)[:, :4 * m]


def _trace_of(perm: torch.Tensor) -> torch.Tensor:
    """The (N, 4m + 4) trace whose first 4m columns ``perm`` is."""
    n, w = (int(x) for x in perm.shape)
    if (perm.dim() != 2 or perm.dtype != torch.int32 or w % 4 or w == 0
            or perm.stride(1) != 1 or (n > 1 and perm.stride(0) != w + 4)
            or perm.data_ptr() % 16
            or perm.untyped_storage().nbytes() < 4 * (perm.storage_offset() + n * (w + 4))):
        raise ValueError("perm must be the first 4m columns of an (N, 4m + 4) "
                         "int32 buffer (perm_buffer)")
    return perm.as_strided((n, w + 4), (w + 4, 1))


# K9's job table (csrc/logup.cu P_*): PERM_JOB_WORDS int64 an AIR.  A block
# takes up to PERM_THREADS rows of one AIR, a thread a row, and inverts
# PERM_BATCH interactions of its row at a time.
P_COLS, P_N, P_ITS, P_NITS, P_M, P_OUT, P_BLOCK0 = range(7)
PERM_JOB_WORDS = 8
PERM_THREADS = 128
PERM_BATCH = 4


def perm_shape(max_m: int, f_max: int) -> tuple:
    """K9's launch shape for jobs of at most ``max_m`` chunks and
    ``f_max`` fields an interaction: (threads, stage_w, n_ab, shared
    bytes).  Shared memory holds alpha and beta's powers (n_ab 16-byte
    words: the powers padded to a multiple of 4, as the kernel reads fields
    4 at a time) and stage_w (odd, so rows fall on different banks) chunk
    sums a thread; fewer threads when that passes qmod.SMEM_BYTES."""
    stage_w = max_m | 1
    n_ab = 1 + 4 * max(1, -(-f_max // 4))
    for threads in (PERM_THREADS, 64, 32):
        smem = (n_ab + threads * stage_w) * 16
        if smem <= qmod.SMEM_BYTES:
            return threads, stage_w, n_ab, smem
    raise ValueError(f"{max_m} chunks do not fit K9's shared memory")


def interaction_table(layouts: list) -> tuple:
    """Every AIR's interactions as one int32 array: (I, 4) rows (their
    first entry made an offset into the joined ``rows``), then I bus words,
    then every AIR's ``rows``; and each AIR's first interaction.  The part
    of K9's tables that depends on the AIRs only."""
    first = np.cumsum([0] + [len(lay.table) for lay in layouts])[:-1].tolist()
    row0 = np.cumsum([0] + [len(lay.rows) for lay in layouts])[:-1]
    tabs = [lay.table + np.asarray([r, 0, 0, 0], np.int32) for lay, r in zip(layouts, row0)]
    parts = [t.reshape(-1) for t in tabs] + [lay.bus_m.view(np.int32) for lay in layouts]
    parts += [lay.rows for lay in layouts]
    return np.concatenate(parts + [np.zeros(0, np.int32)]).astype(np.int32), first


def _words_np(x) -> np.ndarray:
    """Montgomery words as a uint32 numpy array, from a tensor or an array."""
    if isinstance(x, torch.Tensor):
        return bb.to_numpy(x)
    return np.asarray(x, dtype=np.uint32)


def perm_cols_many(cols_list: list, layouts: list, alpha, beta_pows) -> list:
    """Kernel K9 (csrc/logup.cu) over every AIR in one launch on CUDA
    tensors, ``perm_cols_plain`` for each AIR on CPU tensors.  cols_list:
    each AIR's (R, N) int32 Montgomery output of its columns program;
    alpha (4,) and beta_pows (>= every layout's f_max, 4) Montgomery words,
    tensors or numpy arrays.  The job table, ``interaction_table(layouts)``
    and alpha and beta's powers go up in one copy.  On CUDA each result is
    a ``perm_buffer`` view: the first 4m columns of the AIR's permutation
    trace."""
    if not cols_list:
        return []
    dev = _build.kernel_device(*cols_list)
    if dev.type == "cpu":
        a, b = (torch.from_numpy(_words_np(x).astype(np.int64)) for x in (alpha, beta_pows))
        return [perm_cols_plain(c, lay, a, b.reshape(-1, 4))
                for c, lay in zip(cols_list, layouts)]
    ab = np.concatenate([_words_np(alpha).reshape(1, 4),
                         _words_np(beta_pows).reshape(-1, 4)])
    outs, live = [], []
    for k, (cols, lay) in enumerate(zip(cols_list, layouts)):
        _build.check_words(cols, "cols", dev)
        if cols.shape[0] != len(lay.roots) or len(ab) <= lay.f_max:
            raise ValueError(f"cols has {cols.shape[0]} rows, the layout "
                             f"{len(lay.roots)}; beta_pows must cover {lay.f_max} fields")
        outs.append(perm_buffer(int(cols.shape[1]), lay.m, dev))
        if cols.shape[1] and len(lay.table):
            live.append(k)
    if not live:
        return outs
    threads, stage_w, n_ab, _ = perm_shape(
        max(layouts[k].m for k in live), max(layouts[k].f_max for k in live))
    ab = np.concatenate([ab, np.zeros((max(0, n_ab - len(ab)), 4), np.uint32)])[:n_ab]
    order, first, total = qmod.block_plan([int(cols_list[k].shape[1]) for k in live],
                                          threads)
    its, first_it = interaction_table(layouts)
    jobs = np.zeros((len(live), PERM_JOB_WORDS), dtype=np.int64)
    for pos, o in enumerate(order):
        k = live[o]
        jobs[pos, [P_COLS, P_N, P_ITS, P_NITS, P_M, P_OUT, P_BLOCK0]] = (
            cols_list[k].data_ptr(), cols_list[k].shape[1], first_it[k],
            len(layouts[k].table), layouts[k].m, outs[k].data_ptr(), first[pos])
    buf, offs = _build.upload([jobs, ab, its], dev)
    its_ptr = buf.data_ptr() + offs[2]
    n_its = sum(len(lay.table) for lay in layouts)
    _build.launch("perm_cols", "ovt_perm_cols", dev, buf.data_ptr(), len(jobs), total,
                  its_ptr, its_ptr + 16 * n_its, its_ptr + 20 * n_its,
                  buf.data_ptr() + offs[1], n_ab, threads, stage_w)
    return outs


_U64 = 1 << 64


def _reduce_wide(x: int) -> int:
    """bb::reduce_wide on a python int: x R^-1 mod p, for x < 2^64 (the
    bound is asserted: a 64-bit sum that passed it would have wrapped)."""
    assert 0 <= x < _U64, "a delayed sum passed 2^64"
    h, lo = x >> 32, x & 0xFFFFFFFF
    return ((h % P) + lo * bb.RINV_MOD_P) % P


def _mul_delayed(a: list, b: list) -> list:
    """K9's mul_d on python ints: each coefficient's products summed
    unreduced (at most 4 terms), c4..c6 reduced before the fold by W."""
    c = [sum(a[i] * b[k - i] for i in range(4) if 0 <= k - i < 4) for k in range(7)]
    w = ef.W_MONTY
    return [_reduce_wide(c[0] + _reduce_wide(c[4]) * w),
            _reduce_wide(c[1] + _reduce_wide(c[5]) * w),
            _reduce_wide(c[2] + _reduce_wide(c[6]) * w), _reduce_wide(c[3])]


def _denominator_delayed(alpha: list, bus: int, bpows: list, fields: list) -> list:
    """K9's denominator on python ints: alpha + bus, then the fields'
    products by beta's powers summed 4 fields at a time and reduced."""
    d = list(alpha)
    d[0] = (d[0] + bus) % P
    for f0 in range(0, len(fields), 4):
        for k in range(4):
            w = sum(bpows[f][k] * fields[f] for f in range(f0, min(len(fields), f0 + 4)))
            d[k] = (d[k] + _reduce_wide(w)) % P
    return d


def _inv_int(a: list) -> list:
    """The extension inverse of python-int Montgomery words; 0 maps to 0."""
    return ef.inv64(torch.tensor(a, dtype=torch.int64)).tolist()


def _batch_inv_model(d: torch.Tensor) -> torch.Tensor:
    """K9's inverses of a row's denominators, modelled on the CPU: per
    batch of PERM_BATCH interactions, running products (a zero denominator
    enters as 1), one inverse of the batch's product, then the backward
    pass of two delayed products an element; a zero's inverse stays 0.
    d: (I, N, 4) int64 Montgomery words; returns (I, N, 4)."""
    n_its, n = d.shape[0], d.shape[1]
    out = torch.zeros_like(d)
    one = [bb.R_MOD_P, 0, 0, 0]
    for j in range(n):
        row = d[:, j].tolist()
        for g0 in range(0, n_its, PERM_BATCH):
            g1 = min(n_its, g0 + PERM_BATCH)
            pre, acc = [], one
            for i in range(g0, g1):
                if any(row[i]):
                    acc = _mul_delayed(acc, row[i])
                pre.append(acc)
            inv = _inv_int(acc)
            for i in range(g1 - 1, g0 - 1, -1):
                if not any(row[i]):
                    continue
                out[i, j] = torch.tensor(_mul_delayed(inv, pre[i - 1 - g0] if i > g0 else one))
                inv = _mul_delayed(inv, row[i])
    return out


def _perm_model(cols_list: list, layouts: list, alpha, beta_pows) -> list:
    """K9's launch modelled on the CPU over the same plan (``perm_shape``,
    ``quotient.block_plan``): per block its AIR and rows, per row the
    delayed denominators, the batch inversion (``_batch_inv_model``; the
    kernel's slots past an AIR's interactions are zero denominators, which
    change nothing) and the signed chunk sums in the block's staged rows,
    then the block's flat store of 4m words a row into a (N, 4m + 4)
    buffer.  Returns each AIR's first 4m columns, as ``perm_cols_plain``
    does."""
    a = _words_np(alpha).astype(int).tolist()
    bp = _words_np(beta_pows).reshape(-1, 4).astype(int).tolist()
    live = [k for k, (c, lay) in enumerate(zip(cols_list, layouts))
            if c.shape[1] and len(lay.table)]
    outs = [torch.zeros((int(c.shape[1]), 4 * lay.m + 4), dtype=torch.int64)
            for c, lay in zip(cols_list, layouts)]
    if live:
        threads, stage_w, _, _ = perm_shape(
            max(layouts[k].m for k in live), max(layouts[k].f_max for k in live))
        order, first, total = qmod.block_plan([int(cols_list[k].shape[1]) for k in live],
                                              threads)
        for blk in range(total):
            pos, rows = qmod.block_rows(first, [int(cols_list[live[o]].shape[1])
                                                for o in order], blk, threads)
            k = live[order[pos]]
            c, lay = cols_list[k].long(), layouts[k]
            table = lay.table.tolist()
            stage = torch.zeros((threads, stage_w, 4), dtype=torch.int64)
            for t, j in enumerate(rows):
                d = torch.tensor([_denominator_delayed(
                    a, int(lay.bus_m[i]), bp, c[lay.rows[e:e + nf], j].tolist())
                    for i, (e, nf, _, _) in enumerate(table)])
                inv = _batch_inv_model(d[:, None, :])[:, 0]
                for i, (e, nf, chunk, is_send) in enumerate(table):
                    v = bb.mul64(inv[i], int(c[lay.rows[e + nf], j]))
                    stage[t, chunk] = (bb.add64 if is_send else bb.sub64)(stage[t, chunk], v)
            row0 = rows[0] if rows else 0
            flat = outs[k].reshape(-1, 4)
            for q in range(len(rows) * lay.m):
                r, ch = divmod(q, lay.m)
                flat[(row0 + r) * (lay.m + 1) + ch] = stage[r, ch]
    return [o[:, :4 * lay.m].int() for o, lay in zip(outs, layouts)]


def perm_cols(cols: torch.Tensor, layout: InteractionLayout,
              alpha, beta_pows) -> torch.Tensor:
    """``perm_cols_many`` of one AIR: kernel K9 on CUDA tensors,
    ``perm_cols_plain`` on CPU tensors."""
    return perm_cols_many([cols], [layout], alpha, beta_pows)[0]


def perm_scan_plain(perm: torch.Tensor) -> tuple:
    """((N, 4m + 4) matrix [perm | phi], (4,) cumulative sum), plain
    PyTorch (logup.py:328-336): phi is the inclusive prefix sum of the
    rows' chunk sums."""
    n = perm.shape[0]
    m = perm.shape[1] // 4
    row_sum = perm.long().reshape(n, m, 4).sum(dim=1) % P
    phi = torch.cumsum(row_sum, dim=0) % P
    return torch.cat([perm, phi.int()], dim=1), phi[-1].int()


# Rows a block of K10 scans (csrc/logup.cu SCAN_TILE) and the predecessors
# its look-back reads at once (a warp).
SCAN_TILE = 256
LOOKBACK = 32


def _scan_model(perm: torch.Tensor, tile: int = SCAN_TILE, window: int = LOOKBACK,
                seed: int = 0) -> tuple:
    """K10's arithmetic, modelled on the CPU: tiles of ``tile`` rows taken
    in order, each its rows' sums and their inclusive scan, and its carry by
    the look-back over ``window`` predecessors at a time, adding aggregates
    until an inclusive prefix.  Which predecessors have published their
    prefix yet is drawn at random (tile 0 always has), as the blocks'
    timing would make it.  Returns what ``perm_scan_plain`` returns."""
    rng = np.random.default_rng(seed)
    n, w = perm.shape
    m = w // 4
    sums = perm.long().reshape(n, m, 4).sum(dim=1) % P
    aggregate, prefix, phi = [], [], []
    for t in range(-(-n // tile)):
        incl = torch.cumsum(sums[t * tile:(t + 1) * tile], dim=0) % P
        aggregate.append(incl[-1])
        carry = torch.zeros(4, dtype=torch.int64)
        base = t - 1
        while base >= 0:
            lanes = list(range(base, max(base - window, -1), -1))
            published = [p == 0 or bool(rng.integers(0, 2)) for p in lanes]
            for p, has_prefix in zip(lanes, published):
                carry = (carry + (prefix[p] if has_prefix else aggregate[p])) % P
                if has_prefix:
                    break
            if any(published):
                break
            base -= window
        prefix.append((carry + incl[-1]) % P)
        phi.append((carry + incl) % P)
    phi = torch.cat(phi)
    return torch.cat([perm, phi.int()], dim=1), phi[-1].int()


def perm_scan(perm: torch.Tensor) -> tuple:
    """Kernel K10 (csrc/logup.cu) on CUDA tensors, ``perm_scan_plain`` on
    CPU tensors.  On CUDA, perm is K9's ``perm_buffer`` view, and phi is
    written into the 4 columns beside it in place: one launch reads the 4m
    words of each row and writes 4.  Returns ((N, 4m + 4) trace, (4,)
    cumulative sum)."""
    dev = _build.kernel_device(perm)
    if dev.type == "cpu":
        return perm_scan_plain(perm)
    trace = _trace_of(perm)
    n, m = int(perm.shape[0]), int(perm.shape[1]) // 4
    status = torch.zeros(16 * (1 + -(-n // SCAN_TILE)), dtype=torch.int32, device=dev)
    cumsum = torch.empty(4, dtype=torch.int32, device=dev)
    _build.launch("perm_scan", "ovt_perm_scan", dev, trace.data_ptr(), n, m,
                  status.data_ptr(), cumsum.data_ptr())
    return trace, cumsum


@dataclass
class PermPlan:
    """What the LogUp phase of one set of AIRs needs that is the same in
    every prove: each AIR's interaction layout and its columns program
    before ``qmod.bind`` (``quotient.compile_columns_code``)."""

    layouts: list
    codes: list


def perm_plan(dags: list, chunks: list, n_mains: list, has_preps: list) -> PermPlan:
    """The ``PermPlan`` of AIRs with these DAGs, interaction chunks, main
    parts and preprocessed traces."""
    layouts = [interaction_layout(d, c) for d, c in zip(dags, chunks)]
    codes = [qmod.compile_columns_code(d, lay.roots, n_main=nm, has_preprocessed=hp)
             for d, lay, nm, hp in zip(dags, layouts, n_mains, has_preps)]
    return PermPlan(layouts=layouts, codes=codes)


def build_perm_traces(plan: PermPlan, mains: list, preps: list, publics: list,
                      challenges, record: list | None = None) -> list:
    """The permutation traces of the plan's AIRs over their natural trace
    domains (logup.py:266): each AIR's fields and counts by its columns
    program (K7, a launch an AIR), every AIR's chunk columns in one K9
    launch, then each AIR's phi (K10).  ``mains``: per AIR its main parts
    (natural (N, W) Montgomery matrices, cached parts first), ``preps``
    its preprocessed trace or None, ``publics`` its Montgomery public
    words; ``challenges`` canonical (alpha, beta).  The fields see the
    whole trace, so their next rows wrap at N.  Returns per AIR ((N, 4(m +
    1)) Montgomery matrix, (4,) Montgomery cumulative sum).  When
    ``record`` is a list, each AIR's kernel inputs are appended to it."""
    if not plan.layouts:
        return []
    progs, srcs, cols = [], [], []
    for code, ms, prep, pub in zip(plan.codes, mains, preps, publics):
        sources = list(ms) + ([prep] if prep is not None else [])
        log_n = int(sources[0].shape[0]).bit_length() - 1
        progs.append(qmod.bind(code, publics=pub))
        srcs.append((sources, log_n))
        cols.append(qmod.evaluate_columns(progs[-1], sources, log_n))
    alpha = bb.to_monty_np(np.asarray(challenges[0], dtype=np.uint64) % P)
    bpows = beta_powers(challenges[1], max(lay.f_max for lay in plan.layouts))
    perms = perm_cols_many(cols, plan.layouts, alpha, bpows)
    if record is not None:
        dev = cols[0].device
        alpha_t, bpows_t = bb.from_numpy(alpha, device=dev), bb.from_numpy(bpows, device=dev)
        record.extend({"columns": (prog, sources, log_n),
                       "perm_cols": (c, lay, alpha_t, bpows_t), "perm_scan": perm}
                      for prog, (sources, log_n), c, lay, perm
                      in zip(progs, srcs, cols, plan.layouts, perms))
    del cols
    return [perm_scan(perm) for perm in perms]


def build_perm_trace(dag, chunks: list, mains: list, prep, publics,
                     challenges, record: list | None = None) -> tuple:
    """``build_perm_traces`` of one AIR (logup.py:266): ((N, 4(m + 1))
    Montgomery matrix, (4,) Montgomery cumulative sum)."""
    plan = perm_plan([dag], [chunks], [len(mains)], [prep is not None])
    return build_perm_traces(plan, [mains], [prep], [publics], challenges, record)[0]
