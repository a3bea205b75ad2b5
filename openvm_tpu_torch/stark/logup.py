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
  * ``perm_cols`` (kernel K9, csrc/logup.cu) turns them into the chunk
    columns sum sign * count / denominator, written straight into the
    first 4m columns of the (N, 4m + 4) permutation trace;
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

    roots: for each interaction in order, its field roots then its count
    root; table: (I, 4) int32 [first output row, number of fields, chunk,
    is_send]; bus_m: (I,) Montgomery words of the bus ids; m: chunks;
    f_max: the most fields of one interaction."""

    roots: list
    table: np.ndarray
    bus_m: np.ndarray
    m: int
    f_max: int


def interaction_layout(dag, chunks: list) -> InteractionLayout:
    chunk_of = {i: j for j, chunk in enumerate(chunks) for i in chunk}
    roots, rows = [], []
    for i, (_, frs, cr, is_send) in enumerate(dag.interactions):
        rows.append((len(roots), len(frs), chunk_of[i], int(is_send)))
        roots.extend(list(frs) + [cr])
    table = np.asarray(rows, dtype=np.int32).reshape(-1, 4)
    if np.any(np.diff(table[:, 2]) < 0):
        raise ValueError("interaction chunks must be contiguous and ascending")
    bus_m = np.asarray([bb.to_monty_int(bus % P) for (bus, _, _, _)
                        in dag.interactions], dtype=np.uint32)
    return InteractionLayout(
        roots=roots, table=table, bus_m=bus_m, m=len(chunks),
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
    for i, (first, nf, _, is_send) in enumerate(layout.table.tolist()):
        fields[i, :nf] = c[first:first + nf]
        sc[i] = c[first + nf] if is_send else bb.sub64(torch.zeros_like(c[0]),
                                                       c[first + nf])
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


def perm_cols(cols: torch.Tensor, layout: InteractionLayout,
              alpha: torch.Tensor, beta_pows: torch.Tensor) -> torch.Tensor:
    """Kernel K9 (csrc/logup.cu) on CUDA tensors, ``perm_cols_plain`` on
    CPU tensors.  cols: (R, N) int32 Montgomery output of the AIR's columns
    program; alpha (4,), beta_pows (F, 4) Montgomery words.  On CUDA the
    result is the ``perm_buffer`` view: the first 4m columns of the
    permutation trace."""
    dev = _build.kernel_device(cols, alpha, beta_pows)
    if dev.type == "cpu":
        return perm_cols_plain(cols, layout, alpha, beta_pows)
    for name, t in (("cols", cols), ("alpha", alpha), ("beta_pows", beta_pows)):
        _build.check_words(t, name, dev)
    n = int(cols.shape[1])
    if cols.shape[0] != len(layout.roots):
        raise ValueError(f"cols has {cols.shape[0]} rows, the layout "
                         f"{len(layout.roots)}")
    table = torch.from_numpy(layout.table).to(dev)
    bus_m = torch.from_numpy(layout.bus_m.view(np.int32)).to(dev)
    out = perm_buffer(n, layout.m, dev)
    _build.launch("perm_cols", "ovt_perm_cols", dev, cols.data_ptr(), n,
                  table.data_ptr(), int(table.shape[0]), bus_m.data_ptr(),
                  beta_pows.data_ptr(), alpha.data_ptr(), layout.m,
                  out.data_ptr())
    return out


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


def build_perm_trace(dag, chunks: list, mains: list, prep, publics,
                     challenges, record: list | None = None) -> tuple:
    """The permutation trace of one AIR over its natural trace domain
    (logup.py:266).  ``mains``: its main parts (natural (N, W) Montgomery
    matrices, cached parts first), ``prep`` its preprocessed trace or None,
    ``publics`` Montgomery words, ``challenges`` canonical (alpha, beta).
    The fields see the whole trace, so their next rows wrap at N.  Returns
    ((N, 4(m + 1)) Montgomery matrix, (4,) Montgomery cumulative sum).  When
    ``record`` is a list, the three kernels' inputs are appended to it."""
    layout = interaction_layout(dag, chunks)
    sources = list(mains) + ([prep] if prep is not None else [])
    dev = sources[0].device
    n = int(sources[0].shape[0])
    prog = qmod.compile_columns(dag, layout.roots, n_main=len(mains),
                                has_preprocessed=prep is not None,
                                publics=publics)
    cols = qmod.evaluate_columns(prog, sources, n.bit_length() - 1)
    alpha = ef.from_canonical(challenges[0], device=dev)
    bpows = bb.from_numpy(beta_powers(challenges[1], layout.f_max), device=dev)
    perm = perm_cols(cols, layout, alpha, bpows)
    if record is not None:
        record.append({"columns": (prog, sources, n.bit_length() - 1),
                       "perm_cols": (cols, layout, alpha, bpows),
                       "perm_scan": perm})
    return perm_scan(perm)
