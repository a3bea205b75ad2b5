"""Multi-trace STARK prover on the card.

Port of openvm_tpu/stark/prover.py: the same transcript and the same proof,
so ``codec.encode_proof`` gives equal bytes for equal inputs.  Host code
(this file) orchestrates; every row-parallel step runs a kernel of
``openvm_tpu_torch/csrc`` on CUDA tensors:

  main, perm, quotient LDEs  ntt.batched_coset_ldes / coset_lde (K3)
  Merkle commits             merkle.commit (K4, K5)
  interaction fields         stark.quotient.evaluate_columns (K7, columns)
  LogUp permutation trace    stark.logup.perm_cols_many, perm_scan (K9, K10)
  quotient                   stark.quotient.evaluate_many (K7+K11)
  zeta power series          field.ext.powers_host (K2)
  out-of-domain openings     open_many (K12)
  reduced openings           reduced_open_many (K13)
  FRI folds                  fri.fold_evals (K14)
  query gathers              merkle.GatherPlan (K6)

The LogUp phase (prover.py:455-514) and the after-challenge round of the
openings (:708-713) are ported with them.  The JAX package's XLA
workarounds are not ported: the constraint-root grouping, the executable
cache, the compile pool, the trace sharding and its statistics
(prover.py:28, :99-141, :307-339, :415-417).
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _build, fri, merkle, ntt
from .._device import resolve_device
from ..challenger import DuplexChallenger
from ..field import babybear as bb
from ..field import ext as ef
from . import logup
from . import npext as nx
from . import quotient as qmod
from .config import MAX_TWO_ADICITY
from .keygen import MultiStarkProvingKey

P = bb.P


# ---------------------------------------------------------------------------
# Proof objects
# ---------------------------------------------------------------------------


@dataclass
class AdjacentOpenedValues:
    local: list  # list of ext 4-tuples (canonical)
    next: list


@dataclass
class OpeningValues:
    preprocessed: list  # [AdjacentOpenedValues] per air-with-prep
    main: list  # per main commit: [per mat: AdjacentOpenedValues]
    after_challenge: list  # per phase: [per mat: AdjacentOpenedValues]
    quotient: list  # per air: [per chunk: [4 ext 4-tuples]]


@dataclass
class Commitments:
    main_trace: list  # [(8,) canonical digests]
    after_challenge: list
    quotient: np.ndarray


@dataclass
class AirProofData:
    air_id: int
    log_degree: int
    exposed_values_after_challenge: list  # per phase: [ext 4-tuple]
    public_values: list  # canonical ints


@dataclass
class Opening:
    proof: fri.FriProof
    values: OpeningValues


@dataclass
class Proof:
    commitments: Commitments
    opening: Opening
    per_air: list  # [AirProofData]
    air_perm_by_height: list
    log_up_pow_witness: int


@dataclass
class AirProvingContext:
    """Inputs for one AIR instance (heights must be powers of two): canonical
    numpy (N, W) matrices, or int32 Montgomery tensors already on the
    prover's device."""

    air_id: int
    common_main: object = None
    cached_mains: list = field(default_factory=list)
    public_values: list = field(default_factory=list)


# ---------------------------------------------------------------------------
# Host tables and the device helpers of the openings
# ---------------------------------------------------------------------------


# The plain K12 and K13 take this many columns of a matrix at a time, so
# that their (N, columns, 4) int64 products stay a few GB on a matrix of
# keccakf's 2,633 columns at 2^20 rows.
PLAIN_COLUMNS = 64


def _col_comb(matrix: torch.Tensor, alpha_pows: torch.Tensor) -> torch.Tensor:
    """sum_t alpha^t * M[:, t] -> (N, 4) ext Montgomery, plain PyTorch
    (prover.py:194), PLAIN_COLUMNS columns at a time; K13 computes it
    inside its pass."""
    w = matrix.shape[1]
    acc = torch.zeros((matrix.shape[0], 4), dtype=torch.int64, device=matrix.device)
    for c in range(0, w, PLAIN_COLUMNS):
        part = matrix[:, c:c + PLAIN_COLUMNS].long()
        prod = bb.mul64(part[:, :, None], alpha_pows[c:c + part.shape[1]].long()[None])
        acc = (acc + prod.sum(dim=1)) % P
    return acc.int()


def _open_dot_plain(coeffs: torch.Tensor, zpows: torch.Tensor,
                    geos: torch.Tensor) -> torch.Tensor:
    """out[p, t] = sum_i coeffs[i, t] * zpows[i] * geos[p, i], plain
    PyTorch; (Pts, W, 4) Montgomery words."""
    n = coeffs.shape[0]
    out = []
    for p in range(geos.shape[0]):
        u = ef.scale64(zpows[:n].long(), geos[p, :n].long())  # (N, 4)
        parts = []
        for k in range(0, coeffs.shape[1], PLAIN_COLUMNS):
            c = coeffs[:, k:k + PLAIN_COLUMNS].long()
            prod = bb.mul64(c[:, :, None], u[:, None, :])  # (N, columns, 4)
            parts.append(prod.sum(dim=0) % P)
        out.append(torch.cat(parts) if parts else
                   torch.zeros((0, 4), dtype=torch.int64, device=coeffs.device))
    return torch.stack(out).int()


def geo_powers(mult: int, n: int, device) -> torch.Tensor:
    """(n,) int64 Montgomery words mult^0 .. mult^(n-1) of a canonical base
    ``mult`` on ``device``, by doubling (prover.py:260-269's series)."""
    x = torch.full((1,), bb.R_MOD_P, dtype=torch.int64, device=device)
    step = torch.tensor(bb.to_monty_int(mult % P), dtype=torch.int64, device=device)
    while x.shape[0] < n:
        x = torch.cat([x, bb.mul64(x, step)])
        step = bb.mul64(step, step)
    return x[:n]


def open_many_plain(jobs: list, zpows: torch.Tensor) -> list:
    """``open_many``'s plain version: each job's ``_open_dot_plain`` with its
    geometric series built on the device."""
    return [_open_dot_plain(c, zpows, torch.stack(
        [geo_powers(m, int(c.shape[0]), c.device) for m in mults]))
            for c, mults in jobs]


# The openings kernel's job table (csrc/open.cu): OPEN_JOB_WORDS int64 a
# matrix.  A block scans tiles of OPEN_TILE rows (one weight row a thread);
# a job takes at most OPEN_MAX_BLOCKS blocks.
(O_PTR, O_STRIDE, O_W, O_N, O_NPTS, O_MULT0, O_MULT1, O_OUT, O_PART, O_BLOCK0,
 O_NBLK, O_RPB) = range(12)
OPEN_JOB_WORDS = 12
OPEN_TILE = 256
OPEN_MAX_BLOCKS = 1024


def open_plan(shapes: list, tile: int = OPEN_TILE,
              max_blocks: int = OPEN_MAX_BLOCKS) -> tuple:
    """The openings kernel's map of blocks to jobs for jobs of ``shapes``
    (N, W, points): (order, rows a block, blocks, first block, total).  Jobs
    run largest first (N W, ties in input order); job order[k] takes
    blocks[k] blocks of rows[k] rows (whole tiles) from first[k] on."""
    order = sorted(range(len(shapes)), key=lambda k: -shapes[k][0] * shapes[k][1])
    rows, blocks, first, total = [], [], [], 0
    for k in order:
        tiles = -(-shapes[k][0] // tile)
        rpb = -(-tiles // min(tiles, max_blocks)) * tile
        rows.append(rpb)
        blocks.append(-(-shapes[k][0] // rpb))
        first.append(total)
        total += blocks[-1]
    return order, rows, blocks, first, total


def _open_table(jobs: list, ptrs: list, tile: int = OPEN_TILE,
                max_blocks: int = OPEN_MAX_BLOCKS) -> tuple:
    """The openings kernel's job table over the jobs with rows and columns,
    in ``open_plan`` order: (table (J, OPEN_JOB_WORDS) int64, output word
    offset by job index, output words, partial words, blocks).  ``ptrs``:
    each job's coefficient address."""
    shapes = [(int(c.shape[0]), int(c.shape[1]), len(m)) for c, m in jobs]
    live = [k for k, (n, w, _) in enumerate(shapes) if n and w]
    order, rows, blocks, first, total = open_plan([shapes[k] for k in live], tile,
                                                  max_blocks)
    table = np.zeros((len(live), OPEN_JOB_WORDS), dtype=np.int64)
    out_off, n_out, n_part = {}, 0, 0
    for pos, o in enumerate(order):
        k = live[o]
        (c, mults), (n, w, npts), j = jobs[k], shapes[k], table[pos]
        j[O_PTR], j[O_STRIDE], j[O_W], j[O_N], j[O_NPTS] = ptrs[k], c.stride(0), w, n, npts
        j[O_MULT0] = bb.to_monty_int(mults[0] % P)
        j[O_MULT1] = bb.to_monty_int(mults[-1] % P)
        j[O_OUT], j[O_PART], j[O_BLOCK0] = n_out, n_part, first[pos]
        j[O_NBLK], j[O_RPB] = blocks[pos], rows[pos]
        out_off[k] = n_out
        n_out += npts * w * 4
        n_part += blocks[pos] * npts * w * 4
    return table, out_off, n_out, n_part, total


def _open_outputs(out: torch.Tensor, jobs: list, out_off: dict) -> list:
    """Each job's (points, W, 4) view of the flat output, zeros for a job
    without rows or columns."""
    res = []
    for k, (c, mults) in enumerate(jobs):
        w, npts = int(c.shape[1]), len(mults)
        res.append(out[out_off[k]:out_off[k] + npts * w * 4].view(npts, w, 4)
                   if k in out_off else
                   torch.zeros((npts, w, 4), dtype=torch.int32, device=out.device))
    return res


def _open_model(jobs: list, zpows: torch.Tensor, threads: int = OPEN_TILE,
                max_blocks: int = OPEN_MAX_BLOCKS) -> list:
    """csrc/open.cu's two launches, modelled on the CPU over the same job
    table (``_open_table``, a job's index for its address): per block its
    job by the first blocks, its rows, the weights' powers from the block's
    first row by exponentiation and a step a tile; per column group the
    threads' (row, column) cover of each tile and their sums; the partials
    at (block, point, column) of the job's partial offset, and each output
    word's sum over the job's blocks."""
    table, out_off, n_out, n_part, total = _open_table(
        jobs, list(range(len(jobs))), threads, max_blocks)
    z = zpows.long()
    partial = torch.zeros(n_part, dtype=torch.int64)
    for blk in range(total):
        j = table[max(i for i in range(len(table)) if table[i, O_BLOCK0] <= blk)]
        c = jobs[int(j[O_PTR])][0]
        n, w, npts = int(j[O_N]), int(j[O_W]), int(j[O_NPTS])
        mults = [int(j[O_MULT0]), int(j[O_MULT1])][:npts]  # Montgomery words
        b = blk - int(j[O_BLOCK0])
        r0 = b * int(j[O_RPB])
        r1 = min(n, r0 + int(j[O_RPB]))
        cw = min(w, threads)
        rstep = threads // cw
        first = [torch.tensor([bb.to_monty_int(pow(bb.from_monty_int(m), r0 + t, P))
                               for t in range(threads)]) for m in mults]
        step = [bb.to_monty_int(pow(bb.from_monty_int(m), threads, P)) for m in mults]
        for g0 in range(0, w, cw):
            cols = [g0 + ci for ci in range(cw) if g0 + ci < w]
            acc = torch.zeros((rstep, len(cols), npts, 4), dtype=torch.int64)
            pw = list(first)
            for t0 in range(r0, r1, threads):
                nr = min(threads, r1 - t0)
                u = [ef.scale64(z[t0:t0 + nr], pw[p][:nr]) for p in range(npts)]
                pw = [bb.mul64(x, s) for x, s in zip(pw, step)]
                for ri in range(min(rstep, nr)):  # thread (ri, ci): rows ri + j rstep
                    rs = torch.arange(ri, nr, rstep)
                    v = c[t0 + rs][:, cols].long()  # (rows, cols)
                    for p in range(npts):
                        term = bb.mul64(v[:, :, None], u[p][rs][:, None, :])
                        acc[ri, :, p] = (acc[ri, :, p] + term.sum(dim=0)) % P
            sums = acc.sum(dim=0) % P  # (cols, points, 4): the tree over a column's threads
            for ci, col in enumerate(cols):
                for p in range(npts):
                    at = int(j[O_PART]) + ((b * npts + p) * w + col) * 4
                    partial[at:at + 4] = sums[ci, p]
    out = torch.zeros(n_out, dtype=torch.int64)
    for j in table:
        words = int(j[O_NPTS] * j[O_W] * 4)
        part = partial[int(j[O_PART]):int(j[O_PART]) + int(j[O_NBLK]) * words]
        out[int(j[O_OUT]):int(j[O_OUT]) + words] = part.view(-1, words).sum(dim=0) % P
    return _open_outputs(out.int(), jobs, out_off)


def open_many(jobs: list, zpows: torch.Tensor) -> list:
    """Kernel K12 (csrc/open.cu) on CUDA tensors, ``open_many_plain`` on CPU
    tensors (prover.py:231-257 and :747-751 for every matrix of the
    openings stage).  jobs: [(coeffs (N, W) int32 Montgomery words with unit
    column stride, any row stride; its one or two canonical base
    multipliers m_p)]; zpows (>= every N, 4) ext Montgomery words.  Returns
    per job (points, W, 4) int32: sum_i coeffs[i, t] zpows[i] m_p^i.

    Two launches for all jobs: per-block partial sums through one job
    table (``_open_table``) sent in one non-blocking copy, then their sum."""
    if not jobs:
        return []
    dev = _build.kernel_device(zpows, *(c for c, _ in jobs))
    if dev.type == "cpu":
        return open_many_plain(jobs, zpows)
    _build.check_words(zpows, "zpows", dev)
    for c, mults in jobs:
        if (c.dtype != torch.int32 or (c.shape[1] > 1 and c.stride(1) != 1)
                or not 1 <= len(mults) <= 2 or zpows.shape[0] < c.shape[0]):
            raise ValueError("open_many takes int32 coeffs with unit column "
                             "stride, one or two points and zpows of every height")
    table, out_off, n_out, n_part, total = _open_table(jobs, [c.data_ptr() for c, _ in jobs])
    out = torch.empty(n_out, dtype=torch.int32, device=dev)
    if len(table):
        dev_table = _build.upload([table], dev)[0]
        partial = torch.empty(n_part, dtype=torch.int32, device=dev)
        _build.launch("open_dot", "ovt_open_partial", dev, dev_table.data_ptr(),
                      len(table), total, zpows.data_ptr(), partial.data_ptr())
        _build.launch("open_dot", "ovt_open_reduce", dev, dev_table.data_ptr(),
                      len(table), partial.data_ptr(), n_out, out.data_ptr())
    # the table must outlive the launches: the caching allocator holds a
    # freed block for the stream's later work, and the kernels run first
    return _open_outputs(out, jobs, out_off)


def ext_powers_np(alpha, n: int) -> np.ndarray:
    """(n, 4) canonical uint64 alpha^0 .. alpha^(n-1) of a canonical
    extension element, by doubling."""
    out = np.zeros((max(n, 1), 4), dtype=np.uint64)
    out[0, 0] = 1
    step, filled = np.asarray(alpha, dtype=np.uint64), 1
    while filled < n:
        k = min(filled, n - filled)
        out[filled:filled + k] = nx.nmul(out[:k], step)
        step, filled = nx.nmul(step, step), filled + k
    return out[:n]


def _monty_ext(v, device) -> torch.Tensor:
    """A canonical extension element as (4,) int64 Montgomery words."""
    return torch.from_numpy(bb.to_monty_np(np.asarray(v, dtype=np.uint64))
                            .astype(np.int64)).to(device)


def reduced_open_jobs(mats: list, alpha) -> list:
    """``reduced_open_many``'s jobs for committed matrices in the
    transcript's order (prover.py:773-792): mats [(LDE (H, W), canonical
    points z, opened values (W, 4) canonical a point)].  Per (matrix,
    point): alpha_pow, alpha^w advanced over the earlier pairs of its LDE
    height, and p(z)_comb = sum_t alpha^t opened[t]; all pairs at once."""
    pair_w, exps, seen = [], [], {}
    for lde, points, _ in mats:
        h, w = (int(v) for v in lde.shape)
        for _ in points:
            pair_w.append(w)
            exps.append(seen.get(h, 0))
            seen[h] = exps[-1] + w
    apows = ext_powers_np(alpha, max(exps + pair_w + [0]) + 1)
    terms = nx.nmul(np.concatenate([o for _, _, opened in mats for o in opened]),
                    apows[np.concatenate([np.arange(w) for w in pair_w])])
    pz = np.zeros((len(pair_w), 4), dtype=np.uint64)
    np.add.at(pz, np.repeat(np.arange(len(pair_w)), pair_w), terms)
    pz %= P
    jobs, q = [], 0
    for lde, points, _ in mats:
        jobs.append((lde, [(z, pz[q + k], apows[exps[q + k]])
                           for k, z in enumerate(points)]))
        q += len(points)
    return jobs


def reduced_open_many_plain(jobs: list, alpha) -> dict:
    """``reduced_open_many``'s plain version, matrix by matrix as the
    reference adds them (prover.py:773-792): per matrix its column
    combination, then per point alpha_pow (p(z) - comb) / (z - x) added
    into its height's ro, 1/(z - x) over ``ntt.lde_points``."""
    dev = jobs[0][0].device
    w_max = max(int(m.shape[1]) for m, _ in jobs)
    apows = torch.from_numpy(bb.to_monty_np(ext_powers_np(alpha, w_max))
                             .astype(np.int64)).to(dev)
    ro: dict = {}
    for mat, points in jobs:
        h = int(mat.shape[0])
        lh = h.bit_length() - 1
        acc = ro[lh] if lh in ro else torch.zeros((h, 4), dtype=torch.int64, device=dev)
        comb = _col_comb(mat, apows).long()
        for z, pz, ap in points:
            num = bb.sub64(_monty_ext(pz, dev), comb)
            inv = _inv_z_minus_x(tuple(int(v) for v in z), lh, dev)
            acc = bb.add64(acc, ef.mul64(_monty_ext(ap, dev), ef.mul64(num, inv)))
        ro[lh] = acc
    return {lh: v.int() for lh, v in ro.items()}


@functools.lru_cache(maxsize=16)
def _inv_z_minus_x(z: tuple, log_h: int, device) -> torch.Tensor:
    """1 / (z - x) over the bit-reversed LDE points of height 2^log_h, for
    a canonical z, int64 (H, 4); every matrix of that height opened at z
    shares it."""
    xs = ntt.lde_points(log_h, device).long()
    zmx = _monty_ext(z, device).expand(1 << log_h, 4).clone()
    zmx[:, 0] = bb.sub64(zmx[:, 0], xs)
    return ef.inv64(zmx)


# The reduced-openings kernel's job table (csrc/fri.cu): RH_WORDS int64 a
# height, RM_WORDS a matrix.  A block takes RO_TILE rows of one height,
# RO_ROWS a thread; a height has at most RO_MAX_PTS distinct points.
RH_LOG, RH_NMAT, RH_MAT0, RH_NPTS, RH_PT0, RH_OUT, RH_BLOCK0 = range(7)
RH_WORDS = 8
RM_PTR, RM_STRIDE, RM_W, RM_VEC, RM_MASK, RM_ALPHA = range(6)
RM_WORDS = 6
RO_THREADS, RO_ROWS, RO_COLS, RO_MAX_PTS = 128, 2, 32, 4
RO_TILE = RO_THREADS * RO_ROWS
RO_PT_WORDS = 5  # a point's uint4s: f's coefficients, q0, q1, q2, C


def _point_polys(zs) -> np.ndarray:
    """(n, 4, 4) canonical uint64 [f, q0, q1, q2] of n extension points z:
    f(x) = x^4 + a3 x^3 + a2 x^2 + a1 x + a0 = prod_k (x - z^(p^k)), the
    norm of z - x as a polynomial in a base x (row f holds a0..a3, all in
    the base field), and q(x) = x^3 + q2 x^2 + q1 x + q0 = f(x) / (x - z),
    so 1/(z - x) = -q(x) / f(x) for every base x, f(x) = 0 exactly when
    x = z."""
    z = np.asarray(zs, dtype=np.uint64).reshape(-1, 4) % P
    poly = [nx.from_base(np.ones(len(z)))]  # coefficients of x^0, x^1, ...
    for scale in nx._frob_scales():
        prods = [nx.nmul(z * scale % P, c) for c in poly] + [0]
        poly = [nx.nsub(poly[i - 1] if i else 0, prods[i]) for i in range(len(poly) + 1)]
    if any(c[:, 1:].any() for c in poly):
        raise AssertionError("the norm polynomial is not in the base field")
    q = [nx.nadd(z, nx.from_base(poly[3][:, 0]))]  # q2, q1, q0
    for i in (2, 1):
        q.append(nx.nadd(nx.nmul(z, q[-1]), nx.from_base(poly[i][:, 0])))
    return np.stack([np.stack([c[:, 0] for c in poly[:4]], axis=1)] + q[::-1], axis=1)


def _ro_table(jobs: list, alpha, ptrs: list, tile: int = RO_TILE) -> tuple:
    """The reduced-openings kernel's tables over ``jobs`` (see
    ``reduced_open_many``; ``ptrs``: each matrix's address): (heights
    (n_h, RH_WORDS) int64, largest first, blocks by ``quotient.block_plan``;
    mats (n_m, RM_WORDS) int64, a height's consecutive; consts (n_c, 4)
    uint32 Montgomery: alpha^t for t < n_apow, per height RO_PT_WORDS rows
    a distinct point z_p (``_point_polys``' f, q0, q1, q2, then C_p = sum
    of its pairs' alpha_pow p(z)_comb), per matrix the sum of its
    alpha_pows at each point of its height (a matrix of a one-row trace is
    opened twice at zeta = zeta g_1); n_apow; blocks;
    ro's row offset by log height; rows in all)."""
    by_h: dict = {}
    for k, (mat, _) in enumerate(jobs):
        by_h.setdefault(int(mat.shape[0]).bit_length() - 1, []).append(k)
    logs = list(by_h)
    order, first, total = qmod.block_plan([1 << lh for lh in logs], tile)
    # every (matrix, point) pair, height by height in the table's order, and
    # each height's distinct points in the order they first appear
    pair_mat, pair_pt, zs = [], [], {}
    for o in order:
        seen = zs.setdefault(logs[o], {})
        for i, k in enumerate(by_h[logs[o]]):
            for z, _, _ in jobs[k][1]:
                pair_mat.append(i)
                pair_pt.append(seen.setdefault(tuple(int(v) for v in z), len(seen)))
        if len(seen) > RO_MAX_PTS:
            raise ValueError(f"height 2^{logs[o]} has {len(seen)} distinct points, "
                             f"more than {RO_MAX_PTS}")
    pair_mat, pair_pt = np.asarray(pair_mat), np.asarray(pair_pt)
    pairs = [(pz, ap) for o in order for k in by_h[logs[o]] for _, pz, ap in jobs[k][1]]
    aps = np.asarray([ap for _, ap in pairs], dtype=np.uint64).reshape(-1, 4)
    terms = nx.nmul(aps, np.asarray([pz for pz, _ in pairs], dtype=np.uint64).reshape(-1, 4))
    polys = _point_polys([z for o in order for z in zs[logs[o]]])
    n_apow = max(int(m.shape[1]) for m, _ in jobs)
    consts = [ext_powers_np(alpha, n_apow)]
    n_c = n_apow
    heights = np.zeros((len(logs), RH_WORDS), dtype=np.int64)
    mats = np.zeros((len(jobs), RM_WORDS), dtype=np.int64)
    out_off, n_out, m_pos, q0, z0 = {}, 0, 0, 0, 0
    for pos, o in enumerate(order):
        lh, ks = logs[o], by_h[logs[o]]
        npts = len(zs[lh])
        q1 = q0 + sum(len(jobs[k][1]) for k in ks)
        pidx, mat_of = pair_pt[q0:q1], pair_mat[q0:q1]
        pts = np.zeros((npts, RO_PT_WORDS, 4), dtype=np.uint64)
        pts[:, :4] = polys[z0:z0 + npts]
        np.add.at(pts[:, 4], pidx, terms[q0:q1])
        pts[:, 4] %= P
        alphas = np.zeros((len(ks), npts, 4), dtype=np.uint64)
        np.add.at(alphas, (mat_of, pidx), aps[q0:q1])
        alphas %= P
        heights[pos] = (lh, len(ks), m_pos, npts, n_c, n_out, first[pos], 0)
        consts.append(pts.reshape(-1, 4))
        n_c += RO_PT_WORDS * npts
        for i, k in enumerate(ks):
            mat = jobs[k][0]
            w, stride = int(mat.shape[1]), int(mat.stride(0))
            vec = w % 4 == 0 and stride % 4 == 0 and mat.data_ptr() % 16 == 0
            mask = sum(1 << int(p) for p in set(pidx[mat_of == i].tolist()))
            mats[m_pos] = (ptrs[k], stride, w, vec, mask, n_c)
            consts.append(alphas[i])
            n_c += npts
            m_pos += 1
        out_off[lh] = n_out
        n_out += 1 << lh
        q0, z0 = q1, z0 + npts
    return (heights, mats, bb.to_monty_np(np.concatenate(consts)), n_apow, total,
            out_off, n_out)


def _reduced_open_model(jobs: list, alpha, threads: int = RO_THREADS,
                        rows: int = RO_ROWS, cols: int = RO_COLS,
                        root_bits: int = ntt.ROOT_BITS) -> dict:
    """csrc/fri.cu's reduced_open_kernel modelled on the CPU over the same
    tables (``_ro_table``, a job's index for its address): per block its
    height by the first blocks and its tile of threads * rows rows; per
    matrix its tile staged ``cols`` columns at a time, 4 columns' products
    summed exactly, and the sums s_p += alpha_mp comb_m; x_r = g A(hi)
    B(lo) (``ntt.rev_root_points``); per thread (rows t, t + threads, ...)
    f_p(x) by Horner and one base batch inverse over its rows and points in
    the kernel's order, a zero f (z = x) entering as 1 and contributing 0;
    ro[r] = sum_p (s_p - C_p) q_p(x) / f_p(x) (``_point_polys``) written
    once a row."""
    tile = threads * rows
    if tile > 1 << root_bits:
        raise ValueError("a tile must lie inside one hi of the point split")
    heights, mats, consts, n_apow, total, out_off, n_out = _ro_table(
        jobs, alpha, list(range(len(jobs))), tile)
    c = torch.from_numpy(consts.astype(np.int64))
    out = torch.zeros((n_out, 4), dtype=torch.int64)
    one = torch.tensor([bb.R_MOD_P, 0, 0, 0], dtype=torch.int64)
    for blk in range(total):
        hj = heights[max(i for i in range(len(heights)) if heights[i, RH_BLOCK0] <= blk)]
        log_h, npts = int(hj[RH_LOG]), int(hj[RH_NPTS])
        r0 = (blk - int(hj[RH_BLOCK0])) * tile
        n_rows = min(tile, (1 << log_h) - r0)
        s = torch.zeros((npts, n_rows, 4), dtype=torch.int64)
        for mj in mats[int(hj[RH_MAT0]):int(hj[RH_MAT0] + hj[RH_NMAT])]:
            mat = jobs[int(mj[RM_PTR])][0]
            comb = torch.zeros((n_rows, 4), dtype=torch.int64)
            for c0 in range(0, int(mj[RM_W]), cols):
                staged = mat[r0:r0 + n_rows, c0:c0 + cols].long()
                for t0 in range(0, staged.shape[1], 4):
                    part = torch.zeros((n_rows, 4), dtype=torch.int64)
                    for t in range(t0, min(t0 + 4, staged.shape[1])):
                        part = bb.add64(part, bb.mul64(staged[:, t, None], c[c0 + t][None]))
                    comb = bb.add64(comb, part)
            for p in range(npts):
                if int(mj[RM_MASK]) >> p & 1:
                    s[p] = bb.add64(s[p], ef.mul64(c[int(mj[RM_ALPHA]) + p], comb))
        pts = c[int(hj[RH_PT0]):int(hj[RH_PT0]) + RO_PT_WORDS * npts].view(npts, RO_PT_WORDS, 4)
        x = torch.from_numpy(bb.to_monty_np(
            ntt.rev_root_points(log_h, np.arange(r0, r0 + n_rows), bits=root_bits)
            * bb.GENERATOR % P).astype(np.int64))
        res = torch.zeros((n_rows, 4), dtype=torch.int64)
        thr = torch.arange(threads)
        acc, pre, fs = torch.full((threads,), bb.R_MOD_P, dtype=torch.int64), [], []
        for k in range(rows):  # f(x) by Horner, then the base batch inverse
            r = thr + k * threads
            valid = r < n_rows
            xr = torch.where(valid, x[r.clamp(max=n_rows - 1)], 0)
            for p in range(npts):
                a = pts[p, 0]
                f = bb.add64(xr, a[3])
                for c_ in (a[2], a[1], a[0]):
                    f = bb.add64(bb.mul64(f, xr), c_)
                f = torch.where(valid, f, 0)
                acc = torch.where(f != 0, bb.mul64(acc, f), acc)
                pre.append(acc)
                fs.append((p, f, r, xr))
        inv = ef.bb_inv64(acc)
        for i in range(len(fs) - 1, -1, -1):
            p, f, r, xr = fs[i]
            inv_f = bb.mul64(inv, pre[i - 1]) if i else inv
            inv = torch.where(f != 0, bb.mul64(inv, f), inv)
            live = f != 0
            q = pts[p, 3].expand(threads, 4).clone()
            q[:, 0] = bb.add64(q[:, 0], xr)
            q = bb.add64(ef.scale64(q, xr), pts[p, 2])
            q = bb.add64(ef.scale64(q, xr), pts[p, 1])
            rl = r[live]
            num = bb.sub64(s[p][rl], pts[p, 4].expand(len(rl), 4))
            res[rl] = bb.add64(res[rl], ef.mul64(num, ef.scale64(q[live], inv_f[live])))
        out[out_off[log_h] + r0:out_off[log_h] + r0 + n_rows] = res
    return {lh: out[o:o + (1 << lh)].int() for lh, o in out_off.items()}


def reduced_open_many(jobs: list, alpha) -> dict:
    """Every reduced opening of a prove (prover.py:773-792): {log height:
    (2^log_h, 4) int32 ro}, ro[r] = sum over the height's matrices and
    their points of alpha_pow (p(z)_comb - comb[r]) / (z - x_r).  jobs:
    [(matrix (H, W) int32 Montgomery words, unit column stride, any row
    stride, bit-reversed LDE rows; [(z, p(z)_comb, alpha_pow)] canonical
    extension 4-sequences in the transcript's order)]; alpha: the canonical
    FRI alpha, whose powers weight the columns.

    Kernel K13 (csrc/fri.cu) on CUDA tensors: one launch over the tables of
    ``_ro_table``, sent in one non-blocking copy; ``reduced_open_many_plain``
    on CPU tensors."""
    if not jobs:
        return {}
    dev = _build.kernel_device(*(m for m, _ in jobs))
    if dev.type == "cpu":
        return reduced_open_many_plain(jobs, alpha)
    for m, _ in jobs:
        h = int(m.shape[0])
        if (m.dim() != 2 or m.dtype != torch.int32 or h < 1 or h & (h - 1)
                or (m.shape[1] > 1 and m.stride(1) != 1)):
            raise ValueError("reduced_open_many takes (H, W) int32 matrices, H a "
                             "power of two, with unit column stride")
    heights, mats, consts, n_apow, total, out_off, n_out = _ro_table(
        jobs, alpha, [m.data_ptr() for m, _ in jobs])
    out = torch.empty((n_out, 4), dtype=torch.int32, device=dev)
    tables, offs = _build.upload([heights, mats, consts], dev)
    base = tables.data_ptr()
    _build.launch("fri_reduced_open", "ovt_reduced_open", dev, base + offs[0],
                  len(heights), base + offs[1], base + offs[2], n_apow,
                  ntt.rev_root_table(dev).data_ptr(), bb.to_monty_int(bb.GENERATOR),
                  total, out.data_ptr())
    # the tables must outlive the launch: the caching allocator holds a
    # freed block for the stream's later work, and the kernel runs first
    return {lh: out[o:o + (1 << lh)] for lh, o in out_off.items()}


def _to_device_monty(m, device) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        # device "cuda" names whichever card is current; the tensor's device
        # carries its index, and the kernels check that operands agree
        if m.dtype != torch.int32 or m.device.type != device.type:
            raise ValueError("a trace tensor must hold int32 Montgomery "
                             f"words on {device}")
        return m  # already Montgomery on the device
    arr = np.asarray(m, dtype=np.uint64) % P
    return bb.to_monty(bb.from_numpy(arr.astype(np.uint32), device=device))


# ---------------------------------------------------------------------------
# The prover
# ---------------------------------------------------------------------------


@dataclass
class _MatInfo:
    """One committed matrix inside a FRI round."""

    lde_bitrev: torch.Tensor  # (2^log_lde, W) base Montgomery
    log_lde: int
    points: list  # canonical ext 4-tuples (z values)
    opened: list = None  # filled later: [(W, 4) canonical per point]
    coeffs: torch.Tensor = None  # (N, W) base Montgomery INTT coefficients
    in_shift: int = 1  # p(z) = sum_i coeffs_i (z / in_shift)^i


@dataclass
class _Round:
    tree: merkle.MerkleTree
    mats: list  # [_MatInfo]


def prove(pk: MultiStarkProvingKey, ctxs: list, device=None,
          stages: dict | None = None, record: dict | None = None) -> Proof:
    """Prove the given AIR instances (``AirProvingContext`` list) on
    ``device``, CUDA unless the caller names another.  When ``stages`` is a
    dict, the seconds of each stage are written into it.  When ``record`` is
    a dict, the inputs of the quotient interpreter (``"quotient"``: per AIR
    (bound program, sources, log_n, lqd)), of the LogUp kernels
    (``"logup"``: per AIR with interactions, see ``logup.build_perm_trace``),
    of the openings (``"openings"``: (jobs, zpows), see ``open_many``), of
    the FRI folds (``"fri_folds"``: (each fold's input, its beta, the
    reduced openings by log height), see ``fri.commit_phase``) and of the
    query gather (``"gather"``: (plan, indices)) are kept in it,
    so that a caller can run those kernels' plain versions at this prove's
    own shapes."""
    dev = resolve_device(device)
    if stages is not None:
        marks = [time.perf_counter()]

    def mark(stage):
        if stages is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            stages[stage] = now - marks[0]
            marks[0] = now

    cfg = pk.vk.config
    lb = cfg.fri.log_blowup
    challenger = DuplexChallenger()

    # ---- prepare traces on the device ----------------------------------
    ctxs = sorted(ctxs, key=lambda c: c.air_id)
    air_ids = [c.air_id for c in ctxs]
    vks = [pk.vk.per_air[c.air_id] for c in ctxs]
    commons = [_to_device_monty(c.common_main, dev) if c.common_main is not None
               else None for c in ctxs]
    cacheds = [[_to_device_monty(m, dev) for m in c.cached_mains] for c in ctxs]

    heights = []
    for com, cas in zip(commons, cacheds):
        h = int(com.shape[0] if com is not None else cas[0].shape[0])
        if h & (h - 1):
            raise ValueError(f"trace height {h} is not a power of two")
        heights.append(h)
    log_degrees = [h.bit_length() - 1 for h in heights]
    if any(ld + lb > MAX_TWO_ADICITY for ld in log_degrees):
        raise ValueError("trace too tall for the field's two-adicity")

    # ---- commit main traces --------------------------------------------
    cached_inputs = [(i, m) for i, cas in enumerate(cacheds) for m in cas]
    common_idx = [i for i, m in enumerate(commons) if m is not None]
    lde_in = [m for (_, m) in cached_inputs] + [commons[i] for i in common_idx]
    ldes, coeffs = ntt.batched_coset_ldes(lde_in, lb, return_coeffs=True)
    nc = len(cached_inputs)
    cached_ldes = [(i, y) for (i, _), y in zip(cached_inputs, ldes[:nc])]
    cached_coeffs = coeffs[:nc]
    common_ldes = [None] * len(commons)
    common_coeffs = [None] * len(commons)
    for i, y, c in zip(common_idx, ldes[nc:], coeffs[nc:]):
        common_ldes[i] = y
        common_coeffs[i] = c
    common_present = [i for i, m in enumerate(common_ldes) if m is not None]
    cached_trees = [merkle.commit([lde]) for (_, lde) in cached_ldes]
    common_tree = merkle.commit([common_ldes[i] for i in common_present])
    main_commits = [t.root for t in cached_trees] + [common_tree.root]
    mark("main_commit")

    # ---- transcript: preamble ------------------------------------------
    challenger.observe_slice(pk.vk.pre_hash)
    challenger.observe(len(ctxs))
    for a in air_ids:
        challenger.observe(a)
    for c, vk in zip(ctxs, vks):
        if len(c.public_values) != vk.num_public_values:
            raise ValueError(f"air {vk.name}: {len(c.public_values)} public "
                             f"values, expected {vk.num_public_values}")
        challenger.observe_slice(np.asarray(c.public_values, dtype=np.uint64))
    for vk in vks:
        if vk.preprocessed_commit is not None:
            challenger.observe_slice(vk.preprocessed_commit)
    for commit in main_commits:
        challenger.observe_slice(commit)
    for ld in log_degrees:
        challenger.observe(ld)

    # ---- phase 1: LogUp (prover.py:455-514) ------------------------------
    num_phases = pk.vk.num_phases
    perm_ldes, perm_coeffs = {}, {}
    exposed = {i: [] for i in range(len(ctxs))}
    challenges_m = np.zeros((2, 4), dtype=np.uint32)
    log_up_pow_witness = 0
    after_challenge_commits = []
    perm_order, perm_tree = [], None
    if num_phases:
        log_up_pow_witness = challenger.grind(cfg.log_up_pow_bits)
        challenges_c = (challenger.sample_ext(), challenger.sample_ext())
        challenges_m = bb.to_monty_np(np.asarray(challenges_c, dtype=np.uint64))
        # the layouts and columns code depend on the AIRs only: built once
        # per proving key and set of AIRs
        perm_order = [i for i, vk in enumerate(vks) if vk.widths.after_challenge]
        mains = [cacheds[i] + ([commons[i]] if commons[i] is not None else [])
                 for i in perm_order]
        preps = [pk.per_air[ctxs[i].air_id].preprocessed_trace for i in perm_order]
        plan_key = ("logup", tuple((ctxs[i].air_id, len(m)) for i, m
                                   in zip(perm_order, mains)))
        if plan_key not in pk.kernel_plans:
            pk.kernel_plans[plan_key] = logup.perm_plan(
                [vks[i].dag for i in perm_order],
                [vks[i].interaction_chunks for i in perm_order],
                [len(m) for m in mains], [p is not None for p in preps])
        built = logup.build_perm_traces(
            pk.kernel_plans[plan_key], mains, preps,
            [[bb.to_monty_int(int(v) % P) for v in ctxs[i].public_values]
             for i in perm_order], challenges_c,
            record=None if record is None else record.setdefault("logup", []))
        perm_traces = {i: t for i, (t, _) in zip(perm_order, built)}
        cumsums = {i: c for i, (_, c) in zip(perm_order, built)}
        # every cumulative sum is built before any is observed, so one copy
        # brings them all to the host; they are observed in AIR order
        cums = bb.canonical_np(torch.stack([cumsums[i] for i in perm_order]))
        for i, cum in zip(perm_order, cums):
            exposed[i] = [tuple(int(x) for x in cum)]
            challenger.observe_ext(cum)
        ldes_p, coeffs_p = ntt.batched_coset_ldes(
            [perm_traces[i] for i in perm_order], lb, return_coeffs=True)
        for i, y, cf in zip(perm_order, ldes_p, coeffs_p):
            perm_ldes[i], perm_coeffs[i] = y, cf
        perm_tree = merkle.commit([perm_ldes[i] for i in perm_order])
        after_challenge_commits = [perm_tree.root]
        challenger.observe_slice(perm_tree.root)
    mark("logup")

    alpha_c = challenger.sample_ext()
    alpha_m = bb.to_monty_np(np.asarray(alpha_c, dtype=np.uint64))

    # ---- quotient: every AIR in one interpreter launch -------------------
    # The code depends on the AIRs only, so it is compiled and uploaded once
    # per proving key and set of AIRs; each prove binds its own pool.
    keys, airs_q = [], []
    for i, (c, vk) in enumerate(zip(ctxs, vks)):
        mains = [lde for (j, lde) in cached_ldes if j == i] + (
            [common_ldes[i]] if common_ldes[i] is not None else [])
        prep = pk.per_air[c.air_id].preprocessed_lde
        keys.append((c.air_id, len(mains), prep is not None, i in perm_ldes))
        airs_q.append(mains + ([prep] if prep is not None else []) + (
            [perm_ldes[i]] if i in perm_ldes else []))
    code_key = (tuple(keys), str(dev))
    if code_key not in pk.quotient_code:
        progs = [qmod.compile_dag_code(pk.vk.per_air[a].dag, n_main=nm,
                                       has_preprocessed=hp, has_perm=hq)
                 for a, nm, hp, hq in keys]
        pk.quotient_code[code_key] = (
            progs, qmod.upload_code(progs, dev) if dev.type == "cuda" else None)
    progs, code_dev = pk.quotient_code[code_key]
    bound = []
    for i, (c, prog) in enumerate(zip(ctxs, progs)):
        publics = [bb.to_monty_int(int(v) % P) for v in c.public_values]
        expo = (bb.to_monty_np(np.asarray(exposed[i], dtype=np.uint64))
                if exposed[i] else np.zeros((1, 4), dtype=np.uint32))
        bound.append(qmod.bind(prog, publics=publics, challenges=challenges_m,
                               exposed=expo, alpha=alpha_m))
    lqds = [vk.log_quotient_degree for vk in vks]
    if record is not None:
        record["quotient"] = [(prog, src, log_degrees[i], lqds[i])
                              for i, (prog, src) in enumerate(zip(bound, airs_q))]
    qs = qmod.evaluate_many(bound, airs_q, log_degrees, lqds, code=code_dev)
    quotient_chunk_mats = []  # [(air_pos, chunk_idx, (N, 4) natural evals)]
    for i, q in enumerate(qs):
        step = 1 << lqds[i]
        quotient_chunk_mats.extend(
            (i, chunk_i, q[chunk_i::step].contiguous()) for chunk_i in range(step))

    # commit quotient chunks (one tree); chunk domain shift = g * w_q^i
    q_triples = []
    for i, chunk_i, evals in quotient_chunk_mats:
        w_q = bb.two_adic_generator_int(log_degrees[i] + vks[i].log_quotient_degree)
        in_shift = (bb.GENERATOR * pow(w_q, chunk_i, P)) % P
        y, cf = ntt.coset_lde(evals, lb, shift=bb.GENERATOR, in_shift=in_shift,
                              return_coeffs=True)
        q_triples.append((y, cf, in_shift))
    q_ldes = [t[0] for t in q_triples]
    quotient_tree = merkle.commit(q_ldes)
    mark("quotient")
    challenger.observe_slice(quotient_tree.root)

    zeta_c = challenger.sample_ext()

    # ---- build rounds & open at points ---------------------------------
    def trace_points(i):
        g_n = bb.two_adic_generator_int(log_degrees[i])
        return [tuple(zeta_c), tuple(nx.nmul_base(np.asarray(zeta_c), g_n)
                                     .tolist())]

    rounds = []
    for i, (c, vk) in enumerate(zip(ctxs, vks)):  # 1. preprocessed rounds
        apk = pk.per_air[c.air_id]
        if apk.preprocessed_lde is not None:
            rounds.append(_Round(tree=apk.preprocessed_tree, mats=[_MatInfo(
                apk.preprocessed_lde, log_degrees[i] + lb, trace_points(i),
                coeffs=ntt.intt(apk.preprocessed_trace))]))
    for tree, (i, lde), cf in zip(cached_trees, cached_ldes, cached_coeffs):
        rounds.append(_Round(tree=tree, mats=[  # 2. cached main rounds
            _MatInfo(lde, log_degrees[i] + lb, trace_points(i), coeffs=cf)]))
    rounds.append(_Round(tree=common_tree, mats=[  # 2b. common main round
        _MatInfo(common_ldes[i], log_degrees[i] + lb, trace_points(i),
                 coeffs=common_coeffs[i])
        for i in common_present]))
    if num_phases:
        rounds.append(_Round(tree=perm_tree, mats=[  # 3. after-challenge round
            _MatInfo(perm_ldes[i], log_degrees[i] + lb, trace_points(i),
                     coeffs=perm_coeffs[i])
            for i in perm_order]))
    rounds.append(_Round(tree=quotient_tree, mats=[  # 4. quotient round
        _MatInfo(q_ldes[k], log_degrees[i] + lb, [tuple(zeta_c)],
                 coeffs=q_triples[k][1], in_shift=q_triples[k][2])
        for k, (i, chunk_i, _) in enumerate(quotient_chunk_mats)]))

    # Every point factors as zeta * c^i with a base-field c (zeta*g_n for
    # the next row, zeta/in_shift for quotient chunks): one zeta power
    # series (K2) serves every opening, and K12 makes each c^i itself, for
    # every matrix in one launch.
    all_mats = [m for rnd in rounds for m in rnd.mats]
    n_max = 1 << max(log_degrees)
    zpows = ef.powers_host([bb.to_monty_int(c) for c in zeta_c], n_max, dev)
    jobs = []
    for m in all_mats:
        if m.in_shift == 1:
            mults = [1, bb.two_adic_generator_int(m.log_lde - lb)]
        else:
            mults = [pow(m.in_shift, -1, P)]
        jobs.append((m.coeffs, mults[:len(m.points)]))
    if record is not None:
        record["openings"] = (jobs, zpows)
    opened_dev = open_many(jobs, zpows)
    # one copy to the host for every opening
    flat = bb.from_monty(torch.cat([o.reshape(-1) for o in opened_dev]))
    flat = flat.cpu().numpy().astype(np.uint64)
    off = 0
    for m, o in zip(all_mats, opened_dev):
        k = o.numel()
        vals = flat[off:off + k].reshape(o.shape)
        off += k
        m.opened = [vals[j] for j in range(vals.shape[0])]

    # observe all opened values (round/mat/point/column order, 4 felts each)
    for rnd in rounds:
        for mat in rnd.mats:
            for opened in mat.opened:
                challenger.observe_slice(opened.reshape(-1))
    mark("openings")
    fri_alpha_c = tuple(challenger.sample_ext())

    # ---- reduced opening polynomials (K13) -----------------------------
    log_max = max(log_degrees)
    log_max_lde = log_max + lb
    ro_jobs = reduced_open_jobs([(m.lde_bitrev, m.points, m.opened) for m in all_mats],
                                fri_alpha_c)
    if record is not None:
        record["reduced_openings"] = (ro_jobs, fri_alpha_c)
    ro_polys = reduced_open_many(ro_jobs, fri_alpha_c)
    mark("reduced_openings")

    # ---- FRI commit phase + PoW + queries ------------------------------
    trees, betas, final_poly_ct, evals_per_step = fri.commit_phase(
        ro_polys, log_max_lde, lb, challenger)
    if record is not None:
        record["fri_folds"] = (evals_per_step, betas, ro_polys)
    for felt in final_poly_ct:
        challenger.observe(felt)
    mark("fri_commit")
    pow_witness = challenger.grind(cfg.fri.proof_of_work_bits)
    mark("pow")

    # every index is sampled before any opening is observed, so one gather
    # (K6) and one copy to the host serve the whole query phase
    indices = [challenger.sample_bits(log_max_lde)
               for _ in range(cfg.fri.num_queries)]
    plan = merkle.GatherPlan()
    round_ids = [plan.add_tree(rnd.tree, log_max_lde - max(m.log_lde
                                                           for m in rnd.mats))
                 for rnd in rounds]
    level_ids = fri.add_query_jobs(plan, trees, evals_per_step)
    if record is not None:
        record["gather"] = (plan, indices)
    blocks = plan.run(indices)
    mark("query_gather")
    nq = len(indices)
    round_openings = [merkle.format_gathered_rows(
        {"mats": [blocks[k] for k in mats], "sibs": [blocks[k] for k in sibs]}, nq)
        for mats, sibs in round_ids]
    steps_per_query = fri.format_gathered_queries(
        fri.collect_queries(blocks, level_ids), nq)
    query_proofs = []
    for qi in range(nq):
        input_proof = [fri.BatchOpening(
            opened_values=[list(map(int, r)) for r in round_openings[ri][qi][0]],
            opening_proof=round_openings[ri][qi][1])
            for ri in range(len(rounds))]
        query_proofs.append(fri.QueryProof(
            input_proof=input_proof, commit_phase_openings=steps_per_query[qi]))
    mark("query_format")
    fri_proof = fri.FriProof(
        commit_phase_commits=[t.root for t in trees],
        query_proofs=query_proofs, final_poly=[final_poly_ct],
        pow_witness=pow_witness)

    # ---- assemble opened-value structure -------------------------------
    def row_to_exts(arr):
        return [tuple(int(x) for x in arr[t]) for t in range(arr.shape[0])]

    def adjacent(mat: _MatInfo) -> AdjacentOpenedValues:
        return AdjacentOpenedValues(local=row_to_exts(mat.opened[0]),
                                    next=row_to_exts(mat.opened[1]))

    ridx = 0
    prep_values = []
    for i in range(len(vks)):
        if pk.per_air[ctxs[i].air_id].preprocessed_lde is not None:
            prep_values.append(adjacent(rounds[ridx].mats[0]))
            ridx += 1
    main_values = []
    for _ in cached_trees:
        main_values.append([adjacent(rounds[ridx].mats[0])])
        ridx += 1
    main_values.append([adjacent(m) for m in rounds[ridx].mats])
    ridx += 1
    after_values = []
    if num_phases:
        after_values.append([adjacent(m) for m in rounds[ridx].mats])
        ridx += 1
    quotient_values = [[] for _ in ctxs]
    for (i, _, _), mat in zip(quotient_chunk_mats, rounds[ridx].mats):
        quotient_values[i].append(row_to_exts(mat.opened[0]))

    # permutation of airs by decreasing height (stable)
    air_perm_by_height = sorted(range(len(ctxs)), key=lambda i: -log_degrees[i])
    per_air = [AirProofData(
        air_id=air_ids[i], log_degree=log_degrees[i],
        exposed_values_after_challenge=[exposed[i]] if num_phases else [],
        public_values=[int(v) % P for v in ctxs[i].public_values])
        for i in range(len(ctxs))]
    return Proof(
        commitments=Commitments(main_trace=main_commits,
                                after_challenge=after_challenge_commits,
                                quotient=quotient_tree.root),
        opening=Opening(proof=fri_proof, values=OpeningValues(
            preprocessed=prep_values, main=main_values,
            after_challenge=after_values, quotient=quotient_values)),
        per_air=per_air, air_perm_by_height=air_perm_by_height,
        log_up_pow_witness=log_up_pow_witness)
