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
  zeta power series          field.ext.powers (K2)
  out-of-domain openings     open_many (K12)
  reduced openings           reduced_open (K13)
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


def _col_comb(matrix: torch.Tensor, alpha_pows: torch.Tensor) -> torch.Tensor:
    """sum_t alpha^t * M[:, t] -> (N, 4) ext Montgomery, plain PyTorch
    (prover.py:194); K13 computes it inside its pass."""
    w = matrix.shape[1]
    prod = bb.mul64(matrix.long()[:, :, None], alpha_pows[:w].long()[None])
    return (prod.sum(dim=1) % P).int()


def _open_dot_plain(coeffs: torch.Tensor, zpows: torch.Tensor,
                    geos: torch.Tensor) -> torch.Tensor:
    """out[p, t] = sum_i coeffs[i, t] * zpows[i] * geos[p, i], plain
    PyTorch; (Pts, W, 4) Montgomery words."""
    n = coeffs.shape[0]
    c = coeffs.long()
    out = []
    for p in range(geos.shape[0]):
        u = ef.scale64(zpows[:n].long(), geos[p, :n].long())  # (N, 4)
        prod = bb.mul64(c[:, :, None], u[:, None, :])  # (N, W, 4)
        out.append(prod.sum(dim=0) % P)
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


def reduced_open_plain(ro: torch.Tensor, mat: torch.Tensor,
                       apows: torch.Tensor, points: list) -> torch.Tensor:
    """ro + sum_p alpha_pow_p * (p_p(z)_comb - comb) / (z_p - x), plain
    PyTorch.  points: [(p(z)_comb, z, alpha_pow)] as (4,) Montgomery
    tensors; ro (H, 4) bit-reversed; returns the new ro."""
    h = mat.shape[0]
    comb = _col_comb(mat, apows).long()
    acc = ro.long()
    for pz, z, ap in points:
        num = bb.sub64(pz.long(), comb)
        inv = _inv_z_minus_x(tuple(z.tolist()), h.bit_length() - 1, ro.device)
        acc = bb.add64(acc, ef.mul64(ap.long(), ef.mul64(num, inv)))
    return acc.int()


@functools.lru_cache(maxsize=16)
def _inv_z_minus_x(z: tuple, log_h: int, device) -> torch.Tensor:
    """1 / (z - x) over the bit-reversed LDE points of height 2^log_h,
    int64 (H, 4); every matrix of that height opened at z shares it."""
    xs = ntt.lde_points(log_h, device).long()
    zmx = torch.tensor(z, dtype=torch.int64, device=device).expand(1 << log_h, 4).clone()
    zmx[:, 0] = bb.sub64(zmx[:, 0], xs)
    return ef.inv64(zmx)


def reduced_open(ro: torch.Tensor, mat: torch.Tensor, apows: torch.Tensor,
                 points: list) -> torch.Tensor:
    """Kernel K13 (csrc/fri.cu) on CUDA tensors: the reduced-opening terms of
    one matrix added into ``ro`` in place (and returned); the plain version
    on CPU tensors.  See ``reduced_open_plain``."""
    dev = _build.kernel_device(ro, mat, apows)
    if dev.type == "cpu":
        return reduced_open_plain(ro, mat, apows, points)
    h, w = (int(s) for s in mat.shape)
    if mat.stride(1) != 1 or mat.dtype != torch.int32:
        raise ValueError("reduced_open takes an int32 matrix with unit column stride")
    _build.check_words(ro, "ro", dev)
    if tuple(ro.shape) != (h, 4) or apows.shape[0] < w:
        raise ValueError("ro must be (H, 4) and apows hold W powers")
    apows = apows.contiguous()
    pts = torch.stack([torch.stack(p) for p in points]).contiguous()
    xs = ntt.lde_points(h.bit_length() - 1, dev)
    _build.launch("fri_reduced_open", "ovt_reduced_open", dev, mat.data_ptr(),
                  mat.stride(0), w, h, apows.data_ptr(), len(points),
                  pts.data_ptr(), xs.data_ptr(), ro.data_ptr())
    return ro


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
    of the openings (``"openings"``: (jobs, zpows), see ``open_many``) and
    of the query gather (``"gather"``: (plan, indices)) are kept in it,
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
    zpows = ef.powers(ef.from_canonical(zeta_c, device=dev), n_max)
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
    max_width = max(int(m.lde_bitrev.shape[1]) for r in rounds for m in r.mats)
    apows_host = np.zeros((max_width + 1, 4), dtype=np.uint64)
    apows_host[0] = (1, 0, 0, 0)
    for t in range(1, max_width + 1):
        apows_host[t] = nx.nmul(apows_host[t - 1], np.asarray(fri_alpha_c))
    apows = bb.monty(apows_host, device=dev)
    ro_polys: dict = {}
    ro_alpha_pow: dict = {}
    for rnd in rounds:
        for mat in rnd.mats:
            lh = mat.log_lde
            w = int(mat.lde_bitrev.shape[1])
            if lh not in ro_polys:
                ro_polys[lh] = torch.zeros((1 << lh, 4), dtype=torch.int32,
                                           device=dev)
                ro_alpha_pow[lh] = np.asarray([1, 0, 0, 0], dtype=np.uint64)
            points = []
            for z, opened in zip(mat.points, mat.opened):
                pz_comb = nx.nmul(opened, apows_host[:w]).sum(axis=0) % P
                points.append(tuple(ef.from_canonical(v, device=dev) for v in
                                    (pz_comb, z, ro_alpha_pow[lh])))
                ro_alpha_pow[lh] = nx.nmul(ro_alpha_pow[lh], apows_host[w])
            ro_polys[lh] = reduced_open(ro_polys[lh], mat.lde_bitrev, apows,
                                        points)
    mark("reduced_openings")

    # ---- FRI commit phase + PoW + queries ------------------------------
    trees, _, final_poly_ct, evals_per_step = fri.commit_phase(
        ro_polys, log_max_lde, lb, challenger)
    for felt in final_poly_ct:
        challenger.observe(felt)
    pow_witness = challenger.grind(cfg.fri.proof_of_work_bits)
    mark("fri_commit_pow")

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
    mark("queries")
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
