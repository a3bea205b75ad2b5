"""Multi-trace STARK prover on the card.

Port of openvm_tpu/stark/prover.py: the same transcript and the same proof,
so ``codec.encode_proof`` gives equal bytes for equal inputs.  Host code
(this file) orchestrates; every row-parallel step runs a kernel of
``openvm_tpu_torch/csrc`` on CUDA tensors:

  main, perm, quotient LDEs  ntt.batched_coset_ldes / coset_lde (K3)
  Merkle commits             merkle.commit (K4, K5)
  interaction fields         stark.quotient.evaluate_columns (K7, columns)
  LogUp permutation trace    stark.logup.perm_cols, perm_scan (K9, K10)
  quotient                   stark.quotient.evaluate (K7+K11)
  zeta power series          field.ext.powers (K2)
  out-of-domain openings     _open_dot (K12)
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


def _geo_series(mult: int, n: int) -> np.ndarray:
    """(n,) Montgomery words mult^0..mult^(n-1) (prover.py:260-269)."""
    return bb.to_monty_np(bb.powers_np(mult, n))


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


def _open_dot(coeffs: torch.Tensor, zpows: torch.Tensor,
              geos: torch.Tensor) -> torch.Tensor:
    """Kernel K12 (csrc/open.cu) on CUDA tensors, ``_open_dot_plain`` on CPU
    tensors (prover.py:231-257).  coeffs (N, W) base, any row stride;
    zpows (>= N, 4) ext; geos (Pts, >= N) base, Pts <= 2.  Two launches:
    per-block partial sums, then their sum."""
    dev = _build.kernel_device(coeffs, zpows, geos)
    if dev.type == "cpu":
        return _open_dot_plain(coeffs, zpows, geos)
    n, w = (int(s) for s in coeffs.shape)
    npts = int(geos.shape[0])
    if not 1 <= npts <= 2 or coeffs.stride(1) != 1 or coeffs.dtype != torch.int32:
        raise ValueError("open_dot takes int32 coeffs with unit column stride "
                         "and one or two points")
    _build.check_words(zpows, "zpows", dev)
    geos = geos[:, :n].contiguous()
    out = torch.empty((npts, w, 4), dtype=torch.int32, device=dev)
    if w == 0 or n == 0:
        return out.zero_()
    blocks = max(1, min(1024, -(-n // (8 * 16))))
    partial = torch.empty((blocks, npts, w, 4), dtype=torch.int32, device=dev)
    _build.launch("open_dot", "ovt_open_partial", dev, coeffs.data_ptr(),
                  coeffs.stride(0), w, n, zpows.data_ptr(), geos.data_ptr(),
                  npts, blocks, partial.data_ptr())
    _build.launch("open_dot", "ovt_open_reduce", dev, partial.data_ptr(),
                  blocks, npts * w * 4, out.data_ptr())
    return out


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
    (program, sources, log_n, lqd, alpha)), of the LogUp kernels
    (``"logup"``: per AIR with interactions, see ``logup.build_perm_trace``)
    and of the query gather (``"gather"``: (plan, indices)) are kept in it,
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
        perm_traces, cumsums = {}, {}
        for i, (c, vk) in enumerate(zip(ctxs, vks)):
            if not vk.widths.after_challenge:
                continue
            mains = cacheds[i] + ([commons[i]] if commons[i] is not None else [])
            publics = [bb.to_monty_int(int(v) % P) for v in c.public_values]
            perm_traces[i], cumsums[i] = logup.build_perm_trace(
                vk.dag, vk.interaction_chunks, mains,
                pk.per_air[c.air_id].preprocessed_trace, publics, challenges_c,
                record=None if record is None else record.setdefault("logup", []))
        perm_order = sorted(perm_traces)
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
    alpha = ef.from_canonical(alpha_c, device=dev)

    # ---- quotient: one interpreter pass per AIR ------------------------
    quotient_chunk_mats = []  # [(air_pos, chunk_idx, (N, 4) natural evals)]
    for i, (c, vk) in enumerate(zip(ctxs, vks)):
        apk = pk.per_air[c.air_id]
        lqd = vk.log_quotient_degree
        mains = [lde for (j, lde) in cached_ldes if j == i] + (
            [common_ldes[i]] if common_ldes[i] is not None else [])
        prep = apk.preprocessed_lde
        publics = [bb.to_monty_int(int(v) % P) for v in c.public_values]
        expo = (bb.to_monty_np(np.asarray(exposed[i], dtype=np.uint64))
                if exposed[i] else np.zeros((1, 4), dtype=np.uint32))
        prog = qmod.compile_dag(vk.dag, n_main=len(mains),
                                has_preprocessed=prep is not None,
                                has_perm=i in perm_ldes, publics=publics,
                                challenges=challenges_m, exposed=expo)
        sources = mains + ([prep] if prep is not None else []) + (
            [perm_ldes[i]] if i in perm_ldes else [])
        if record is not None:
            record.setdefault("quotient", []).append(
                (prog, sources, log_degrees[i], lqd, alpha))
        q = qmod.evaluate(prog, sources, log_degrees[i], lqd, alpha)
        step = 1 << lqd
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
    # series (K2) and per-matrix geometric tables serve every opening (K12).
    all_mats = [m for rnd in rounds for m in rnd.mats]
    n_max = 1 << max(log_degrees)
    zpows = ef.powers(ef.from_canonical(zeta_c, device=dev), n_max)
    geo_cache: dict = {}

    def geo(mult, n):
        if (mult, n) not in geo_cache:
            geo_cache[(mult, n)] = bb.from_numpy(_geo_series(mult, n), device=dev)
        return geo_cache[(mult, n)]

    opened_dev = []
    for m in all_mats:
        n_m = int(m.coeffs.shape[0])
        if m.in_shift == 1:
            mults = [1, bb.two_adic_generator_int(m.log_lde - lb)]
        else:
            mults = [pow(m.in_shift, -1, P)]
        geos = torch.stack([geo(x, n_m) for x in mults[:len(m.points)]])
        opened_dev.append(_open_dot(m.coeffs, zpows, geos))
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
