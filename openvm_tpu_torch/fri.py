"""FRI low-degree commitment: commit and fold phase on the device, host verify.

Port of openvm_tpu/fri.py (all but ``answer_query`` :142,
``answer_queries_batch`` :181 and the scalar ``verify_query_host`` :261,
which have no callers).  The protocol is the
one pinned by the reference's recursive verifier:

  * inputs: per-LDE-height "reduced opening" polynomials (extension
    valued, rows in bit-reversed order over the coset g*<w_H>)
  * fold step (height H -> H/2): commit the pair matrix (H/2, 8) = rows
    [v[2j], v[2j+1]], observe the root, sample beta, fold
    v'[j] = interpolate{(y_j, v[2j]), (-y_j, v[2j+1])}(beta) with
    y_j = w_H^rev_{H/2}(j); then v' += beta^2 * ro[log(H/2)]
  * after the folds the values are constant: the final polynomial
  * proof of work, then per query: open the input trees and each pair tree

``fold_evals`` is kernel K14 (csrc/fri.cu) on CUDA tensors and its plain
version on CPU tensors; the query gathers run kernel K6
(``merkle.GatherPlan``).  Verification is host numpy, copied from
openvm_tpu/fri.py:195-308.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import _build, merkle, ntt
from .field import babybear as bb
from .field import ext as ef


@dataclass
class CommitPhaseStep:
    sibling_value: tuple  # ext as 4 canonical ints
    opening_proof: list  # list of (8,) canonical digests


@dataclass
class QueryProof:
    input_proof: list  # list[BatchOpening] (one per round)
    commit_phase_openings: list  # list[CommitPhaseStep]


@dataclass
class BatchOpening:
    opened_values: list  # per matrix: list of canonical ints (the row)
    opening_proof: list  # sibling digests


@dataclass
class FriProof:
    commit_phase_commits: list  # list[(8,) canonical digest]
    query_proofs: list
    final_poly: list  # [ext 4-tuple]
    pow_witness: int


@functools.lru_cache(maxsize=None)
def _fold_xs(log_h: int) -> np.ndarray:
    """y_j = w_H^rev_{H/2}(j) for j < H/2, Montgomery words (fri.py:57-71),
    vectorised."""
    pows = bb.to_monty_np(bb.powers_np(bb.two_adic_generator_int(log_h),
                                       (1 << log_h) // 2))
    return pows[ntt.bitrev_perm(log_h - 1)] if log_h >= 2 else pows


def _inv_neg2y_np(log_half: int) -> np.ndarray:
    """1/(-2 y_j) = -(1/2) (w_H^-1)^rev(j), j < H/2 = 2^log_half."""
    log_h = log_half + 1
    w_inv = pow(bb.two_adic_generator_int(log_h), -1, bb.P)
    pows = bb.powers_np(w_inv, 1 << log_half, bb.P - pow(2, -1, bb.P))
    return bb.to_monty_np(pows[ntt.bitrev_perm(log_half)])


def _fold_tables(log_h: int, device) -> tuple:
    """(y, 1/(-2y)) for a fold of height 2^log_h on ``device``, for the
    plain version (K14 makes its points on the card).  The tables
    of a height are prefixes of those of any larger height
    (w_H^(2^k) rev_{H/2^(k+1)}(j) = w_H^rev_{H/2}(j) for j < H/2^(k+1)), so
    the largest fold's tables serve every level."""
    return (ntt.prefix_table("fold_y", log_h - 1,
                             lambda lg: _fold_xs(lg + 1), device),
            ntt.prefix_table("fold_inv_neg2y", log_h - 1, _inv_neg2y_np,
                             device))


def fold_evals_plain(evals: torch.Tensor, beta: torch.Tensor,
                     ro=None) -> torch.Tensor:
    """One fold, plain PyTorch: (H, 4) bit-reversed -> (H/2, 4), plus
    beta^2 * ro when ``ro`` (H/2, 4) is given."""
    log_h = int(evals.shape[0]).bit_length() - 1
    y, inv_neg2y = (t.long() for t in _fold_tables(log_h, evals.device))
    v0, v1 = evals[0::2].long(), evals[1::2].long()
    beta = beta.long()
    slope = ef.scale64(bb.sub64(v1, v0), inv_neg2y)
    bmy = beta.expand_as(v0).clone()
    bmy[:, 0] = bb.sub64(bmy[:, 0], y)
    out = bb.add64(v0, ef.mul64(bmy, slope))
    if ro is not None:
        out = bb.add64(out, ef.mul64(ef.mul64(beta, beta), ro.long()))
    return out.int()


def _fold_model(evals: torch.Tensor, beta: torch.Tensor, ro=None) -> torch.Tensor:
    """K14 modelled on the CPU: thread u folds rows 4u .. 4u+3 into outputs
    2u and 2u+1; y_2u and 1/(-2 y_2u) from the on-card point split
    (``ntt.rev_root_points`` of row 4u), y_(2u+1) = y_2u w_4 and its
    inverse factor times w_4^-1; beta^2 ro added where given."""
    h = int(evals.shape[0])
    log_h, half = h.bit_length() - 1, h // 2
    rows = 4 * np.arange(-(-half // 2))
    y = ntt.rev_root_points(log_h, rows)
    n = ntt.rev_root_points(log_h, rows, inverse=True) * (bb.P - pow(2, -1, bb.P)) % bb.P
    w4 = bb.two_adic_generator_int(2)
    y = np.stack([y, y * w4 % bb.P], axis=1).reshape(-1)[:half]
    n = np.stack([n, n * pow(w4, -1, bb.P) % bb.P], axis=1).reshape(-1)[:half]
    y, n = (torch.from_numpy(bb.to_monty_np(a).astype(np.int64)) for a in (y, n))
    v = evals.long()
    v0, v1 = v[0::2], v[1::2]
    slope = ef.scale64(bb.sub64(v1, v0), n)
    bmy = beta.long().expand_as(v0).clone()
    bmy[:, 0] = bb.sub64(bmy[:, 0], y)
    out = bb.add64(v0, ef.mul64(bmy, slope))
    if ro is not None:
        out = bb.add64(out, ef.mul64(ef.mul64(beta.long(), beta.long()), ro.long()))
    return out.int()


def fold_evals(evals: torch.Tensor, beta: torch.Tensor, ro=None) -> torch.Tensor:
    """v'[j] = v0 + (beta - y_j)(v1 - v0)/(-2 y_j) (fri.py:77-95), with
    + beta^2 * ro[j] fused when ``ro`` is given (fri.py:130-133).

    Kernel K14 (csrc/fri.cu) on CUDA tensors: two outputs a thread, 16-byte
    loads and stores, the points made on the card (no host table); the
    plain version on CPU tensors."""
    operands = (evals, beta) if ro is None else (evals, beta, ro)
    dev = _build.kernel_device(*operands)
    if dev.type == "cpu":
        return fold_evals_plain(evals, beta, ro)
    h = int(evals.shape[0])
    if evals.dim() != 2 or evals.shape[1] != 4 or h < 2 or h & (h - 1):
        raise ValueError(f"fold takes (H, 4), H a power of two >= 2, got "
                         f"{tuple(evals.shape)}")
    _build.check_words(evals, "fold evals", dev)
    beta = beta.contiguous()
    _build.check_words(beta, "fold beta", dev)
    if ro is not None:
        _build.check_words(ro, "fold ro", dev)
        if tuple(ro.shape) != (h // 2, 4):
            raise ValueError(f"ro must be ({h // 2}, 4), got {tuple(ro.shape)}")
    for t, name in ((evals, "evals"), (ro, "ro")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"fold {name} must start on a 16-byte boundary")
    out = torch.empty((h // 2, 4), dtype=torch.int32, device=dev)
    _build.launch("fri_fold", "ovt_fri_fold", dev, evals.data_ptr(), beta.data_ptr(),
                  ntt.rev_root_table(dev).data_ptr(),
                  None if ro is None else ro.data_ptr(), h // 2, h.bit_length() - 1,
                  out.data_ptr())
    return out


def commit_phase(ro_polys: dict, log_max_lde: int, log_blowup: int,
                 challenger) -> tuple:
    """Run the FRI commit phase (fri.py:104-139).

    ro_polys: {log_height: (2^log_height, 4) ext Montgomery, bit-reversed}.
    Returns (commit_phase_trees, betas, final_poly_ct, evals_per_step)
    where evals_per_step[i] is the input of fold step i (for queries).
    Raises AssertionError when the final polynomial is not constant, as
    the JAX package does (fri.py:136)."""
    current = ro_polys[log_max_lde]
    dev = current.device
    trees, betas, evals_per_step = [], [], []
    log_h = log_max_lde
    while log_h > log_blowup:
        evals_per_step.append(current)
        h = 1 << log_h
        tree = merkle.commit([current.reshape(h // 2, 8)])
        trees.append(tree)
        challenger.observe_slice(tree.root)
        beta = ef.from_canonical(challenger.sample_ext(), device=dev)
        betas.append(beta)
        log_h -= 1
        current = fold_evals(current, beta, ro_polys.get(log_h))
    final_host = bb.canonical_np(current)
    if not all(np.array_equal(final_host[0], r) for r in final_host):
        raise AssertionError(
            "FRI final polynomial is not constant — constraints unsatisfied?")
    final_poly_ct = tuple(int(x) for x in final_host[0])
    return trees, betas, final_poly_ct, evals_per_step


def add_query_jobs(plan: merkle.GatherPlan, trees: list,
                   evals_per_step: list) -> list:
    """Add fold level i's sibling values (row (index >> i) ^ 1 of its
    input) and pair-tree path (at index >> (i + 1)) to ``plan``; returns the
    job ids per level as (sibling job, [path jobs])."""
    ids = []
    for i, (tree, evals) in enumerate(zip(trees, evals_per_step)):
        sib = plan.add(evals, i, 1)
        _, path = plan.add_tree(tree, i + 1, rows=False)
        ids.append((sib, path))
    return ids


def collect_queries(blocks: list, ids: list) -> list:
    """The per-level result of ``gather_queries_device`` from a run plan's
    blocks and ``add_query_jobs``'s ids."""
    return [{"sibs": blocks[sib],
             "paths": {"mats": [], "sibs": [blocks[k] for k in path]}}
            for sib, path in ids]


def gather_queries_device(indices, trees: list, evals_per_step: list) -> list:
    """All commit-phase query openings (fri.py:155): per fold level the
    sibling values and the pair-tree paths, canonical, in one K6 launch
    and one copy to the host."""
    plan = merkle.GatherPlan()
    ids = add_query_jobs(plan, trees, evals_per_step)
    return collect_queries(plan.run(indices), ids)


def format_gathered_queries(per_level, q: int):
    """steps_per_query[qi] = [CommitPhaseStep per fold level]."""
    paths = [merkle.format_gathered_rows(lv["paths"], q) for lv in per_level]
    return [[CommitPhaseStep(
        sibling_value=tuple(int(x) for x in per_level[i]["sibs"][qi]),
        opening_proof=paths[i][qi][1])
        for i in range(len(per_level))] for qi in range(q)]


# ---------------------------------------------------------------------------
# Host-side verification helpers (canonical ints)
# ---------------------------------------------------------------------------

def verify_queries_host(config, commit_phase_commits, indices,
                        steps_per_query, betas, reduced_openings,
                        log_max_lde: int, final_poly_ct) -> np.ndarray:
    """Every query's fold chain at once (the reference's verify_query,
    fri/mod.rs:32-170, vectorised over the query axis).

    indices: (Q,) ints; steps_per_query[qi][i] = CommitPhaseStep;
    reduced_openings: {log_height: (Q, 4) canonical uint64}.
    Returns (Q,) bool, one verdict per query.
    """
    from .stark import npext as nx
    q = len(indices)
    # malformed-proof guard: every query must carry exactly one
    # commit-phase step per fold level
    if any(len(steps_per_query[k]) != len(commit_phase_commits)
           for k in range(q)):
        return np.zeros(q, dtype=bool)
    idx_arr = np.asarray(indices, dtype=np.int64)
    folded = np.asarray(reduced_openings[log_max_lde], dtype=np.uint64) % bb.P
    ok = np.ones(q, dtype=bool)

    for i, (commit, beta) in enumerate(zip(commit_phase_commits, betas)):
        log_folded = log_max_lde - i - 1
        idx_level = idx_arr >> i
        bit = (idx_level & 1)[:, None] == 1
        sibs = np.asarray([steps_per_query[k][i].sibling_value
                           for k in range(q)], dtype=np.uint64)  # (Q, 4)
        e0 = np.where(bit, sibs, folded)
        e1 = np.where(bit, folded, sibs)

        rows = np.concatenate([e0, e1], axis=1)  # (Q, 8)
        depth = max(log_folded, 0)
        if any(len(steps_per_query[k][i].opening_proof) != depth
               for k in range(q)):
            return np.zeros(q, dtype=bool)  # malformed path length
        proofs_q = [np.asarray([steps_per_query[k][i].opening_proof[lv]
                                for k in range(q)], dtype=np.uint64)
                    for lv in range(depth)]
        ok &= merkle.verify_batch_queries(
            np.asarray(commit, dtype=np.uint64),
            [(1 << log_folded, 8)], idx_level >> 1, [rows], proofs_q)

        w = bb.two_adic_generator_int(log_folded + 1)
        if log_folded > 0:
            rev = nx.rev_bits_arr(idx_level >> 1, log_folded)
            y0 = nx.npow_base_varexp(w, rev)  # (Q,)
        else:
            y0 = np.ones(q, dtype=np.uint64)
        xs0 = nx.from_base(y0)
        xs1 = nx.from_base((bb.P - y0) % bb.P)
        beta_b = np.asarray(beta, dtype=np.uint64)[None, :] % bb.P
        num = nx.nmul(nx.nsub(np.broadcast_to(beta_b, (q, 4)), xs0),
                      nx.nsub(e1, e0))
        folded = nx.nadd(e0, nx.nmul(num, nx.ninv(nx.nsub(xs1, xs0))))
        ro = reduced_openings.get(log_folded)
        if ro is not None:
            beta_sq = nx.nmul(beta_b, beta_b)
            folded = nx.nadd(folded, nx.nmul(
                np.broadcast_to(beta_sq, (q, 4)),
                np.asarray(ro, dtype=np.uint64) % bb.P))
    ok &= np.all(folded == np.asarray(final_poly_ct,
                                      dtype=np.uint64)[None, :], axis=1)
    return ok
