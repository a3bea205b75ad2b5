"""Multi-trace STARK verifier (host-side, canonical integers).

Copy of openvm_tpu/stark/verifier.py:1-408, a line-by-line mirror of the
reference verifier semantics (reference extensions/native/recursion/src/
stark/mod.rs verify_raps + fri/two_adic_pcs.rs verify_two_adic_pcs).  It
checks the port's proofs and the JAX package's alike.  Extension values are
(4,) canonical uint64 arrays and all extension arithmetic is ``npext``'s
(the JAX copy mixes it with python-int tuple helpers); values read from a
proof are reduced mod p on entry, as those helpers reduce them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..field import babybear as bb
from .. import fri as fri_mod
from .. import merkle
from ..challenger import DuplexChallenger
from .config import MAX_TWO_ADICITY
from . import npext as nx
from .evaluator import HostOps
from .keygen import MultiStarkVerifyingKey

P = bb.P


class VerificationError(Exception):
    pass


def _check(cond: bool, msg: str):
    if not cond:
        raise VerificationError(msg)


def _ext(v) -> np.ndarray:
    """An extension value from a proof or the challenger, canonical."""
    return np.asarray(v, dtype=np.uint64) % P


def _ext_pow(a, e: int):
    r = nx.from_base(1)
    while e:
        if e & 1:
            r = nx.nmul(r, a)
        a = nx.nmul(a, a)
        e >>= 1
    return r


def verify(vk: MultiStarkVerifyingKey, proof) -> None:
    """Raises VerificationError on failure."""
    cfg = vk.config
    lb = cfg.fri.log_blowup
    ch = DuplexChallenger()

    per_air = proof.per_air
    air_ids = [p.air_id for p in per_air]
    vks = [vk.per_air[a] for a in air_ids]
    num_airs = len(per_air)

    # ---- preamble ------------------------------------------------------
    ch.observe_slice(vk.pre_hash)
    ch.observe(num_airs)
    for a in air_ids:
        ch.observe(a)

    # cumulative sums sum to zero
    if vk.num_phases:
        total = nx.from_base(0)
        for p in per_air:
            for phase_vals in p.exposed_values_after_challenge:
                for v in phase_vals:
                    total = nx.nadd(total, _ext(v))
        _check(not total.any(), "cumulative sums do not vanish")

    # air_perm_by_height is a perm, decreasing by height
    perm = proof.air_perm_by_height
    _check(sorted(perm) == list(range(num_airs)), "invalid air perm")
    last = MAX_TWO_ADICITY - lb
    for i in perm:
        _check(per_air[i].log_degree <= last, "air heights not sorted")
        last = per_air[i].log_degree
    log_max = per_air[perm[0]].log_degree

    # trace height constraints
    for c in vk.trace_height_constraints:
        total_h = 0
        for p in per_air:
            total_h += int(c.coefficients[p.air_id]) * (1 << p.log_degree)
        _check(total_h < c.threshold, "trace height constraint violated")

    for p, avk in zip(per_air, vks):
        _check(len(p.public_values) == avk.num_public_values, "pv shape")
        ch.observe_slice(np.asarray(p.public_values, dtype=np.uint64))
    for avk in vks:
        if avk.preprocessed_commit is not None:
            ch.observe_slice(avk.preprocessed_commit)

    num_cached = sum(len(avk.widths.cached_mains) for avk in vks)
    _check(len(proof.commitments.main_trace) == num_cached + 1,
           "main commit count")
    for commit in proof.commitments.main_trace:
        ch.observe_slice(commit)
    for p in per_air:
        ch.observe(p.log_degree)

    # ---- LogUp phase ---------------------------------------------------
    challenges = []
    if vk.num_phases:
        _check(ch.check_witness(cfg.log_up_pow_bits,
                                proof.log_up_pow_witness),
               "logup pow witness")
        challenges = [_ext(ch.sample_ext()), _ext(ch.sample_ext())]
        for p, avk in zip(per_air, vks):
            if avk.num_exposed:
                vals = p.exposed_values_after_challenge[0]
                _check(len(vals) == avk.num_exposed, "exposed shape")
                for v in vals:
                    ch.observe_ext(np.asarray(v, dtype=np.uint64))
        _check(len(proof.commitments.after_challenge) == 1,
               "after-challenge commit count")
        ch.observe_slice(proof.commitments.after_challenge[0])
    else:
        _check(len(proof.commitments.after_challenge) == 0, "no phase")

    alpha = _ext(ch.sample_ext())
    ch.observe_slice(proof.commitments.quotient)
    zeta = _ext(ch.sample_ext())

    # ---- build rounds (commit, mats:[(log_lde, width, points, values)]) --
    vals = proof.opening.values
    rounds = []
    prep_idx = 0
    for i, avk in enumerate(vks):
        if avk.preprocessed_commit is not None:
            ao = vals.preprocessed[prep_idx]
            prep_idx += 1
            w = avk.widths.preprocessed
            _check(len(ao.local) == w and len(ao.next) == w, "prep width")
            rounds.append((avk.preprocessed_commit,
                           [(per_air[i].log_degree + lb, w,
                             _points(i, per_air, zeta), [ao.local, ao.next])]))
    commit_idx = 0
    for i, avk in enumerate(vks):
        for w in avk.widths.cached_mains:
            ao = vals.main[commit_idx][0]
            _check(len(ao.local) == w and len(ao.next) == w, "cached width")
            rounds.append((proof.commitments.main_trace[commit_idx],
                           [(per_air[i].log_degree + lb, w,
                             _points(i, per_air, zeta), [ao.local, ao.next])]))
            commit_idx += 1
    common_mats = []
    cm_idx = 0
    for i, avk in enumerate(vks):
        w = avk.widths.common_main
        if w:
            ao = vals.main[num_cached][cm_idx]
            cm_idx += 1
            _check(len(ao.local) == w and len(ao.next) == w, "common width")
            common_mats.append((per_air[i].log_degree + lb, w,
                                _points(i, per_air, zeta),
                                [ao.local, ao.next]))
    rounds.append((proof.commitments.main_trace[num_cached], common_mats))
    if vk.num_phases:
        ac_mats = []
        ac_idx = 0
        for i, avk in enumerate(vks):
            if avk.widths.after_challenge:
                ao = vals.after_challenge[0][ac_idx]
                ac_idx += 1
                w = 4 * avk.widths.after_challenge
                _check(len(ao.local) == w and len(ao.next) == w, "perm width")
                ac_mats.append((per_air[i].log_degree + lb, w,
                                _points(i, per_air, zeta),
                                [ao.local, ao.next]))
        rounds.append((proof.commitments.after_challenge[0], ac_mats))
    q_mats = []
    for i, avk in enumerate(vks):
        chunks = vals.quotient[i]
        _check(len(chunks) == avk.quotient_degree, "quotient chunk count")
        for chunk in chunks:
            _check(len(chunk) == 4, "quotient chunk width")
            q_mats.append((per_air[i].log_degree + lb, 4, [zeta], [chunk]))
    rounds.append((proof.commitments.quotient, q_mats))

    # ---- FRI verification ---------------------------------------------
    _verify_pcs(cfg, rounds, proof.opening.proof, log_max + lb, ch)

    # ---- per-air constraint checks at zeta -----------------------------
    prep_idx = 0
    commit_idx = 0
    cm_idx = 0
    ac_idx = 0
    for i, (p, avk) in enumerate(zip(per_air, vks)):
        prep_pair = None
        if avk.preprocessed_commit is not None:
            ao = vals.preprocessed[prep_idx]
            prep_idx += 1
            prep_pair = ([_ext(v) for v in ao.local],
                         [_ext(v) for v in ao.next])
        mains = []
        for _ in avk.widths.cached_mains:
            ao = vals.main[commit_idx][0]
            commit_idx += 1
            mains.append(([_ext(v) for v in ao.local],
                          [_ext(v) for v in ao.next]))
        if avk.widths.common_main:
            ao = vals.main[num_cached][cm_idx]
            cm_idx += 1
            mains.append(([_ext(v) for v in ao.local],
                          [_ext(v) for v in ao.next]))
        perm_pair = None
        if avk.widths.after_challenge:
            ao = vals.after_challenge[0][ac_idx]
            ac_idx += 1
            # unflatten: ext value j = sum_c flat[4j+c] * x^c  (monomial basis)
            def unflatten(flat):
                out = []
                for j in range(len(flat) // 4):
                    acc = nx.from_base(0)
                    for c2 in range(4):
                        mono = np.eye(4, dtype=np.uint64)[c2]
                        acc = nx.nadd(acc, nx.nmul(_ext(flat[4 * j + c2]), mono))
                    out.append(acc)
                return out
            perm_pair = (unflatten(ao.local), unflatten(ao.next))

        _verify_air_constraints(
            cfg, avk, p, prep_pair, mains, perm_pair, challenges,
            vals.quotient[i], zeta, alpha)


def _points(i, per_air, zeta):
    g_n = bb.two_adic_generator_int(per_air[i].log_degree)
    zeta_next = nx.nmul_base(zeta, g_n)
    return [zeta, zeta_next]


def _verify_pcs(cfg, rounds, fri_proof: fri_mod.FriProof, log_max_lde: int,
                ch: DuplexChallenger) -> None:
    lb = cfg.fri.log_blowup
    # observe all opened values
    for _, mats in rounds:
        for (_lh, _w, _pts, values) in mats:
            for value_row in values:
                for v in value_row:
                    ch.observe_ext(np.asarray(v, dtype=np.uint64))
    alpha = _ext(ch.sample_ext())

    _check(len(fri_proof.query_proofs) == cfg.fri.num_queries, "num queries")
    _check(len(fri_proof.commit_phase_commits) == log_max_lde - lb,
           "commit phase count")
    betas = []
    for commit in fri_proof.commit_phase_commits:
        ch.observe_slice(np.asarray(commit, dtype=np.uint64))
        betas.append(tuple(ch.sample_ext()))
    _check(len(fri_proof.final_poly) == 1, "final poly len")
    ch.observe_ext(np.asarray(fri_proof.final_poly[0], dtype=np.uint64))
    _check(ch.check_witness(cfg.fri.proof_of_work_bits,
                            fri_proof.pow_witness), "fri pow")

    # ---- batched query verification (vectorized over the query axis;
    # semantics identical to per-query scalar checks) ---------------------
    nq = cfg.fri.num_queries
    indices = np.asarray([ch.sample_bits(log_max_lde) for _ in range(nq)],
                         dtype=np.int64)
    for qp in fri_proof.query_proofs:
        _check(len(qp.input_proof) == len(rounds), "input proof len")

    # precompute alpha powers up to the max width (ext, canonical)
    max_w = max(w for (_, mats) in rounds for (_, w, _, _) in mats)
    apows = np.zeros((max_w + 1, 4), dtype=np.uint64)
    cur = nx.from_base(1)
    for t in range(max_w + 1):
        apows[t] = cur
        cur = nx.nmul(cur, alpha)

    ro = {}
    alpha_pow = {}
    for ri, (commit, mats) in enumerate(rounds):
        batch_max = max(lh for (lh, _, _, _) in mats)
        reduced_index = indices >> (log_max_lde - batch_max)
        opened_rows_q = []
        for mi, (lh, w, pts, values) in enumerate(mats):
            _check(all(len(qp.input_proof[ri].opened_values) == len(mats)
                       and len(qp.input_proof[ri].opened_values[mi]) == w
                       for qp in fri_proof.query_proofs), "row width")
            rows = np.asarray(
                [qp.input_proof[ri].opened_values[mi]
                 for qp in fri_proof.query_proofs], dtype=np.uint64)
            opened_rows_q.append(rows % P)
            row_idx = indices >> (log_max_lde - lh)
            rev = nx.rev_bits_arr(row_idx, lh)
            x = (bb.GENERATOR
                 * nx.npow_base_varexp(
                     bb.two_adic_generator_int(lh), rev)) % P  # (Q,)
            cur_ro = ro.setdefault(lh, np.zeros((nq, 4), dtype=np.uint64))
            cur_ap = alpha_pow.setdefault(lh, nx.from_base(1))
            for z, ps_at_z in zip(pts, values):
                vals = np.asarray([tuple(v) for v in ps_at_z],
                                  dtype=np.uint64) % P       # (w, 4)
                diff = nx.nsub(vals[None, :, :],
                               nx.from_base(rows % P))       # (Q, w, 4)
                prod = nx.nmul(np.broadcast_to(apows[None, :w, :],
                                               (nq, w, 4)), diff)
                n_acc = (prod.sum(axis=1) % P)               # (Q, 4)
                z_arr = np.asarray(z, dtype=np.uint64)[None, :] % P
                quot = nx.nmul(n_acc, nx.ninv(
                    nx.nsub(np.broadcast_to(z_arr, (nq, 4)),
                            nx.from_base(x))))
                cap = np.asarray(cur_ap, dtype=np.uint64)[None, :]
                cur_ro = nx.nadd(cur_ro, nx.nmul(
                    np.broadcast_to(cap, (nq, 4)), quot))
                cur_ap = nx.nmul(cur_ap, apows[w])
            ro[lh] = cur_ro
            alpha_pow[lh] = cur_ap
        dims = [(1 << lh, w) for (lh, w, _, _) in mats]
        depth = len(fri_proof.query_proofs[0].input_proof[ri].opening_proof)
        _check(all(len(qp.input_proof[ri].opening_proof) == depth
                   for qp in fri_proof.query_proofs), "path depth")
        proofs_q = [np.asarray(
            [qp.input_proof[ri].opening_proof[lv]
             for qp in fri_proof.query_proofs], dtype=np.uint64)
            for lv in range(depth)]
        ok = merkle.verify_batch_queries(
            np.asarray(commit, dtype=np.uint64), dims, reduced_index,
            opened_rows_q, proofs_q)
        _check(bool(np.all(ok)), "batch opening invalid")

    steps_per_query = [qp.commit_phase_openings
                       for qp in fri_proof.query_proofs]
    try:
        ok = fri_mod.verify_queries_host(
            cfg, fri_proof.commit_phase_commits, indices,
            steps_per_query, betas, ro, log_max_lde,
            fri_proof.final_poly[0])
    except (ValueError, IndexError):
        # ragged/truncated proof structures surface as numpy shape errors
        # deep in the batched paths — a malformed proof is just invalid
        ok = False
    _check(bool(np.all(ok)), "fri query invalid")


def _verify_air_constraints(cfg, avk, p, prep_pair, mains, perm_pair,
                            challenges, quotient_chunks, zeta, alpha) -> None:
    log_n = p.log_degree
    n = 1 << log_n
    g_n = bb.two_adic_generator_int(log_n)

    # selectors at zeta (trace domain shift = 1)
    z_n = _ext_pow(zeta, n)
    one = nx.from_base(1)
    z_h = nx.nsub(z_n, one)
    first = nx.nmul(z_h, nx.ninv(nx.nsub(zeta, one)))
    g_inv = nx.from_base(pow(g_n, -1, P))
    last = nx.nmul(z_h, nx.ninv(nx.nsub(zeta, g_inv)))
    trans = nx.nsub(zeta, g_inv)
    inv_zeroifier = nx.ninv(z_h)

    env = {
        "main": mains,
        "preprocessed": prep_pair,
        "perm": perm_pair,
        "publics": [int(v) for v in p.public_values],
        "challenges": challenges,
        "exposed": [_ext(v) for v in
                    (p.exposed_values_after_challenge[0]
                     if p.exposed_values_after_challenge else [])],
        "sels": {"is_first_row": first, "is_last_row": last,
                 "is_transition": trans},
    }
    vals = avk.dag.eval(HostOps, env)
    acc = nx.from_base(0)
    for root in avk.dag.constraint_roots:
        acc = nx.nadd(nx.nmul(acc, alpha), vals[root])
    folded = nx.nmul(acc, inv_zeroifier)

    # recompute quotient(zeta) from chunks
    lqd = avk.log_quotient_degree
    num_chunks = 1 << lqd
    log_q = log_n + lqd
    w_q = bb.two_adic_generator_int(log_q)
    # chunk domain i: shift g * w_q^i, size n
    zps = []
    for i in range(num_chunks):
        acc_zp = one
        for j in range(num_chunks):
            if j == i:
                continue
            s_j = (bb.GENERATOR * pow(w_q, j, P)) % P
            # Z_j(x) = (x / s_j)^n - 1
            zp_zeta = nx.nsub(_ext_pow(nx.nmul_base(zeta, pow(s_j, -1, P)), n),
                              one)
            s_i = (bb.GENERATOR * pow(w_q, i, P)) % P
            first_point = nx.from_base(s_i)
            zp_first = nx.nsub(
                _ext_pow(nx.nmul_base(first_point, pow(s_j, -1, P)), n), one)
            acc_zp = nx.nmul(acc_zp, nx.nmul(zp_zeta, nx.ninv(zp_first)))
        zps.append(acc_zp)

    quotient = nx.from_base(0)
    for i, chunk in enumerate(quotient_chunks):
        inner = nx.from_base(0)
        for e_i, c in enumerate(chunk):
            mono = np.eye(4, dtype=np.uint64)[e_i]
            inner = nx.nadd(inner, nx.nmul(mono, _ext(c)))
        quotient = nx.nadd(quotient, nx.nmul(zps[i], inner))

    _check(np.array_equal(folded, quotient),
           f"constraint check failed for air {avk.name}")
