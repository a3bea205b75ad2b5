"""StarkVerifier as a generated native-VM program.

Copy of openvm_tpu/native_compiler/verifier_program.py:1-936
(``serialize_proof_felts`` :41 and ``_round_shapes`` :105, ``ProgramOps``
:141, ``_emit_verify`` :209, ``build_verifier_program`` :655,
``build_leaf_program`` :694, ``build_internal_program`` :703,
``build_root_program`` :813 and ``static_height_profile`` :871) on the
port's Builder, challenger, ``field.babybear`` and ``vm.instructions``.
Every program it builds equals the JAX package's word for word but in
each PERM_POS2's e operand: the port's ``ProgramChallenger`` duplexes with
e = 4 (builder.py's docstring), so the port can prove its programs.  The
serializer reads the port's ``Proof`` (stark/prover.py), whose
commitments, opened values and FRI proof are canonical ints.

TPU-native counterpart of the reference recursive verifier
(reference extensions/native/recursion/src/stark/mod.rs StarkVerifier::verify
+ fri/two_adic_pcs.rs + fri/mod.rs verify_query + the challenger port).
Where the reference compiles one dynamic program through its eDSL, this
generator emits a straight-line native program **specialized to a proof
shape** (vk + per-AIR log_degrees): every loop bound, matrix width and
Merkle depth is static, so the challenger schedule compiles away
(`ProgramChallenger`) and the constraint DAG is lowered node-by-node to
FieldExtension instructions.

The host serializer `serialize_proof_felts` and the program reader consume
the proof in the same literal order; `openvm_tpu_torch/stark/verifier.py`
is the semantic spec (the generated program mirrors it check for check).

Program public values (VmVerifierPvs role, reference
crates/continuations/src/verifier/common/types.rs):
  pv[0..8]  = app program commitment (cached main commit 0)
  pv[8..12] = app connector public values [init_pc, final_pc, exit, is_term]
  pv[12..28] = app memory-merkle public values (persistent shapes only)
"""

from __future__ import annotations

import numpy as np

from ..field import babybear as bb
from .builder import Builder, Ext, Felt, FeltArray
from .challenger import ProgramChallenger, bits_to_index

P = bb.P
MAX_TWO_ADICITY = 27


# ---------------------------------------------------------------------------
# Host-side proof serialization (must match the program's read order)
# ---------------------------------------------------------------------------


def serialize_proof_felts(vk, proof) -> list:
    """Proof -> list of felt vectors (the VM input stream).

    One vector per program-side `read_vec` call, in identical order — the
    reference's Hintable::write role (recursion/src/hints.rs)."""
    out: list[list[int]] = []

    def put(vals):
        out.append([int(v) % P
                    for v in np.asarray(vals, dtype=object).reshape(-1)])

    per_air = proof.per_air
    vks = [vk.per_air[p.air_id] for p in per_air]
    for p, avk in zip(per_air, vks):
        if avk.num_public_values:
            put(p.public_values)
    if vk.num_phases:
        for p, avk in zip(per_air, vks):
            if avk.num_exposed:
                for v in p.exposed_values_after_challenge[0]:
                    put(v)
    for commit in proof.commitments.main_trace:
        put(commit)
    put([proof.log_up_pow_witness])
    if vk.num_phases:
        put(proof.commitments.after_challenge[0])
    put(proof.commitments.quotient)

    vals = proof.opening.values
    for ao in vals.preprocessed:
        put(ao.local), put(ao.next)
    for mats in vals.main:
        for ao in mats:
            put(ao.local), put(ao.next)
    for phase in vals.after_challenge:
        for ao in phase:
            put(ao.local), put(ao.next)
    for chunks in vals.quotient:
        for chunk in chunks:
            put([c for v in chunk for c in v])

    fp = proof.opening.proof
    for commit in fp.commit_phase_commits:
        put(commit)
    put(fp.final_poly[0])
    put([fp.pow_witness])
    round_lhs = _round_shapes(vk, [p.log_degree for p in per_air])
    for qp in fp.query_proofs:
        for batch, lhs in zip(qp.input_proof, round_lhs):
            # rows grouped by height (desc), one vector per height group
            # (mirrors the generator's VERIFY_BATCH segment layout)
            groups: dict = {}
            for lh, row in zip(lhs, batch.opened_values):
                groups.setdefault(lh, []).append(row)
            for lh in sorted(groups, reverse=True):
                put([v for row in groups[lh] for v in row])
            # all sibling digests of the batch as one vector
            put([v for sib in batch.opening_proof for v in sib])
        for step in qp.commit_phase_openings:
            put(step.sibling_value)
            put([v for sib in step.opening_proof for v in sib])
    return out


def _round_shapes(vk, log_degrees: list) -> list:
    """Per commitment round, the LDE log-height of each opened matrix in
    mats order (must mirror _emit_verify's rounds construction — the
    serializer groups opened rows by height exactly as the generator's
    VERIFY_BATCH segment buffers do)."""
    lb = vk.config.fri.log_blowup
    per_vk = vk.per_air
    rounds = []
    for i, avk in enumerate(per_vk):
        if avk.preprocessed_commit is not None:
            rounds.append([log_degrees[i] + lb])
    for i, avk in enumerate(per_vk):
        for _w in avk.widths.cached_mains:
            rounds.append([log_degrees[i] + lb])
    rounds.append([log_degrees[i] + lb for i, avk in enumerate(per_vk)
                   if avk.widths.common_main])
    if vk.num_phases:
        rounds.append([log_degrees[i] + lb for i, avk in enumerate(per_vk)
                       if avk.widths.after_challenge])
    qround = []
    for i, avk in enumerate(per_vk):
        qround.extend([log_degrees[i] + lb] * avk.quotient_degree)
    rounds.append(qround)
    return rounds


# ---------------------------------------------------------------------------
# In-program helpers
# ---------------------------------------------------------------------------


def _ext_cells(b: Builder, arr: FeltArray, j: int) -> Ext:
    """View 4 cells of a hinted array as an Ext."""
    return Ext(arr.addr + 4 * j)


class ProgramOps:
    """SymbolicDag eval backend emitting FieldExtension instructions."""

    def __init__(self, b: Builder):
        self.b = b
        self._consts: dict = {}

    def const(self, v: int):
        v = int(v) % P
        if v not in self._consts:
            self._consts[v] = self.b.econst((v, 0, 0, 0))
        return self._consts[v]

    def var(self, env, entry, part, offset, index):
        if entry == "main":
            return env["main"][part][offset][index]
        if entry == "preprocessed":
            return env["preprocessed"][offset][index]
        if entry == "permutation":
            return env["perm"][offset][index]
        if entry == "public":
            return env["publics"][index]
        if entry == "challenge":
            return env["challenges"][index]
        if entry == "exposed":
            return env["exposed"][index]
        raise KeyError(entry)

    def sel(self, env, which):
        return env["sels"][which]

    def add(self, a, b_):
        return self.b.eadd(a, b_)

    def sub(self, a, b_):
        return self.b.esub(a, b_)

    def mul(self, a, b_):
        return self.b.emul(a, b_)

    def neg(self, a):
        return self.b.esub(self.const(0), a)


def _epow(b: Builder, x: Ext, e: int) -> Ext:
    """x^e by square-and-multiply (static exponent)."""
    assert e >= 1
    if e == 1:
        return x
    h = _epow(b, x, e // 2)
    sq = b.emul(h, h)
    return b.emul(sq, x) if e % 2 else sq


def _promote(b: Builder, f) -> Ext:
    """Felt|int -> Ext (f, 0, 0, 0)."""
    e = b.ext()
    b.mov(f, Felt(e.addr))
    for i in (1, 2, 3):
        b.mov(0, Felt(e.addr + i))
    return e


# ---------------------------------------------------------------------------
# The generator
# ---------------------------------------------------------------------------


def _emit_verify(b: Builder, vk, log_degrees: list):
    """Emit the full STARK verification of one proof into `b`.

    The proof is consumed from the hint stream in serialize_proof_felts
    order.  Returns {"main_commits": [FeltArray(8)], "pvs": [FeltArray]}
    handles for the caller (pv chaining / exposure).  Reaching the emitted
    code's end means the proof verified; any check failure branches to the
    program's shared fail block.
    """
    cfg = vk.config
    lb = cfg.fri.log_blowup
    per_vk = vk.per_air
    n_airs = len(per_vk)
    assert len(log_degrees) == n_airs
    log_max = max(log_degrees)
    log_max_lde = log_max + lb

    # static shape checks (mirror verifier.verify's perm/height checks)
    order = sorted(range(n_airs), key=lambda i: -log_degrees[i])
    assert log_degrees[order[0]] <= MAX_TWO_ADICITY - lb
    for c in vk.trace_height_constraints:
        total = sum(int(c.coefficients[i]) * (1 << log_degrees[i])
                    for i in range(n_airs))
        assert total < c.threshold, "trace height constraint violated"

    ch = ProgramChallenger(b)

    # ---- read proof fields in serialize order -------------------------
    pvs = [b.read_vec(avk.num_public_values) if avk.num_public_values
           else FeltArray(0, 0) for avk in per_vk]
    exposed = [b.read_vec(4) if (vk.num_phases and avk.num_exposed)
               else None for avk in per_vk]
    num_cached = sum(len(avk.widths.cached_mains) for avk in per_vk)
    main_commits = [b.read_vec(8) for _ in range(num_cached + 1)]
    logup_pow = b.read_vec(1)
    ac_commit = b.read_vec(8) if vk.num_phases else None
    q_commit = b.read_vec(8)

    prep_vals = []  # (local FeltArray, next FeltArray) per air-with-prep
    for avk in per_vk:
        if avk.preprocessed_commit is not None:
            w = avk.widths.preprocessed
            prep_vals.append((b.read_vec(4 * w), b.read_vec(4 * w)))
    main_vals = []  # per main commit: [(local, next)] per mat
    for avk in per_vk:
        for w in avk.widths.cached_mains:
            main_vals.append([(b.read_vec(4 * w), b.read_vec(4 * w))])
    common_list = []
    for avk in per_vk:
        w = avk.widths.common_main
        if w:
            common_list.append((b.read_vec(4 * w), b.read_vec(4 * w)))
    main_vals.append(common_list)
    ac_vals = []
    if vk.num_phases:
        for avk in per_vk:
            if avk.widths.after_challenge:
                w4 = 4 * avk.widths.after_challenge
                ac_vals.append((b.read_vec(4 * w4), b.read_vec(4 * w4)))
    q_vals = []  # per air: [chunk FeltArray(16)] per chunk
    for avk in per_vk:
        q_vals.append([b.read_vec(16)
                       for _ in range(avk.quotient_degree)])

    num_fri_commits = log_max_lde - lb
    fri_commits = [b.read_vec(8) for _ in range(num_fri_commits)]
    final_poly = b.read_vec(4)
    fri_pow = b.read_vec(1)

    # ---- transcript preamble ------------------------------------------
    for v in np.asarray(vk.pre_hash).reshape(-1):
        ch.observe(int(v))
    ch.observe(n_airs)
    for i in range(n_airs):
        ch.observe(i)

    # cumulative sums vanish
    if vk.num_phases:
        total = b.econst((0, 0, 0, 0))
        for e in exposed:
            if e is not None:
                total = b.eadd(total, Ext(e.addr))
        for i in range(4):
            b.assert_eq(total.felt(i), 0)

    for arr in pvs:
        ch.observe_arr(arr)
    for avk in per_vk:
        if avk.preprocessed_commit is not None:
            for v in np.asarray(avk.preprocessed_commit).reshape(-1):
                ch.observe(int(v))
    for commit in main_commits:
        ch.observe_arr(commit)
    for ld in log_degrees:
        ch.observe(ld)

    challenges = []
    if vk.num_phases:
        ch.check_witness(cfg.log_up_pow_bits, logup_pow.felt(0))
        challenges = [ch.sample_ext(), ch.sample_ext()]
        for e in exposed:
            if e is not None:
                ch.observe_arr(e)
        ch.observe_arr(ac_commit)

    alpha = ch.sample_ext()
    ch.observe_arr(q_commit)
    zeta = ch.sample_ext()

    # ---- rounds (commit, mats=[(log_lde, w, pts, values)]) -------------
    # pts: list of Ext points; values: list of FeltArray (4w) per point
    g_pows = {}

    def zeta_next(i):
        if i not in g_pows:
            g = bb.two_adic_generator_int(log_degrees[i])
            g_pows[i] = b.emul_felt(zeta, g)
        return g_pows[i]

    rounds = []
    pi = 0
    for i, avk in enumerate(per_vk):
        if avk.preprocessed_commit is not None:
            loc, nxt = prep_vals[pi]
            pi += 1
            commit_arr = b.array(8)
            for k, v in enumerate(np.asarray(avk.preprocessed_commit)
                                  .reshape(-1)):
                b.mov(int(v), commit_arr.felt(k))
            rounds.append((commit_arr,
                           [(log_degrees[i] + lb, avk.widths.preprocessed,
                             [zeta, zeta_next(i)], [loc, nxt])]))
    ci = 0
    for i, avk in enumerate(per_vk):
        for w in avk.widths.cached_mains:
            loc, nxt = main_vals[ci][0]
            rounds.append((main_commits[ci],
                           [(log_degrees[i] + lb, w,
                             [zeta, zeta_next(i)], [loc, nxt])]))
            ci += 1
    common_mats = []
    cmi = 0
    for i, avk in enumerate(per_vk):
        if avk.widths.common_main:
            loc, nxt = main_vals[num_cached][cmi]
            cmi += 1
            common_mats.append((log_degrees[i] + lb, avk.widths.common_main,
                                [zeta, zeta_next(i)], [loc, nxt]))
    rounds.append((main_commits[num_cached], common_mats))
    if vk.num_phases:
        ac_mats = []
        aci = 0
        for i, avk in enumerate(per_vk):
            if avk.widths.after_challenge:
                loc, nxt = ac_vals[aci]
                aci += 1
                ac_mats.append((log_degrees[i] + lb,
                                4 * avk.widths.after_challenge,
                                [zeta, zeta_next(i)], [loc, nxt]))
        rounds.append((ac_commit, ac_mats))
    q_mats = []
    for i, avk in enumerate(per_vk):
        for chunk in q_vals[i]:
            q_mats.append((log_degrees[i] + lb, 4, [zeta], [chunk]))
    rounds.append((q_commit, q_mats))

    # ---- FRI verification ---------------------------------------------
    # observe all opened values
    for _, mats in rounds:
        for (_lh, _w, _pts, values) in mats:
            for arr in values:
                ch.observe_arr(arr)
    fri_alpha = ch.sample_ext()
    betas = []
    for commit in fri_commits:
        ch.observe_arr(commit)
        betas.append(ch.sample_ext())
    ch.observe_arr(final_poly)
    ch.check_witness(cfg.fri.proof_of_work_bits, fri_pow.felt(0))

    # alpha-power ladder (query independent; only w-th powers are needed
    # for the per-height alpha_pow bookkeeping — the per-mat reduced
    # openings are single FRI_REDUCED_OPENING instructions)
    max_w = max((w for (_, mats) in rounds for (_, w, _, _) in mats),
                default=0)
    apows = [b.econst((1, 0, 0, 0))]
    for _ in range(max_w):
        apows.append(b.emul(apows[-1], fri_alpha))

    # pre-allocated per-round opening buffers + VERIFY_BATCH descriptors
    # (reused by every query — descriptors are static per call site).
    # Rows of one height group live in ONE contiguous buffer so the whole
    # batch opening is a single VERIFY_BATCH instruction; serializer
    # groups identically (serialize_proof_felts).
    round_bufs = []
    for (commit, mats) in rounds:
        batch_max = max(lh for (lh, _, _, _) in mats)
        groups: dict = {}
        for m, (lh, w, _, _) in enumerate(mats):
            groups.setdefault(lh, []).append(m)
        garrs = {}
        row_slices = [None] * len(mats)
        segs = {}
        total_inside = 0
        for lh in sorted(groups, reverse=True):
            tot = sum(mats[m][1] for m in groups[lh])
            arr = b.array(tot)
            garrs[lh] = arr
            off = 0
            for m in groups[lh]:
                row_slices[m] = arr.slice(off, mats[m][1])
                off += mats[m][1]
            segs[batch_max - lh] = (arr.addr, tot)
            total_inside += (tot + 7) // 8
        desc = b.write_batch_descriptor(segs, batch_max)
        sib_buf = b.array(8 * batch_max)
        round_bufs.append((batch_max, garrs, row_slices, desc, sib_buf,
                           total_inside))
    fold_bufs = []
    for i in range(num_fri_commits):
        log_folded = log_max_lde - i - 1
        pair = b.array(8)  # (e0 || e1) of the fold check
        path = b.array(8 * log_folded)
        fdesc = b.write_batch_descriptor({0: (pair.addr, 8)}, log_folded)
        fold_bufs.append((pair, path, fdesc))

    two_adic = {}

    def w_pows_desc(lh):
        """[w^{2^{lh-1}}, ..., w^2, w] canonical ints for bit-rev powering."""
        if lh not in two_adic:
            wg = bb.two_adic_generator_int(lh)
            pows = []
            for j in range(lh):
                pows.append(pow(wg, 1 << (lh - 1 - j), P))
            two_adic[lh] = pows
        return two_adic[lh]

    gen_inv = pow(bb.GENERATOR, -1, P)
    needed_lhs = sorted({lh for (_, mats) in rounds
                         for (lh, _, _, _) in mats})
    for _q in range(cfg.fri.num_queries):
        index_bits = ch.sample_bits(log_max_lde)  # canonical 31 bits
        with b.scope():
            # domain point per height, ONCE per query: x(log_max_lde) =
            # GEN * w^{bitrev(idx)} by bit-select products, then each
            # lower height by squaring — x(lh-1) = x(lh)^2 / GEN (the
            # top two-adic factor has order 2^lh so it vanishes when
            # squared; same trick as p3's fri fold domains)
            x_cur = b.mov(bb.GENERATOR)
            for j, wp in enumerate(w_pows_desc(log_max_lde)):
                bit = index_bits.felt(j)
                # bit ? wp : 1  ==  1 + bit*(wp-1)
                x_cur = b.mul(x_cur, b.add(b.mul(bit, (wp - 1) % P), 1))
            x_exts = {log_max_lde: _promote(b, x_cur)}
            for lh in range(log_max_lde - 1, needed_lhs[0] - 1, -1):
                x_cur = b.mul(b.mul(x_cur, x_cur), gen_inv)
                if lh in needed_lhs:
                    x_exts[lh] = _promote(b, x_cur)
            ro = {}
            alpha_pow = {}
            for r, (commit, mats) in enumerate(rounds):
                (batch_max, garrs, rows, desc, sib_buf,
                 total_inside) = round_bufs[r]
                for lh in sorted(garrs, reverse=True):
                    b.read_vec_into(garrs[lh])
                b.read_vec_into(sib_buf)
                for m, ((lh, w, pts, values), row) in enumerate(
                        zip(mats, rows)):
                    cur_ro = ro.get(lh)
                    if cur_ro is None:
                        cur_ro = b.econst((0, 0, 0, 0))
                        alpha_pow[lh] = b.econst((1, 0, 0, 0))
                    x_ext = x_exts[lh]
                    for pz, z in enumerate(pts):
                        # sum_t alpha^t (p_t(z) - row_t) as ONE instruction
                        n_acc = b.fri_reduced_opening(
                            row, values[pz], w, fri_alpha)
                        quot = b.ediv(n_acc, b.esub(z, x_ext))
                        cur_ro = b.eadd(cur_ro,
                                        b.emul(alpha_pow[lh], quot))
                        alpha_pow[lh] = b.emul(alpha_pow[lh], apows[w])
                    ro[lh] = cur_ro
                # whole batch Merkle opening as ONE instruction
                b.verify_batch(desc, sib_buf,
                               index_bits.addr + (log_max_lde - batch_max),
                               commit.addr, batch_max, total_inside)

            # fri fold phase
            folded = ro[log_max_lde]
            for i in range(num_fri_commits):
                log_folded = log_max_lde - i - 1
                bit = index_bits.felt(i)
                sib_val = b.read_vec(4)
                pair, path, fdesc = fold_bufs[i]
                b.read_vec_into(path)
                e0, e1 = Ext(pair.addr), Ext(pair.addr + 4)
                swap, endl = b.label(), b.label()
                b.branch_ne(bit, 0, swap)
                for k in range(4):
                    b.mov(folded.felt(k), Felt(e0.addr + k))
                    b.mov(sib_val.felt(k), Felt(e1.addr + k))
                b.jump(endl)
                b.place(swap)
                for k in range(4):
                    b.mov(sib_val.felt(k), Felt(e0.addr + k))
                    b.mov(folded.felt(k), Felt(e1.addr + k))
                b.place(endl)
                # pair-row commitment check as ONE instruction
                b.verify_batch(fdesc, path, index_bits.addr + i + 1,
                               fri_commits[i].addr, log_folded, 1)
                # y0 = w_{2^{log_folded+1}}^{bitrev(idx_level>>1)}:
                # computed by bit-select products at the FIRST fold level,
                # then derived by squaring: y0_{i+1} = y0_i^2 * (-1)^bit
                # (the dropped top factor has order 2, unlike the shifted
                # x chain above)
                if log_folded == 0:
                    y0 = b.mov(1)
                elif i == 0:
                    y0 = b.mov(1)
                    for j, wp in enumerate(w_pows_desc(log_folded + 1)[1:]):
                        pbit = index_bits.felt(i + 1 + j)
                        y0 = b.mul(y0, b.add(b.mul(pbit, (wp - 1) % P), 1))
                else:
                    sgn = b.sub(1, b.mul(index_bits.felt(i), 2))
                    y0 = b.mul(b.mul(y0, y0), sgn)
                xs0 = _promote(b, y0)
                xs1 = _promote(b, b.sub(0, y0))
                num = b.emul(b.esub(betas[i], xs0), b.esub(e1, e0))
                folded = b.eadd(e0, b.ediv(num, b.esub(xs1, xs0)))
                ro_l = ro.get(log_folded)
                if ro_l is not None:
                    beta_sq = b.emul(betas[i], betas[i])
                    folded = b.eadd(folded, b.emul(beta_sq, ro_l))
            b.assert_eq_arr(FeltArray(folded.addr, 4), final_poly)

    # ---- per-air constraint checks at zeta -----------------------------
    pi = ci = cmi = aci = 0
    one_ext = b.econst((1, 0, 0, 0))
    for i, avk in enumerate(per_vk):
        with b.scope():
            ops = ProgramOps(b)
            log_n = log_degrees[i]
            n = 1 << log_n
            g_n = bb.two_adic_generator_int(log_n)
            z_n = _epow(b, zeta, n)
            z_h = b.esub(z_n, one_ext)
            first = b.ediv(z_h, b.esub(zeta, one_ext))
            g_inv = pow(g_n, -1, P)
            gi_ext = ops.const(g_inv)
            last = b.ediv(z_h, b.esub(zeta, gi_ext))
            trans = b.esub(zeta, gi_ext)

            prep_pair = None
            if avk.preprocessed_commit is not None:
                loc, nxt = prep_vals[pi]
                pi += 1
                prep_pair = (
                    [_ext_cells(b, loc, t)
                     for t in range(avk.widths.preprocessed)],
                    [_ext_cells(b, nxt, t)
                     for t in range(avk.widths.preprocessed)])
            mains = []
            for w in avk.widths.cached_mains:
                loc, nxt = main_vals[ci][0]
                ci += 1
                mains.append(([_ext_cells(b, loc, t) for t in range(w)],
                              [_ext_cells(b, nxt, t) for t in range(w)]))
            if avk.widths.common_main:
                loc, nxt = main_vals[num_cached][cmi]
                cmi += 1
                w = avk.widths.common_main
                mains.append(([_ext_cells(b, loc, t) for t in range(w)],
                              [_ext_cells(b, nxt, t) for t in range(w)]))
            perm_pair = None
            if avk.widths.after_challenge:
                loc, nxt = ac_vals[aci]
                aci += 1
                wp_ = avk.widths.after_challenge
                monos = [b.econst(tuple(1 if t == c2 else 0
                                        for t in range(4)))
                         for c2 in range(4)]

                def unflatten(arr):
                    out = []
                    for j in range(wp_):
                        acc = b.emul(monos[0], _ext_cells(b, arr, 4 * j))
                        for c2 in range(1, 4):
                            acc = b.eadd(acc, b.emul(
                                monos[c2], _ext_cells(b, arr, 4 * j + c2)))
                        out.append(acc)
                    return out
                perm_pair = (unflatten(loc), unflatten(nxt))

            env = {
                "main": mains,
                "preprocessed": prep_pair,
                "perm": perm_pair,
                "publics": [_promote(b, pvs[i].felt(k))
                            for k in range(avk.num_public_values)],
                "challenges": challenges,
                "exposed": ([Ext(exposed[i].addr)]
                            if exposed[i] is not None else []),
                "sels": {"is_first_row": first, "is_last_row": last,
                         "is_transition": trans},
            }
            vals_prog = avk.dag.eval(ops, env,
                                     roots=avk.dag.constraint_roots)
            acc = b.econst((0, 0, 0, 0))
            for root in avk.dag.constraint_roots:
                acc = b.eadd(b.emul(acc, alpha), vals_prog[root])
            folded_c = b.ediv(acc, z_h)

            # quotient(zeta) from chunks
            lqd = avk.log_quotient_degree
            num_chunks = 1 << lqd
            w_q = bb.two_adic_generator_int(log_n + lqd)
            quotient = b.econst((0, 0, 0, 0))
            qmonos = [b.econst(tuple(1 if t == e_i else 0
                                     for t in range(4)))
                      for e_i in range(4)]
            for k in range(num_chunks):
                zp = one_ext
                for j in range(num_chunks):
                    if j == k:
                        continue
                    s_j_inv = pow((bb.GENERATOR * pow(w_q, j, P)) % P,
                                  -1, P)
                    zp_zeta = b.esub(
                        _epow(b, b.emul_felt(zeta, s_j_inv), n), one_ext)
                    s_k = (bb.GENERATOR * pow(w_q, k, P)) % P
                    zp_first = (pow((s_k * s_j_inv) % P, n, P) - 1) % P
                    zp = b.emul(zp, b.emul_felt(zp_zeta,
                                                pow(zp_first, -1, P)))
                inner = b.emul(qmonos[0], _ext_cells(b, q_vals[i][k], 0))
                for e_i in range(1, 4):
                    inner = b.eadd(inner, b.emul(
                        qmonos[e_i], _ext_cells(b, q_vals[i][k], e_i)))
                quotient = b.eadd(quotient, b.emul(zp, inner))
            for k in range(4):
                b.assert_eq(folded_c.felt(k), quotient.felt(k))

    return {"main_commits": main_commits, "pvs": pvs,
            "num_cached": num_cached}


def build_verifier_program(vk, log_degrees: list, num_native_pvs: int = 32,
                           expose: str = "vm",
                           expose_memory_pvs: bool = False):
    """Generate the native program verifying ONE proof of the given shape.

    Returns (exe, meta).  `machine.prove` the exe on a NativeConfig VM with
    inputs=serialize_proof_felts(vk, proof).

    expose: "vm" exposes the app program commit + connector (+ merkle) pvs
    (leaf-verifier shape, reference
    crates/continuations/src/verifier/leaf/mod.rs VmVerifierPvs); "commit"
    exposes only the common-main commit (generic proofs without VM system
    AIRs, e.g. recursion unit tests).
    """
    b = Builder()
    res = _emit_verify(b, vk, log_degrees)
    main_commits, pvs = res["main_commits"], res["pvs"]
    if expose == "vm":
        # pv[0..8] = first cached-main commit (the app program commitment)
        for k in range(8):
            b.public_value(main_commits[0].felt(k), k)
        # pv[8..12] = connector public values (air index 1 by construction)
        conn_pvs = pvs[1]
        for k in range(4):
            b.public_value(conn_pvs.felt(k), 8 + k)
        if expose_memory_pvs:
            # pv[12..28] = memory merkle pvs (persistent app shapes: air 3)
            for k in range(16):
                b.public_value(pvs[3].felt(k), 12 + k)
    else:
        for k in range(8):
            b.public_value(main_commits[res["num_cached"]].felt(k), k)
    b.halt(0)

    exe = b.compile()
    meta = {"num_insns": len(exe.program.instructions)}
    return exe, meta


def build_leaf_program(app_vk, log_degrees: list,
                       expose_memory_pvs: bool = True):
    """Leaf verifier: verifies one app segment proof and exposes
    (app program commit, connector pvs, memory-merkle pvs) — reference
    LeafVmVerifierConfig::build_program with num_children_leaf = 1."""
    return build_verifier_program(app_vk, log_degrees, expose="vm",
                                  expose_memory_pvs=expose_memory_pvs)


def build_internal_program(node_vk, log_degrees: list, num_children: int):
    """Internal aggregation node: verifies `num_children` native-VM proofs
    of identical shape (the fixed aggregation height profile), checks they
    chain, and re-exposes merged pvs (reference InternalVmVerifier,
    crates/continuations/src/verifier/internal/).

    Child pv layout (native-VM proofs with num_native_pvs=44;
    native_public_values is air index 2):
      [0..8]   app program commit      [8..12]  connector pvs
      [12..28] memory merkle pvs       [28..36] self program commit
      [36..44] leaf program commit
    A leaf proof exposes zeros at [28..44].

    Chain of trust (reference InternalVmVerifierPvs.self_program_commit):
    this program hints its OWN commitment (self_commit) and the leaf
    program's commitment (leaf_commit) and exposes both.  For each child
    with actual program commitment cc (bound by verification):
      * cc == self_commit  (child is internal): child must expose the SAME
        (self_commit, leaf_commit) pair;
      * otherwise (child is a leaf): cc must equal leaf_commit and the
        child's [28..44] must be zero.
    The final verifier pins (self_commit, leaf_commit) of the root proof
    to the expected compiled-program commitments, closing the chain at
    every depth.
    """
    b = Builder()
    self_commit = b.read_vec(8)
    leaf_commit = b.read_vec(8)
    merged = None
    for child in range(num_children):
        res = _emit_verify(b, node_vk, log_degrees)
        child_pvs = res["pvs"][2]
        cc = res["main_commits"][0]

        # classify child: internal iff cc == self_commit
        leaf_path, done = b.label(), b.label()
        scratch = b.felt()
        b.mov(0, scratch)
        for k in range(8):
            neq = b.label()
            b.branch_eq(cc.felt(k), self_commit.felt(k), neq)
            b.mov(1, scratch)
            b.place(neq)
        b.branch_ne(scratch, 0, leaf_path)
        # internal child: must expose the same commit pair
        for k in range(8):
            b.assert_eq(child_pvs.felt(28 + k), self_commit.felt(k))
            b.assert_eq(child_pvs.felt(36 + k), leaf_commit.felt(k))
        b.jump(done)
        b.place(leaf_path)
        # leaf child: program must be THE leaf program, sentinel pvs zero
        for k in range(8):
            b.assert_eq(cc.felt(k), leaf_commit.felt(k))
            b.assert_eq(child_pvs.felt(28 + k), 0)
            b.assert_eq(child_pvs.felt(36 + k), 0)
        b.place(done)

        if merged is None:
            merged = b.array(28)
            prev_raw = b.array(28)
            for k in range(28):
                b.mov(child_pvs.felt(k), merged.felt(k))
                b.mov(child_pvs.felt(k), prev_raw.felt(k))
        else:
            # duplicate-last padding: a child identical to the previous one
            # (all 28 pvs) is a no-op — the tree pads short groups by
            # repeating the final proof, which adds no claims
            same = b.felt()
            b.mov(0, same)
            for k in range(28):
                eqk = b.label()
                b.branch_eq(child_pvs.felt(k), prev_raw.felt(k), eqk)
                b.mov(1, same)
                b.place(eqk)
            skip = b.label()
            b.branch_eq(same, 0, skip)
            for k in range(8):
                b.assert_eq(child_pvs.felt(k), merged.felt(k))
            # mid-chain discipline: the previous segment must have
            # SUSPENDED (is_terminate == 0, exit code 42) — a terminated
            # middle segment must not chain (reference verify_segments,
            # arch/vm.rs:1107-1237; the host-side check alone is not
            # enough because the aggregated path is the one that ships)
            b.assert_eq(merged.felt(11), 0)
            b.assert_eq(merged.felt(10), 42)
            # pc chain: prev final_pc == child initial_pc
            b.assert_eq(merged.felt(9), child_pvs.felt(8))
            # memory-root chain: prev final root == child initial root
            for k in range(8):
                b.assert_eq(merged.felt(20 + k), child_pvs.felt(12 + k))
            # adopt child's final pc / exit / terminate / final root
            for k in (9, 10, 11):
                b.mov(child_pvs.felt(k), merged.felt(k))
            for k in range(8):
                b.mov(child_pvs.felt(20 + k), merged.felt(20 + k))
            b.place(skip)
            for k in range(28):
                b.mov(child_pvs.felt(k), prev_raw.felt(k))
    for k in range(28):
        b.public_value(merged.felt(k), k)
    for k in range(8):
        b.public_value(self_commit.felt(k), 28 + k)
        b.public_value(leaf_commit.felt(k), 36 + k)
    b.halt(0)
    exe = b.compile()
    meta = {"num_insns": len(exe.program.instructions),
            "num_children": num_children}
    return exe, meta


def build_root_program(node_vk, log_degrees: list, internal_commit,
                       leaf_commit):
    """Root verifier: verifies the FINAL aggregation proof in-circuit and
    re-exposes its claims (reference RootVmVerifier,
    crates/continuations/src/verifier/root/mod.rs; proved at a distinct
    fixed-height config by RootVerifierLocalProver, crates/sdk/src/prover/
    root.rs).

    Unlike the internal program — which reads the (self, leaf) commitment
    pair as hints and re-exposes it for the NEXT layer to check — the root
    program embeds ``internal_commit`` and ``leaf_commit`` as compile-time
    IMMEDIATES: the chain of trust terminates here, inside the circuit,
    not in a host-side check.  The child must be a complete execution
    (exit code 0, is_terminate 1).  Exposes the child's 28 VM pvs
    (app commit, connector, memory roots).
    """
    internal_commit = [int(v) for v in internal_commit]
    leaf_commit = [int(v) for v in leaf_commit]
    b = Builder()
    res = _emit_verify(b, node_vk, log_degrees)
    child_pvs = res["pvs"][2]
    cc = res["main_commits"][0]

    # classify the child against the pinned internal commitment
    leaf_path, done = b.label(), b.label()
    scratch = b.felt()
    b.mov(0, scratch)
    for k in range(8):
        neq = b.label()
        b.branch_eq(cc.felt(k), internal_commit[k], neq)
        b.mov(1, scratch)
        b.place(neq)
    b.branch_ne(scratch, 0, leaf_path)
    # internal child: its exposed commitment pair must be the pinned one
    for k in range(8):
        b.assert_eq(child_pvs.felt(28 + k), internal_commit[k])
        b.assert_eq(child_pvs.felt(36 + k), leaf_commit[k])
    b.jump(done)
    b.place(leaf_path)
    # leaf child (single-segment apps skip internal layers)
    for k in range(8):
        b.assert_eq(cc.felt(k), leaf_commit[k])
        b.assert_eq(child_pvs.felt(28 + k), 0)
        b.assert_eq(child_pvs.felt(36 + k), 0)
    b.place(done)

    # the aggregated execution must have TERMINATED successfully
    b.assert_eq(child_pvs.felt(10), 0)   # exit code
    b.assert_eq(child_pvs.felt(11), 1)   # is_terminate

    for k in range(28):
        b.public_value(child_pvs.felt(k), k)
    b.halt(0)
    exe = b.compile()
    meta = {"num_insns": len(exe.program.instructions)}
    return exe, meta


def static_height_profile(exe, base_heights=None):
    """Upper-bound per-chip trace heights for a straight-line native
    program by opcode histogram (every instruction row-izes at most once;
    straight-line programs have no loops).  Returns {air name: pow2 height}
    for the aggregation VM's fixed-height proving (reference
    NATIVE_MAX_TRACE_HEIGHTS role, extension/mod.rs:569)."""
    from ..vm.instructions import (FieldArithmeticOpcode as FA,
                                   FieldExtensionOpcode as FE, FriOpcode,
                                   NativeBranchEqOpcode as NB,
                                   NativeJalOpcode,
                                   NativeLoadStore4Opcode as L4,
                                   NativeLoadStoreOpcode as L1,
                                   NativeRangeCheckOpcode, Poseidon2Opcode,
                                   SystemOpcode, VerifyBatchOpcode)
    counts = {"native_field_arithmetic": 0, "native_field_extension": 0,
              "native_branch_eq": 0, "native_loadstore": 0,
              "native_loadstore4": 0, "native_jal_rangecheck": 0,
              "native_poseidon2": 0, "fri_reduced_opening": 0,
              "verify_batch": 0, "verify_batch_inside": 0, "phantom": 0}
    touched = 0
    for insn in exe.program.instructions:
        op = insn.opcode
        if FA.ADD <= op <= FA.DIV:
            counts["native_field_arithmetic"] += 1
            touched += 1
        elif FE.FE4ADD <= op <= FE.BBE4DIV:
            counts["native_field_extension"] += 1
            touched += 4
        elif op in (NB.BEQ, NB.BNE):
            counts["native_branch_eq"] += 1
        elif op in (L1.LOADW, L1.STOREW, L1.HINT_STOREW):
            counts["native_loadstore"] += 1
            touched += 1
        elif op in (L4.LOADW4, L4.STOREW4, L4.HINT_STOREW4):
            counts["native_loadstore4"] += 1
            touched += 4
        elif op in (NativeJalOpcode.JAL, NativeRangeCheckOpcode.RANGE_CHECK):
            counts["native_jal_rangecheck"] += 1
            touched += 1
        elif op == FriOpcode.FRI_REDUCED_OPENING:
            counts["fri_reduced_opening"] += insn.c  # len rows per insn
            touched += 4
        elif op == VerifyBatchOpcode.VERIFY_BATCH:
            counts["verify_batch"] += 2 * insn.e + 1
            counts["verify_batch_inside"] += insn.f
        elif op in (Poseidon2Opcode.PERM_POS2, Poseidon2Opcode.COMP_POS2):
            counts["native_poseidon2"] += 1
            touched += 32
        elif op == SystemOpcode.PHANTOM:
            counts["phantom"] += 1

    def pow2(x):
        return 1 << max(int(x) - 1, 0).bit_length() if x > 0 else 1

    prof = {name: pow2(n) for name, n in counts.items()}
    # shared poseidon2: adapter perms + verify_batch compresses (<= top
    # rows) + inside-row sponge duplexes
    prof["poseidon2"] = pow2(counts["native_poseidon2"]
                             + counts["verify_batch"]
                             + counts["verify_batch_inside"])
    prof["program"] = pow2(len(exe.program.instructions))
    prof["memory_boundary"] = pow2(touched)
    if base_heights:
        for k, v in base_heights.items():
            prof[k] = max(prof.get(k, 1), v)
    return prof
