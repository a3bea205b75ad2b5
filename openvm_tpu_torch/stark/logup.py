"""LogUp permutation argument, host half: constraint synthesis.

Copy of openvm_tpu/stark/logup.py:36-132 (``chunk_interactions``,
``append_logup_constraints``) and :442-444 (``num_logup_constraints``), so
that ``keygen`` gives the same DAG and verifying key as the JAX package.
The device half (the permutation trace and the batched quotient terms,
kernels K9 and K10) belongs to the LogUp slice of the port and is not here.

Scheme: challenges alpha = ch[0], beta = ch[1] (extension).  Interaction i
has denominator alpha + bus_i + sum_j beta^(j+1) field_{i,j} and signed
count +count (send) or -count (receive).  Interactions are chunked so each
chunk constraint stays within the configured max constraint degree; each
chunk gets a permutation column, phi is their running sum, and its last
value is exposed.
"""

from __future__ import annotations

from .symbolic import AirBuilder, Interaction, Var, degree


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
