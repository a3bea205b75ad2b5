"""Logical constraint debugger (pre-cryptographic checks).

Port of openvm_tpu/stark/debug.py:60-138 (``check_constraints``), a
re-design of the reference's ``stark-debug`` feature (reference
crates/vm/src/arch/vm.rs:1276-1326):

  * evaluates every AIR's base constraints row by row on the natural trace
    domain (selectors as 0/1 indicators, next row j + 1 mod N, the
    context's public values) and reports the first failing (air,
    constraint, row);
  * checks global bus balance on the host: the signed multiset of all
    interaction messages across AIRs must cancel per bus.

The JAX package evaluates the DAG through its tensor ``DeviceOps``; here
each AIR's base constraint roots and interaction fields and counts are
compiled to one columns program with selectors (``quotient.compile_columns``,
kept per proving key) and run by ``quotient.evaluate_columns``: kernel K7's
columns mode on CUDA tensors, its plain version on CPU tensors.  The failure
strings are the JAX package's, in its order.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from .._device import resolve_device
from ..field import babybear as bb
from . import quotient as qmod
from .prover import _to_device_monty

P = bb.P


def _refs_phase1(dag, root) -> bool:
    """Does the subgraph reference permutation/challenge/exposed vars?"""
    stack = [root]
    seen = set()
    while stack:
        i = stack.pop()
        if i in seen:
            continue
        seen.add(i)
        n = dag.nodes[i]
        if n[0] == "var" and n[1] in ("permutation", "challenge", "exposed"):
            return True
        if n[0] in ("add", "sub", "mul"):
            stack += [n[1], n[2]]
        elif n[0] == "neg":
            stack.append(n[1])
    return False


def _check_plan(pk, air_id: int, n_main: int) -> tuple:
    """(columns code, base constraint roots) of one AIR: the same for
    every check, so compiled once per proving key."""
    key = ("debug", air_id, n_main)
    if key not in pk.kernel_plans:
        apk = pk.per_air[air_id]
        dag = apk.vk.dag
        base_roots = [r for r in dag.constraint_roots if not _refs_phase1(dag, r)]
        int_roots = [r for (_, frs, cr, _) in dag.interactions for r in frs + [cr]]
        code = qmod.compile_columns_code(
            dag, base_roots + int_roots, n_main=n_main,
            has_preprocessed=apk.preprocessed_trace is not None, selectors=True)
        pk.kernel_plans[key] = (code, base_roots)
    return pk.kernel_plans[key]


def _device_of(ctxs, device) -> torch.device:
    for ctx in ctxs:
        for m in ([ctx.common_main] + list(ctx.cached_mains)):
            if isinstance(m, torch.Tensor):
                return m.device
    return resolve_device(device)


def check_constraints(pk, ctxs, raise_on_error=True, device=None) -> list:
    """Debug-check base constraints and bus balance for the given contexts.

    ctxs: list of AirProvingContext (canonical numpy or Montgomery
    tensors); the check runs on the tensors' device (``device``, CUDA by
    default, when every matrix is numpy).  Returns a list of failure
    strings (empty = all good); raises AssertionError on a failure when
    ``raise_on_error``."""
    dev = _device_of(ctxs, device)
    failures = []
    bus_totals = defaultdict(lambda: defaultdict(int))

    for ctx in ctxs:
        apk = pk.per_air[ctx.air_id]
        vk = apk.vk
        dag = vk.dag
        mains = [_to_device_monty(m, dev) for m in ctx.cached_mains]
        if ctx.common_main is not None:
            mains.append(_to_device_monty(ctx.common_main, dev))
        n = int(mains[0].shape[0])
        code, base_roots = _check_plan(pk, ctx.air_id, len(mains))
        publics = [bb.to_monty_int(int(v) % P) for v in (ctx.public_values or [0])]
        prog = qmod.bind(code, publics=publics)
        prep = apk.preprocessed_trace
        sources = mains + ([prep] if prep is not None else [])
        cols = bb.canonical_np(qmod.evaluate_columns(prog, sources,
                                                     n.bit_length() - 1))

        nb = len(base_roots)
        k_base = 0
        for k, root in enumerate(dag.constraint_roots):
            if k_base < nb and base_roots[k_base] == root:
                bad = np.nonzero(cols[k_base])[0]
                k_base += 1
                if len(bad):
                    failures.append(f"air {vk.name}: constraint #{k} nonzero at "
                                    f"row {bad[0]} (of {n})")

        # bus accounting
        at = nb
        for (bus, frs, cr, is_send) in dag.interactions:
            fields = cols[at:at + len(frs)]
            counts = cols[at + len(frs)]
            at += len(frs) + 1
            sign = 1 if is_send else -1
            nz = np.nonzero(counts)[0]
            table = bus_totals[bus]
            for key, cnt in zip(map(tuple, fields[:, nz].T.tolist()),
                                counts[nz].tolist()):
                table[key] += sign * cnt

    for bus, table in bus_totals.items():
        for key, total in table.items():
            if total % P != 0:
                failures.append(
                    f"bus {bus}: message {key} unbalanced (net {total})")
                if len(failures) > 20:
                    break

    if failures and raise_on_error:
        raise AssertionError("constraint debug failures:\n  "
                             + "\n  ".join(failures[:30]))
    return failures
