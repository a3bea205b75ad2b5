#!/usr/bin/env python3
"""Drive openvm_tpu_torch's trace-commitment pipeline on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; the first run builds the CUDA kernels from
openvm_tpu_torch/csrc into build/ (nvcc, sm_90a).  Phases, each printing one
JSON line:

  setup     build the kernels, name the card and its power limit
  pinned    the kernels reproduce the vectors of
            tests/test_bitcompat_fixtures.py; the challenger's too
  variants  every coset_lde argument, kernel against plain, mid-size
  main      one RV32IM segment's common-main commit at full size: the
            matrix widths of the VM's AIRs, heights at the fib_e2e segment
            cap (1,048,476 rows) padded to 2^20; to_monty -> coset LDE
            batched by height -> Merkle commit -> observe the root, sample
            84 query indices -> open -> verify on the host
  plain     the same pipeline through the plain PyTorch versions on the
            card: every LDE, every digest layer and the root must be equal
  timing    each kernel and its plain version at the main path's shapes

then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line.  The kernels
compute over integers, so every comparison is exact equality.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from openvm_tpu_torch import _build, merkle, ntt, poseidon2 as p2
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark.config import FriParameters, StarkConfig

SEED = 0

# (AIR, log2 height, width): VirtualMachine(Rv32Config()).airs widths of a
# fibonacci segment's busiest chips, at the fib_e2e segment cap padded to
# 2^20 (SURVEY.md:568) and the shorter chips below it.
SEGMENT = [("BaseAluAir", 20, 45), ("LoadStoreAir", 20, 56),
           ("BranchEqAir", 19, 29), ("BranchLtAir", 19, 37),
           ("JalLuiAir", 18, 20), ("RangeCheckerAir", 17, 1),
           ("BitwiseLookupAir", 16, 2)]

# tests/test_bitcompat_fixtures.py:21-78
PERM_0_15 = [1952993082, 1617884793, 90683999, 1056283110,
             867545409, 290768337, 1606559591, 1225374373,
             1789096927, 494560864, 1094240052, 1575300684,
             540591577, 1767075193, 341504408, 1747000221]
HASH_ROWS_0 = [792144724, 998142365, 1110522868, 131779120,
               85566828, 51797263, 1511264494, 935419835]
MERKLE_ROOT = [512692767, 1522905392, 880658602, 995090898,
               1116979930, 1561754655, 1474458837, 453321358]

# Bounds.  Bytes: each input read once, each output written once, over the
# H100's 3.35 TB/s.  Operations: 32-bit integer ALU operations, a
# Montgomery product counted as 8 (two 32x32->64 products at 2 each, one
# low product, a 64-bit add, a compare-select), a modular add or sub as 3,
# over 67e12/s, the card's 32-bit non-tensor peak (the float32 rate; the
# integer pipe is narrower, so this bound is optimistic).
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
MUL_OPS, ADD_OPS = 8, 3
# One permutation: the initial external layer (72 adds), 8 full rounds of
# 16 constant adds, 16 S-boxes (4 products each) and an external layer,
# 13 partial rounds of 1 add, 1 S-box, 15 adds for the sum, 16 products and
# 16 adds.
PERM_MULS = 8 * 16 * 4 + 13 * (4 + 16)
PERM_ADDS = 72 + 8 * (16 + 72) + 13 * (1 + 15 + 16)
PERM_OPS = PERM_MULS * MUL_OPS + PERM_ADDS * ADD_OPS


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def batched_plain_ldes(mats: list, log_blowup: int) -> list:
    """ntt.batched_coset_ldes through ntt.coset_lde_plain."""
    by_h: dict = {}
    for k, m in enumerate(mats):
        by_h.setdefault(int(m.shape[0]), []).append(k)
    ldes = [None] * len(mats)
    for idxs in by_h.values():
        y = ntt.coset_lde_plain(torch.cat([mats[k] for k in idxs], dim=1),
                                log_blowup)
        off = 0
        for k in idxs:
            ldes[k] = y[:, off:off + mats[k].shape[1]]
            off += mats[k].shape[1]
    return ldes


def phase_setup(dev) -> dict:
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log = (lib_path.parent / "build.log").read_text().splitlines()
    ptxas = [ln.strip() for ln in log
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    emit({"phase": "setup", "build_s": build_s, "library": str(lib_path),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
          "ptxas": ptxas})
    print(smi.splitlines()[0], flush=True)
    return {"nvidia_smi": smi}


def phase_pinned(dev) -> None:
    st = bb.monty(np.arange(16), device=dev)
    require(bb.canonical_np(p2.permute(st)).tolist() == PERM_0_15, "permute")
    pair = bb.monty(np.arange(16).reshape(2, 8), device=dev)
    require(bb.canonical_np(merkle.compress_layer(pair))[0].tolist()
            == PERM_0_15[:8], "K5 compress")
    m = bb.monty((np.arange(4 * 12).reshape(4, 12) * 7 + 3) % bb.P, device=dev)
    require(bb.canonical_np(p2.hash_rows(m))[0].tolist() == HASH_ROWS_0,
            "K4 hash_rows")
    tr = bb.monty((np.arange(8 * 4).reshape(8, 4) * 11 + 1) % bb.P, device=dev)
    require(merkle.commit([tr]).root.tolist() == MERKLE_ROOT, "Merkle root")
    ch = DuplexChallenger()
    ch.observe_slice(list(range(8)))
    require([ch.sample() for _ in range(3)] == [536986157, 1951342121, 635888807]
            and ch.sample_bits(20) == 870614, "challenger samples")
    ch2 = DuplexChallenger()
    ch2.observe_ext((1, 2, 3, 4))
    require(ch2.sample_ext() == (1548460626, 39002199, 1146611958, 137492534),
            "challenger sample_ext")
    emit({"phase": "pinned", "ok": True})


def phase_variants(dev, rng) -> None:
    """Every coset_lde argument and ntt/intt, kernel against plain."""
    errs = {}
    for log_n, w in ((0, 5), (1, 3), (12, 45)):
        x = bb.monty(rng.integers(0, bb.P, size=(1 << log_n, w)), device=dev)
        errs[f"ntt/{log_n}x{w}"] = max_abs_err(ntt.ntt(x), ntt.ntt_plain(x))
        errs[f"intt/{log_n}x{w}"] = max_abs_err(ntt.intt(x), ntt.intt_plain(x))
        for lb, shift, bitrev_out, in_shift, coeffs in (
                (1, 31, True, 1, False), (2, 7, False, 31, True),
                (0, 31, False, 11, False), (3, 31, True, 1, True)):
            args = (lb, shift, bitrev_out, in_shift, coeffs)
            got = ntt.coset_lde(x, *args)
            want = ntt.coset_lde_plain(x, *args)
            if coeffs:
                err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
            else:
                err = max_abs_err(got, want)
            errs[f"coset_lde/{log_n}x{w}/{args}"] = err
    a = bb.monty(rng.integers(0, bb.P, size=(1000, 7)), device=dev)
    b = bb.monty(rng.integers(0, bb.P, size=(1000, 7)), device=dev)
    for name, fn, plain in (("mul", bb.mul, bb.mul_plain), ("add", bb.add, bb.add_plain),
                            ("sub", bb.sub, bb.sub_plain)):
        errs[name] = max_abs_err(fn(a, b), plain(a, b))
    errs["from_monty"] = max_abs_err(bb.from_monty(a), bb.from_monty_plain(a))
    for w in (1, 7, 8, 9, 45):
        m = bb.monty(rng.integers(0, bb.P, size=(300, w)), device=dev)
        errs[f"hash_rows/{w}"] = max_abs_err(p2.hash_rows(m), p2.hash_rows_plain(m))
    bad = {k: v for k, v in errs.items() if v}
    emit({"phase": "variants", "cases": len(errs), "mismatched": bad})
    require(not bad, f"kernel and plain disagree: {bad}")


def run_main(traces: list, cfg: StarkConfig) -> dict:
    """The main path, through the port's public entry points."""
    lb = cfg.fri.log_blowup
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    monty = [bb.to_monty(t) for t in traces]
    ldes = ntt.batched_coset_ldes(monty, lb)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tree = merkle.commit(ldes)  # the root's copy to the host synchronises
    t2 = time.perf_counter()
    ch = DuplexChallenger()
    ch.observe_slice(tree.root)
    log_max = tree.max_height().bit_length() - 1
    indices = [ch.sample_bits(log_max) for _ in range(cfg.fri.num_queries)]
    openings = [merkle.open_row(tree, i) for i in indices]
    t3 = time.perf_counter()
    dims = [(int(m.shape[0]), int(m.shape[1])) for m in tree.matrices]
    rows_by_mat = [np.stack([rows[k] for rows, _ in openings])
                   for k in range(len(dims))]
    sibs = [np.stack([proof[k] for _, proof in openings])
            for k in range(len(openings[0][1]))]
    ok = merkle.verify_batch_queries(tree.root, dims, indices, rows_by_mat, sibs)
    t4 = time.perf_counter()
    return {"monty": monty, "ldes": ldes, "tree": tree, "indices": indices,
            "ok": ok, "log_max": log_max, "dims": dims,
            "s": {"to_monty_lde": t1 - t0, "commit": t2 - t1, "open": t3 - t2,
                  "verify": t4 - t3}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    return run(dev)


def run(dev: torch.device) -> int:
    setup = phase_setup(dev)
    rng = np.random.default_rng(SEED)
    phase_pinned(dev)
    phase_variants(dev, rng)

    # ---- main path ------------------------------------------------------
    cfg = StarkConfig(fri=FriParameters.standard_with_100_bits_conjectured_security(1))
    canon = [rng.integers(0, bb.P, size=(1 << lh, w), dtype=np.uint32)
             for _, lh, w in SEGMENT]
    traces = [torch.from_numpy(c.view(np.int32)).to(dev) for c in canon]
    cells = sum(c.size for c in canon)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    main = run_main(traces, cfg)
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tree = main["tree"]
    require(all(launches.values()), f"a kernel never ran: {launches}")
    log_max = max(lh for _, lh, _ in SEGMENT) + cfg.fri.log_blowup
    require(len(main["indices"]) == cfg.fri.num_queries
            and main["log_max"] == log_max, "queries")
    require(bool(main["ok"].all()), f"openings failed: {main['ok'].tolist()}")
    require([tuple(d) for d in main["dims"]]
            == [(1 << (lh + cfg.fri.log_blowup), w) for _, lh, w in SEGMENT],
            "LDE shapes")
    require([tuple(layer.shape) for layer in tree.digest_layers]
            == [(1 << k, 8) for k in range(log_max, -1, -1)], "layer shapes")
    s = main["s"]
    emit({"phase": "main", "cells": cells, "log_blowup": cfg.fri.log_blowup,
          "queries": len(main["indices"]), "root": tree.root.tolist(),
          "stage_s": s, "cells_per_s": cells / (s["to_monty_lde"] + s["commit"]),
          "peak_gb": peak_gb, "launches": launches})

    # ---- the same pipeline through the plain versions ---------------------
    t0 = time.perf_counter()
    p_monty = [bb.to_monty_plain(t) for t in traces]
    err = {"bb_elementwise": max(max_abs_err(a, b) for a, b in zip(main["monty"], p_monty))}
    require(err["bb_elementwise"] == 0, "K1 differs from plain")
    p_ldes = batched_plain_ldes(p_monty, cfg.fri.log_blowup)
    err["ntt"] = max(max_abs_err(a, b) for a, b in zip(main["ldes"], p_ldes))
    require(err["ntt"] == 0, "K3 differs from plain")
    p_layers = merkle.commit_layers_plain(p_ldes)
    err["poseidon2_hash_rows"] = max_abs_err(tree.digest_layers[0], p_layers[0])
    err["poseidon2_compress_layer"] = max(
        max_abs_err(a, b) for a, b in zip(tree.digest_layers[1:], p_layers[1:]))
    p_root = bb.canonical_np(p_layers[-1][0])
    require(all(v == 0 for v in err.values()), f"kernel and plain differ: {err}")
    require(p_root.tolist() == tree.root.tolist(), "plain root differs")
    emit({"phase": "plain", "root_equal": True, "max_abs_err": err,
          "s": time.perf_counter() - t0})
    del p_monty, p_ldes, p_layers

    # ---- timing at the main path's shapes ---------------------------------
    # K1: to_monty of the widest trace; K3: the LDE of the tallest batch;
    # K4: the leaf hash; K5: the top layer with its injected digests.
    widest = traces[1]
    joined = torch.cat([main["monty"][0], main["monty"][1]], dim=1)
    leaf_in = torch.cat([main["ldes"][0], main["ldes"][1]], dim=1)
    inj_in = torch.cat([main["ldes"][2], main["ldes"][3]], dim=1)
    inj = p2.hash_rows(inj_in)
    top = tree.digest_layers[0]
    n1, w1 = joined.shape
    log_n1 = n1.bit_length() - 1
    rows_leaf, w_leaf = leaf_in.shape
    h5 = top.shape[0] // 2
    cases = [
        ("bb_elementwise", "babybear.cu", "openvm_tpu/field/babybear.py:174",
         lambda: bb.to_monty(widest), lambda: bb.to_monty_plain(widest), 20, 3,
         widest.numel() * 8, widest.numel() * MUL_OPS, list(widest.shape)),
        ("ntt", "ntt.cu", "openvm_tpu/ntt.py:117",
         lambda: ntt.coset_lde(joined, 1), lambda: ntt.coset_lde_plain(joined, 1),
         5, 1, n1 * w1 * 4 * 3,
         ((n1 // 2) * log_n1 + n1 * (log_n1 + 1)) * w1 * (MUL_OPS + 2 * ADD_OPS)
         + n1 * w1 * MUL_OPS, [n1, w1]),
        ("poseidon2_hash_rows", "poseidon2.cu", "openvm_tpu/poseidon2.py:213",
         lambda: p2.hash_rows(leaf_in), lambda: p2.hash_rows_plain(leaf_in), 3, 1,
         rows_leaf * (w_leaf * 4 + 32), rows_leaf * -(-w_leaf // 8) * PERM_OPS,
         [rows_leaf, w_leaf]),
        ("poseidon2_compress_layer", "poseidon2.cu", "openvm_tpu/merkle.py:49",
         lambda: merkle.compress_layer(top, inj),
         lambda: merkle.compress_layer_plain(top, inj), 10, 1,
         h5 * 32 * 4, h5 * 2 * PERM_OPS, [2 * h5, 8]),
    ]
    kernels = []
    for name, src, replaces, fn, plain, reps, plain_reps, nbytes, ops, shape in cases:
        ms = cuda_ms(fn, reps)
        plain_ms = cuda_ms(plain, plain_reps)
        b_ms, b_by = bound(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": f"openvm_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "library": "no single PyTorch call computes this function",
            "shape": shape, "bytes": nbytes, "ops": ops})
    # The main path's stages again, warm: the NTT tables are cached now.
    warm_ms = {"to_monty_lde": cuda_ms(lambda: ntt.batched_coset_ldes(
                   [bb.to_monty(t) for t in traces], cfg.fri.log_blowup), 3),
               "commit_layers": cuda_ms(lambda: merkle.commit_layers(main["ldes"]), 3)}
    emit({"phase": "timing", "nvidia_smi": setup["nvidia_smi"],
          "stage_warm_ms": warm_ms,
          "kernels": {k["name"]: {"kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
                                  "bound_ms": k["bound_ms"]} for k in kernels}})
    print(setup["nvidia_smi"].splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
