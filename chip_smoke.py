#!/usr/bin/env python3
"""Drive openvm_tpu_torch's ported paths on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout; the first run builds the CUDA kernels from
openvm_tpu_torch/csrc into build/ (nvcc, sm_90a, one process per source).
Phases, each printing one JSON line:

  setup     build the kernels, name the card and its power limit
  pinned    the kernels reproduce the vectors of
            tests/test_bitcompat_fixtures.py and the challenger's; the
            codec reproduces the pinned blob; the proofs of
            tests/test_torch_prover.py's three-AIR instance, of
            tests/test_torch_logup.py's sender/receiver pair and of the VM's
            fib(10) (tests/test_torch_vm.py) have the SHA-256 that openvm_tpu
            gives, and a wrong public value fails
  variants  every new kernel and every coset_lde argument, kernel against
            plain, mid-size
  main      path 1, one RV32IM segment's common-main commit at full size:
            the matrix widths of the VM's AIRs, heights at the fib_e2e
            segment cap (1,048,476 rows) padded to 2^20; to_monty -> coset
            LDE batched by height -> Merkle commit -> observe the root,
            sample 84 query indices -> gather the openings (K6) -> verify
            on the host
  plain     path 1 through the plain PyTorch versions on the card: every
            LDE, every digest layer and the root must be equal
  prove     path 2, the STARK prover at full size: keygen -> prove ->
            verify over FibonacciAir at 2^22 and 2^20 (the kitchen_sink and
            fib_e2e segment caps, 4,194,204 and 1,048,476 rows, padded) and
            CubeAir at 2^18 (preprocessed column, cached main, degree 3),
            84 queries and 16 PoW bits; the prove's own quotient inputs
            and query gather are run again through the plain versions
  vm        path 3, the RV32IM VM proof: VirtualMachine keygen -> prove ->
            verify of the fibonacci guest build_fib_program(200,000), about
            1.0 M instructions (rv32_base_alu 800 k rows, padded to 2^20),
            with FIB_EXECUTORS and the production profile (84 queries, 16
            PoW bits, log_blowup 1); stage seconds, insn/s, trace cells/s;
            then K8 on every AIR's sends, K9 and K10 on every AIR's
            permutation trace and K7 on the two widest AIRs' quotient (LogUp
            roots included) against their plain versions, on the prove's own
            inputs
  timing    each kernel and its plain version at the paths' shapes

then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line.  The kernels
compute over integers, so every comparison is exact equality.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from openvm_tpu_torch import _build, fri, merkle, ntt, poseidon2 as p2, stark
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.field import ext as ef
from openvm_tpu_torch.stark import codec, logup, lookup, prover as pv, quotient as qmod
from openvm_tpu_torch.stark.config import FriParameters, StarkConfig
from openvm_tpu_torch.stark.symbolic import SymbolicDag
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program, fib
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

SEED = 0
P = bb.P

# (AIR, log2 height, width): VirtualMachine(Rv32Config()).airs widths of a
# fibonacci segment's busiest chips, at the fib_e2e segment cap padded to
# 2^20 (SURVEY.md:568) and the shorter chips below it.
SEGMENT = [("BaseAluAir", 20, 45), ("LoadStoreAir", 20, 56),
           ("BranchEqAir", 19, 29), ("BranchLtAir", 19, 37),
           ("JalLuiAir", 18, 20), ("RangeCheckerAir", 17, 1),
           ("BitwiseLookupAir", 16, 2)]

# Path 2: (AIR, log2 height).  FibonacciAir at the kitchen_sink and
# fib_e2e segment caps padded to powers of two (SURVEY.md:568); CubeAir
# gives FRI a third injected height and the quotient its lqd 1 case.
PROVE_AIRS = [("fib", 22), ("fib", 20), ("cube", 18)]

# tests/test_bitcompat_fixtures.py:21-78
PERM_0_15 = [1952993082, 1617884793, 90683999, 1056283110,
             867545409, 290768337, 1606559591, 1225374373,
             1789096927, 494560864, 1094240052, 1575300684,
             540591577, 1767075193, 341504408, 1747000221]
HASH_ROWS_0 = [792144724, 998142365, 1110522868, 131779120,
               85566828, 51797263, 1511264494, 935419835]
MERKLE_ROOT = [512692767, 1522905392, 880658602, 995090898,
               1116979930, 1561754655, 1474458837, 453321358]
# tests/test_bitcompat_fixtures.py:134-135 (the 665-byte codec blob)
CODEC_BLOB_SHA256 = \
    "ca080bacdcea1da8b75aae72aee556cf11cc57b8382a445a8195d7ca9db0b176"
# tests/test_torch_prover.py's FIXTURE_PROOF_SHA256: openvm_tpu's proof of
# FibonacciAir at 2^5 and 2^3 and CubeAir at 2^4 under
# tests/test_stark_e2e.py's TEST_CONFIG
FIXTURE_PROOF_SHA256 = \
    "a7febea84f25e9074f2e80382be71111e236adbb861a996c3e3c026133de7e8d"
# tests/test_torch_logup.py's SENDER_RECEIVER_PROOF_SHA256 and
# tests/test_torch_vm.py's FIB10_PROOF_SHA256: openvm_tpu's proofs of the
# balanced sender/receiver pair and of the VM's fib(10)
SENDER_RECEIVER_PROOF_SHA256 = \
    "69e8d8c994a91341064fa0a08d5652c33625279bb434def5e0963fceb46d2528"
FIB10_PROOF_SHA256 = \
    "7f2298f064201166dd6b35c8beec5f7895484312deeaee02c9d2d204136bf53c"
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))

# Path 3: the fibonacci guest's loop count; 5 instructions an iteration.
VM_FIB_N = 200_000
# Path 2 has no interactions: it runs every kernel but K8, K9, K10 and the
# columns mode of K7.
PATH2_KERNELS = ("bb_elementwise", "ntt", "poseidon2_hash_rows",
                 "poseidon2_compress_layer", "ext_elementwise", "gather",
                 "quotient", "open_dot", "fri_reduced_open", "fri_fold")

# Bounds.  Bytes: each input read once, each output written once, over the
# H100's 3.35 TB/s.  Operations: the fewest 32-bit integer ALU operations
# the function needs, a Montgomery product counted as 8 (two 32x32->64
# products at 2 each, one low product, a 64-bit add, a compare-select), a
# modular add or sub as 3, over 67e12/s, the card's 32-bit non-tensor peak
# (the float32 rate; the integer pipe is narrower, so this bound is
# optimistic).
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
# Extension arithmetic: a product is 19 Montgomery products and 12 adds.
# Batch inversion (Montgomery's trick) costs 3 products per element, base
# or extension, plus one inverse per batch, which rounds to nothing.
EXT_ADD = 4 * ADD_OPS
EXT_SCALE = 4 * MUL_OPS
EXT_MUL = 19 * MUL_OPS + 12 * ADD_OPS
BATCH_INV, EXT_BATCH_INV = 3 * MUL_OPS, 3 * EXT_MUL
NO_LIBRARY = "no single PyTorch call computes this function"


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


def cuda_ms(fn, reps: int, host: bool = False):
    """Mean device time of fn() over reps calls after one warm-up call; with
    ``host``, also the mean host time to enqueue one call.  Where the two
    are close, the card waited on the host and the device time is the
    host's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    return (ms, host_ms) if host else ms


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def words(rng, dev, *shape) -> torch.Tensor:
    """Random Montgomery words on ``dev``."""
    return bb.from_numpy(bb.to_monty_np(rng.integers(0, P, size=shape,
                                                     dtype=np.uint64)), device=dev)


# ---------------------------------------------------------------------------
# The AIRs of path 2 and their traces
# ---------------------------------------------------------------------------

class FibonacciAir(stark.Air):
    """a' = b, b' = a + b; pvs [a0, b0, b_last] (tests/test_stark_e2e.py:19)."""

    name = "fib"
    width = 2
    num_public_values = 3

    def eval(self, b):
        a, bcol = b.main(0), b.main(1)
        a_n, b_n = b.main(0, offset=1), b.main(1, offset=1)
        with b.when_first_row():
            b.assert_eq(a, b.public_value(0))
            b.assert_eq(bcol, b.public_value(1))
        with b.when_transition():
            b.assert_eq(a_n, bcol)
            b.assert_eq(b_n, a + bcol)
        with b.when_last_row():
            b.assert_eq(bcol, b.public_value(2))


class CubeAir(stark.Air):
    """x' = x*y + c on transitions (degree 3 with the selector), y a cached
    main partition, c = row index preprocessed; x at the first and last row
    public (tests/test_torch_prover.py's CubeAir)."""

    name = "cube"
    width = 1
    cached_main_widths = (1,)
    num_public_values = 2

    def __init__(self, log_n):
        self.log_n = log_n

    def preprocessed_trace(self):
        return np.arange(1 << self.log_n, dtype=np.uint64)[:, None]

    def eval(self, b):
        x, x_next = b.main(0), b.main(0, offset=1)
        y, c = b.main(0, part=0), b.preprocessed(0)
        with b.when_first_row():
            b.assert_eq(x, b.public_value(0))
        with b.when_transition():
            b.assert_eq(x_next, x * y + c)
        with b.when_last_row():
            b.assert_eq(x, b.public_value(1))


class SenderAir(stark.Air):
    """Sends each row's value to bus 7 (tests/test_stark_e2e.py:48)."""

    name = "sender"
    width = 1

    def eval(self, b):
        b.push_send(7, [b.main(0)], 1)


class ReceiverAir(stark.Air):
    """Receives values on bus 7 with a multiplicity column."""

    name = "receiver"
    width = 2

    def eval(self, b):
        b.push_receive(7, [b.main(0)], b.main(1))


def fib_trace(n: int) -> np.ndarray:
    """Rows (F_i, F_i+1) mod p by doubling: row i+k = M^k row i with
    M^k = [[F_k-1, F_k], [F_k, F_k+1]]."""
    rows = np.zeros((n, 2), dtype=np.uint64)
    rows[0] = (0, 1)
    k = 1
    while k < n:
        f_km1, f_k = (int(v) for v in rows[k - 1])  # (F_k-1, F_k)
        f_kp1 = (f_km1 + f_k) % P
        m = min(k, n - k)
        a, b = rows[:m, 0], rows[:m, 1]
        rows[k:k + m, 0] = (np.uint64(f_km1) * a % P + np.uint64(f_k) * b % P) % P
        rows[k:k + m, 1] = (np.uint64(f_k) * a % P + np.uint64(f_kp1) * b % P) % P
        k += m
    return rows


def cube_trace(log_n: int, seed: int):
    n = 1 << log_n
    y = np.random.default_rng(seed).integers(0, P, size=n, dtype=np.uint64)
    x = np.zeros(n, dtype=np.uint64)
    xi = 5
    for i, yi in enumerate(y.tolist()):
        x[i] = xi
        xi = (xi * yi + i) % P
    return x[:, None], y[:, None], [5, int(x[-1])]


def prove_inputs(airs_spec, seed: int):
    airs, ctxs = [], []
    for air_id, (kind, log_n) in enumerate(airs_spec):
        if kind == "fib":
            t = fib_trace(1 << log_n)
            airs.append(FibonacciAir())
            ctxs.append(stark.AirProvingContext(
                air_id=air_id, common_main=t, public_values=[0, 1, int(t[-1, 1])]))
        else:
            x, y, pvs = cube_trace(log_n, seed + air_id)
            airs.append(CubeAir(log_n))
            ctxs.append(stark.AirProvingContext(
                air_id=air_id, common_main=x, cached_mains=[y], public_values=pvs))
    return airs, ctxs


def fixture_contexts(on=None, last_pv_delta=0) -> list:
    """tests/test_torch_prover.py's ``contexts``: FibonacciAir at 2^5 and
    2^3, CubeAir at 2^4; canonical numpy traces, or Montgomery words on
    device ``on``."""
    t5, t3 = fib_trace(32), fib_trace(8)
    x, y, cube_pvs = cube_trace(4, 1)

    def m(a):
        return a if on is None else bb.monty(a, device=on)

    return [stark.AirProvingContext(air_id=0, common_main=m(t5),
                                    public_values=[0, 1, int(t5[-1, 1])]),
            stark.AirProvingContext(
                air_id=1, common_main=m(t3),
                public_values=[0, 1, (int(t3[-1, 1]) + last_pv_delta) % P]),
            stark.AirProvingContext(air_id=2, common_main=m(x), cached_mains=[m(y)],
                                    public_values=cube_pvs)]


def random_dag(rng, n_ops: int) -> tuple:
    """A random constraint DAG over two main parts (3 and 2 columns), a
    preprocessed matrix (2), a permutation matrix (2 ext columns), 3
    publics, 2 challenges, 1 exposed value and the selectors; operands come
    from the last 16 nodes or from the leaves, so the program's live slots
    stay bounded.  Returns (nodes, roots)."""
    nodes = [("const", 0), ("const", 1), ("const", P - 1), ("const", 12345)]
    nodes += [("var", "main", part, off, c) for part, w in enumerate((3, 2))
              for c in range(w) for off in (0, 1)]
    nodes += [("var", "preprocessed", 0, off, c) for c in range(2) for off in (0, 1)]
    nodes += [("var", "permutation", 0, off, c) for c in range(2) for off in (0, 1)]
    nodes += [("var", "public", 0, 0, k) for k in range(3)]
    nodes += [("var", "challenge", 0, 0, k) for k in range(2)]
    nodes += [("var", "exposed", 0, 0, 0)]
    nodes += [("sel", s) for s in qmod.SELECTORS]
    n_leaves = len(nodes)
    for _ in range(n_ops):
        k = len(nodes)
        ab = [int(rng.integers(0, n_leaves)) if rng.random() < 0.3
              else int(rng.integers(max(0, k - 16), k)) for _ in range(2)]
        op = ("add", "sub", "mul", "mul", "neg")[int(rng.integers(0, 5))]
        nodes.append(("neg", ab[0]) if op == "neg" else (op, ab[0], ab[1]))
    roots = sorted(int(x) for x in rng.choice(
        np.arange(n_leaves, len(nodes)), size=n_ops // 20, replace=False))
    return nodes, roots + [n_leaves - 1]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

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


def codec_blob() -> bytes:
    """tests/test_bitcompat_fixtures.py:91-126's proof, through the port."""

    def d(s):
        return np.arange(s, s + 8, dtype=np.uint64)

    def ext(s):
        return (s, s + 1, s + 2, s + 3)

    adj = pv.AdjacentOpenedValues(local=[ext(10), ext(20)], next=[ext(30), ext(40)])
    proof = pv.Proof(
        commitments=pv.Commitments(main_trace=[d(100), d(200)],
                                   after_challenge=[d(300)], quotient=d(400)),
        opening=pv.Opening(
            proof=fri.FriProof(
                commit_phase_commits=[d(500)],
                query_proofs=[fri.QueryProof(
                    input_proof=[fri.BatchOpening(opened_values=[[1, 2, 3], [4, 5]],
                                                  opening_proof=[d(600)])],
                    commit_phase_openings=[fri.CommitPhaseStep(
                        sibling_value=ext(50), opening_proof=[d(700)])])],
                final_poly=[ext(60)], pow_witness=777),
            values=pv.OpeningValues(preprocessed=[adj], main=[[adj]],
                                    after_challenge=[[adj]],
                                    quotient=[[[ext(70), ext(80)]]])),
        per_air=[pv.AirProofData(air_id=0, log_degree=3,
                                 exposed_values_after_challenge=[[ext(90)]],
                                 public_values=[7, 8])],
        air_perm_by_height=[0], log_up_pow_witness=999)
    return codec.encode_proof(proof)


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
    blob = codec_blob()
    require(len(blob) == 665 and hashlib.sha256(blob).hexdigest()
            == CODEC_BLOB_SHA256, "codec blob")
    # tests/test_torch_prover.py's three-AIR instance on the card
    cfg = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=4,
                                        proof_of_work_bits=2))
    pk = stark.keygen([FibonacciAir(), FibonacciAir(), CubeAir(4)], cfg, device=dev)
    for on in (None, dev):  # canonical numpy traces, or Montgomery words on the card
        proof = stark.prove(pk, fixture_contexts(on), device=dev)
        proof_sha = hashlib.sha256(codec.encode_proof(proof)).hexdigest()
        require(proof_sha == FIXTURE_PROOF_SHA256, f"fixture proof sha {proof_sha}")
    stark.verify(pk.vk, proof)
    try:
        stark.verify(pk.vk, stark.prove(pk, fixture_contexts(None, 1), device=dev))
        wrong_public_fails = False
    except (stark.VerificationError, AssertionError) as e:
        wrong_public_fails = "constant" in str(e) or "constraint" in str(e)
    require(wrong_public_fails, "a wrong public value was accepted")
    # tests/test_torch_logup.py's sender/receiver pair: a LogUp phase
    pk = stark.keygen([SenderAir(), ReceiverAir()], cfg, device=dev)
    sends = np.array([3, 5, 5, 7, 3, 3, 9, 9], dtype=np.uint64)[:, None]
    table = np.array([[3, 3], [5, 2], [7, 1], [9, 2]], dtype=np.uint64)
    proof = stark.prove(pk, [stark.AirProvingContext(air_id=0, common_main=sends),
                             stark.AirProvingContext(air_id=1, common_main=table)],
                        device=dev)
    stark.verify(pk.vk, proof)
    sr_sha = hashlib.sha256(codec.encode_proof(proof)).hexdigest()
    require(sr_sha == SENDER_RECEIVER_PROOF_SHA256, f"sender/receiver proof sha {sr_sha}")
    # tests/test_torch_vm.py's VM proof of fib(10)
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, executors=FIB_EXECUTORS), device=dev)
    vm.keygen()
    exe = build_fib_program(10)
    proof, pre = vm.prove(exe)
    result = vm.verify(proof, expected_exe_commit=vm.commit_exe(exe), exe=exe)
    vm_sha = hashlib.sha256(codec.encode_proof(proof)).hexdigest()
    require(vm_sha == FIB10_PROOF_SHA256, f"fib(10) VM proof sha {vm_sha}")
    require(int.from_bytes(bytes(result["public_values"][:4]), "little") == fib(11),
            "fib(10) public value")
    pv_air = proof.per_air[vm.air_index["public_values"]]
    pv_air.public_values[0] = (pv_air.public_values[0] + 1) % P
    try:
        vm.verify(proof)
        tampered_fails = False
    except (stark.VerificationError, AssertionError):
        tampered_fails = True
    require(tampered_fails, "a tampered VM public value was accepted")
    emit({"phase": "pinned", "ok": True, "codec_blob_sha256": CODEC_BLOB_SHA256,
          "fixture_proof_sha256": proof_sha, "wrong_public_value_fails": True,
          "sender_receiver_proof_sha256": sr_sha, "fib10_vm_proof_sha256": vm_sha,
          "fib10_instret": pre.instret, "tampered_vm_public_value_fails": True})


def phase_variants(dev, rng) -> None:
    """Every kernel against its plain version at mid sizes."""
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

    # K2, zeros included (inv(0) = 0), a one-element operand broadcast
    ea, eb = words(rng, dev, 4096, 4), words(rng, dev, 4096, 4)
    ea[:7] = 0
    es = words(rng, dev, 4096)
    for name in ("mul", "add", "sub"):
        fn, plain = getattr(ef, name), getattr(ef, name + "_plain")
        errs[f"ext_{name}"] = max_abs_err(fn(ea, eb), plain(ea, eb))
        errs[f"ext_{name}/bcast"] = max_abs_err(fn(ea, eb[3]), plain(ea, eb[3]))
    errs["ext_scale"] = max_abs_err(ef.scale(ea, es), ef.scale_plain(ea, es))
    errs["ext_scale/bcast"] = max_abs_err(ef.scale(ea, es[5]), ef.scale_plain(ea, es[5]))
    errs["ext_inv"] = max_abs_err(ef.inv(ea), ef.inv_plain(ea))
    require(int(ef.inv(ea)[:7].abs().max()) == 0, "ext inv(0) != 0")
    errs["ext_powers/4099"] = max_abs_err(ef.powers(eb[9], 4099),
                                          ef.powers_plain(eb[9], 4099))

    # K7+K11: a random DAG of ~2,000 nodes at 2^12 rows, next_step 2
    nodes, roots = random_dag(rng, 1960)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    log_n, lqd = 11, 1
    prog = qmod.compile_dag(
        dag, n_main=2, has_preprocessed=True, has_perm=True,
        publics=bb.to_monty_np(rng.integers(0, P, size=3)),
        challenges=bb.to_monty_np(rng.integers(0, P, size=(2, 4))),
        exposed=bb.to_monty_np(rng.integers(0, P, size=(1, 4))))
    srcs = [words(rng, dev, 1 << (log_n + 1), w) for w in (3, 2, 2, 8)]
    srcs[1] = torch.cat([srcs[1], srcs[2]], dim=1)[:, :2]  # a column slice
    alpha = words(rng, dev, 4)
    errs["quotient/dag2k"] = max_abs_err(
        qmod.evaluate(prog, srcs, log_n, lqd, alpha),
        qmod.evaluate_plain(prog, srcs, log_n, lqd, alpha))
    fib_dag = stark.keygen([FibonacciAir()], StarkConfig(), device=dev).vk.per_air[0].dag
    fprog = qmod.compile_dag(fib_dag, n_main=1, has_preprocessed=False,
                             has_perm=False, publics=[1, 2, 3])
    fsrc = [words(rng, dev, 1 << 13, 2)]
    errs["quotient/fib"] = max_abs_err(qmod.evaluate(fprog, fsrc, 12, 0, alpha),
                                       qmod.evaluate_plain(fprog, fsrc, 12, 0, alpha))

    # K12, K13, K14 at 2^12; K12 on a column slice
    coeffs = words(rng, dev, 4096, 9)[:, 2:7]
    zp, geos = words(rng, dev, 4096, 4), words(rng, dev, 2, 4096)
    for npts in (1, 2):
        errs[f"open_dot/{npts}"] = max_abs_err(pv._open_dot(coeffs, zp, geos[:npts]),
                                               pv._open_dot_plain(coeffs, zp, geos[:npts]))
    mat, apows = words(rng, dev, 4096, 7)[:, 1:6], words(rng, dev, 6, 4)
    for npts in (1, 2):
        pts = [tuple(words(rng, dev, 4) for _ in range(3)) for _ in range(npts)]
        ro = words(rng, dev, 4096, 4)
        want = pv.reduced_open_plain(ro, mat, apows, pts)
        errs[f"reduced_open/{npts}"] = max_abs_err(
            pv.reduced_open(ro.clone(), mat, apows, pts), want)
    ev, beta, ro = words(rng, dev, 4096, 4), words(rng, dev, 4), words(rng, dev, 2048, 4)
    errs["fri_fold"] = max_abs_err(fri.fold_evals(ev, beta), fri.fold_evals_plain(ev, beta))
    errs["fri_fold/ro"] = max_abs_err(fri.fold_evals(ev, beta, ro),
                                      fri.fold_evals_plain(ev, beta, ro))
    errs["fri_fold/2"] = max_abs_err(fri.fold_evals(ev[:2], beta),
                                     fri.fold_evals_plain(ev[:2], beta))

    # K6 on a mixed-height tree: rows, paths and fold-style siblings
    mats = [words(rng, dev, h, w) for h, w in ((4096, 5), (1024, 3), (4096, 2), (256, 9))]
    tree = merkle.commit(mats)
    plan = merkle.GatherPlan()
    plan.add_tree(tree)
    plan.add_tree(tree, 3, rows=False)
    plan.add(ev, 1, 1)
    idx = rng.integers(0, 4096, size=84).tolist()
    errs["gather"] = max_abs_err(plan.run_device(idx), plan.run_plain(idx))

    # K7 columns mode: the random DAG's base roots over 2^12 natural rows
    tags = qmod._tags(dag, range(len(nodes)))
    base_roots = [r for r in range(len(nodes)) if tags[r] == "b"
                  and nodes[r][0] not in ("sel",)][-40:] + [0, 3]
    cprog = qmod.compile_columns(dag, base_roots, n_main=2, has_preprocessed=True,
                                 publics=bb.to_monty_np(rng.integers(0, P, size=3)))
    csrc = [s[:1 << 12] for s in srcs[:3]]
    cols = qmod.evaluate_columns(cprog, csrc, 12)
    errs["quotient_columns"] = max_abs_err(cols, qmod.evaluate_columns_plain(cprog, csrc, 12))

    # K9 and K10: a layout of 5 interactions in 3 chunks (0 to 4 fields, a
    # zero denominator), heights 1, 1000 (a partial block) and 2^21 (more
    # block totals than one scan pass)
    for n in (1, 1000, 1 << 21):
        table = np.asarray([(0, 2, 0, 1), (3, 0, 0, 0), (4, 4, 1, 1),
                            (9, 1, 2, 0), (11, 3, 2, 1)], dtype=np.int32)
        layout = logup.InteractionLayout(
            roots=list(range(15)), table=table,
            bus_m=bb.to_monty_np(np.asarray([1, 2, 7, 3, 0], dtype=np.uint64)), m=3, f_max=4)
        cols = words(rng, dev, 15, n)
        alpha, bpows = words(rng, dev, 4), words(rng, dev, 4, 4)
        cols[0, 0] = 0
        cols[1, 0] = 0
        alpha[1:] = 0
        alpha[0] = P - int(layout.bus_m[0])  # interaction 0, row 0: d = 0
        perm = logup.perm_cols(cols, layout, alpha, bpows)
        errs[f"perm_cols/{n}"] = max_abs_err(perm, logup.perm_cols_plain(cols, layout, alpha, bpows))
        got, want = logup.perm_scan(perm), logup.perm_scan_plain(perm)
        errs[f"perm_scan/{n}"] = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))

    # K8: random sends of all three kinds, canonical values small and large
    sends_tab = np.asarray([(lookup.RANGE, 0, 1, 1, 2), (lookup.BITWISE, 3, 4, 5, 2),
                            (lookup.TUPLE, 3, 4, 4, 6)], dtype=np.int32)
    layout = lookup.SendLayout(roots=list(range(7)), table=sends_tab)
    vals = rng.integers(0, 300, size=(7, 1 << 16)).astype(np.uint64)
    vals[1] = rng.integers(0, 33, size=1 << 16)
    vals[2] = rng.integers(0, 3, size=1 << 16)
    vals[6] = rng.integers(0, P, size=1 << 16)
    vals[:, :64] = rng.integers(0, P, size=(7, 64))
    cols = bb.monty(vals, device=dev)
    k_tabs = lookup.new_tables(1 << 16, 256 * 2048, dev)
    p_tabs = lookup.new_tables(1 << 16, 256 * 2048, dev)
    for _ in range(2):  # the second call adds into the first call's counts
        lookup.lookup_hist(cols, layout, k_tabs, 2048)
        lookup.lookup_hist_plain(cols, layout, p_tabs, 2048)
    errs["lookup_hist"] = max(max_abs_err(a, b) for a, b in zip(k_tabs, p_tabs))
    bad = {k: v for k, v in errs.items() if v}
    emit({"phase": "variants", "cases": len(errs), "mismatched": bad,
          "quotient_dag": {"nodes": len(nodes), "roots": len(roots),
                           "instructions": int(prog.code.shape[0]),
                           "slots": prog.n_slots}})
    require(not bad, f"kernel and plain disagree: {bad}")


def run_main(traces: list, cfg: StarkConfig) -> dict:
    """Path 1, through the port's public entry points."""
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
    gathered = merkle.gather_rows_device(tree, indices)  # one K6 launch
    t3 = time.perf_counter()
    dims = [(int(m.shape[0]), int(m.shape[1])) for m in tree.matrices]
    ok = merkle.verify_batch_queries(tree.root, dims, indices,
                                     gathered["mats"], gathered["sibs"])
    t4 = time.perf_counter()
    return {"monty": monty, "ldes": ldes, "tree": tree, "indices": indices,
            "ok": ok, "log_max": log_max, "dims": dims, "gathered": gathered,
            "s": {"to_monty_lde": t1 - t0, "commit": t2 - t1, "open": t3 - t2,
                  "verify": t4 - t3}}


def run_prove(dev, cfg: StarkConfig, airs, ctxs) -> dict:
    """Path 2: keygen -> prove -> verify through the port's entry points."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pk = stark.keygen(airs, cfg, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stages: dict = {}
    record: dict = {}
    proof = stark.prove(pk, ctxs, device=dev, stages=stages, record=record)
    t2 = time.perf_counter()
    stark.verify(pk.vk, proof)
    t3 = time.perf_counter()
    return {"pk": pk, "proof": proof, "stages_s": stages, "record": record,
            "s": {"keygen": t1 - t0, "prove": t2 - t1, "verify": t3 - t2}}


def run_vm(dev, cfg: StarkConfig) -> dict:
    """Path 3: VirtualMachine keygen -> prove -> verify of the fibonacci
    guest through the port's entry points."""
    vm = VirtualMachine(Rv32Config(stark=cfg, executors=FIB_EXECUTORS), device=dev)
    exe = build_fib_program(VM_FIB_N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vm.keygen()
    commit = vm.commit_exe(exe)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stages: dict = {}
    record: dict = {}
    proof, pre = vm.prove(exe, stages=stages, record=record)
    t2 = time.perf_counter()
    result = vm.verify(proof, expected_exe_commit=commit, exe=exe)
    t3 = time.perf_counter()
    launches = dict(_build.LAUNCHES)  # keygen, cold prove and verify
    # again, warm, as bench.py:91-96 re-measures a prove that took under a
    # third of its budget: the domain tables are built by now
    warm_stages: dict = {}
    warm, _ = vm.prove(exe, stages=warm_stages)
    t4 = time.perf_counter()
    require(codec.encode_proof(warm) == codec.encode_proof(proof),
            "a second prove of the same guest gave other bytes")
    return {"vm": vm, "exe": exe, "proof": proof, "pre": pre, "result": result,
            "stages_s": stages, "warm_stages_s": warm_stages, "record": record,
            "launches": launches,
            "s": {"keygen_and_commit_exe": t1 - t0, "prove": t2 - t1,
                  "verify": t3 - t2, "prove_warm": t4 - t3}}


def check_vm_kernels(vm, record: dict) -> dict:
    """K7 (columns mode), K8, K9, K10 and K7 (quotient) of path 3 against
    their plain versions on the prove's own inputs: every AIR's sends and
    permutation trace, the two widest AIRs' quotient."""
    lk = record["lookup"]
    range_h, tuple_total, sizes1 = lk["sizes"]
    p_tabs = lookup.new_tables(range_h, tuple_total, lk["tables"][0].device)
    cols_err, perm_err, scan_err = {}, {}, {}
    for name, prog, sources, log_n, layout in lk["airs"]:
        plain_cols = qmod.evaluate_columns_plain(prog, sources, log_n)
        cols_err[f"lookup/{name}"] = max_abs_err(
            qmod.evaluate_columns(prog, sources, log_n), plain_cols)
        lookup.lookup_hist_plain(plain_cols, layout, p_tabs, sizes1)
    hist_err = max(max_abs_err(a, b) for a, b in zip(lk["tables"], p_tabs))
    names = [a.name for a, vk in zip(vm.airs, vm.pk.vk.per_air)
             if vk.widths.after_challenge]
    for name, entry in zip(names, record["logup"]):
        prog, sources, log_n = entry["columns"]
        cols_err[f"logup/{name}"] = max_abs_err(
            qmod.evaluate_columns(prog, sources, log_n),
            qmod.evaluate_columns_plain(prog, sources, log_n))
        perm_err[name] = max_abs_err(entry["perm_scan"],
                                     logup.perm_cols_plain(*entry["perm_cols"]))
        got, want = logup.perm_scan(entry["perm_scan"]), logup.perm_scan_plain(entry["perm_scan"])
        scan_err[name] = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    widest = sorted(range(len(vm.airs)), key=lambda i: -vm.airs[i].width)[:2]
    q_err = {vm.airs[i].name: max_abs_err(qmod.evaluate(*record["quotient"][i]),
                                          qmod.evaluate_plain(*record["quotient"][i]))
             for i in widest}
    errs = {"quotient_columns": max(cols_err.values()), "lookup_hist": hist_err,
            "perm_cols": max(perm_err.values()), "perm_scan": max(scan_err.values()),
            "quotient": max(q_err.values())}
    require(all(v == 0 for v in errs.values()),
            f"kernel and plain differ on the VM prove's inputs: {cols_err} "
            f"{perm_err} {scan_err} {q_err} {errs}")
    return {"max": errs, "columns_airs": len(cols_err), "perm_airs": len(perm_err),
            "quotient_airs": {vm.airs[i].name: record["quotient"][i][2] for i in widest}}


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

    # ---- path 1: the segment commit ---------------------------------------
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
    path1 = ("bb_elementwise", "ntt", "poseidon2_hash_rows",
             "poseidon2_compress_layer", "gather")
    require(all(launches[k] for k in path1), f"a path-1 kernel never ran: {launches}")
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

    # ---- path 1 through the plain versions ----------------------------------
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
    plan = merkle.GatherPlan()
    plan.add_tree(tree)
    p_gather = plan.run_plain(main["indices"]).cpu().numpy().astype(np.uint64)
    k_gather = np.concatenate([a.reshape(-1) for a in
                               main["gathered"]["mats"] + main["gathered"]["sibs"]])
    err["gather"] = int(np.abs(p_gather.astype(np.int64) - k_gather.astype(np.int64)).max())
    require(all(v == 0 for v in err.values()), f"kernel and plain differ: {err}")
    require(p_root.tolist() == tree.root.tolist(), "plain root differs")
    emit({"phase": "plain", "root_equal": True, "max_abs_err": err,
          "s": time.perf_counter() - t0})
    del p_monty, p_ldes, p_layers

    # ---- path 2: keygen -> prove -> verify at full size ---------------------
    airs, ctxs = prove_inputs(PROVE_AIRS, SEED)
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    proved = run_prove(dev, cfg, airs, ctxs)
    p_launches = dict(_build.LAUNCHES)
    p_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    require(all(p_launches[k] for k in PATH2_KERNELS),
            f"a kernel of path 2 never ran: {p_launches}")
    # K7 and K6 again through their plain versions, on the prove's own
    # inputs: every AIR's program and sources, the whole query gather
    q_err = {f"{kind}/2^{lh}": max_abs_err(qmod.evaluate(*args), qmod.evaluate_plain(*args))
             for (kind, lh), args in zip(PROVE_AIRS, proved["record"]["quotient"])}
    plan, indices = proved["record"]["gather"]
    p_err = {"quotient": max(q_err.values()),
             "gather": max_abs_err(plan.run_device(indices), plan.run_plain(indices))}
    require(all(v == 0 for v in p_err.values()),
            f"kernel and plain differ on the prove's inputs: {q_err} {p_err}")
    blob = codec.encode_proof(proved["proof"])
    require(codec.encode_proof(codec.decode_proof(blob)) == blob, "codec round trip")
    fri_proof = proved["proof"].opening.proof
    require(len(fri_proof.query_proofs) == cfg.fri.num_queries
            and len(fri_proof.commit_phase_commits)
            == max(lh for _, lh in PROVE_AIRS), "FRI proof shape")
    emit({"phase": "prove", "airs": PROVE_AIRS,
          "rows": sum(1 << lh for _, lh in PROVE_AIRS),
          "queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "verified": True, "s": proved["s"], "stage_s": proved["stages_s"],
          "proof_bytes": len(blob), "proof_sha256": hashlib.sha256(blob).hexdigest(),
          "peak_gb": p_peak_gb, "launches": p_launches,
          "plain_max_abs_err": {"quotient": q_err, "gather": p_err["gather"],
                                "gather_jobs": len(plan.jobs)}})
    err = {**err, **{k: max(v, err.get(k, 0)) for k, v in p_err.items()}}

    # ---- path 3: the RV32IM VM proof of the fibonacci guest -----------------
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    vmr = run_vm(dev, cfg)
    v_launches = vmr["launches"]
    v_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    require(all(v_launches.values()), f"a kernel of path 3 never ran: {v_launches}")
    vm, vproof, pre = vmr["vm"], vmr["proof"], vmr["pre"]
    x2 = (0, 1)
    for _ in range(VM_FIB_N):
        x2 = (x2[1], (x2[0] + x2[1]) & 0xFFFFFFFF)
    require(pre.exit_code == 0 and vmr["result"]["public_values"][:4]
            == list(x2[1].to_bytes(4, "little")), "fib guest result")
    vblob = codec.encode_proof(vproof)
    require(codec.encode_proof(codec.decode_proof(vblob)) == vblob, "VM codec round trip")
    cells = sum((1 << pa.log_degree) * (vm.airs[pa.air_id].width
                                        + sum(vm.airs[pa.air_id].cached_main_widths))
                for pa in vproof.per_air)
    prove_s, warm_s = vmr["s"]["prove"], vmr["s"]["prove_warm"]
    v_checks = check_vm_kernels(vm, vmr["record"])
    err = {**err, **{k: max(v, err.get(k, 0)) for k, v in v_checks["max"].items()}}
    emit({"phase": "vm", "guest": f"build_fib_program({VM_FIB_N})",
          "executors": list(FIB_EXECUTORS), "insns": pre.instret,
          "queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "log_blowup": cfg.fri.log_blowup,
          "heights": {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in vproof.per_air},
          "s": vmr["s"], "stage_s": vmr["stages_s"],
          "warm_stage_s": vmr["warm_stages_s"], "verified": True,
          "insn_per_s": pre.instret / warm_s, "insn_per_s_cold": pre.instret / prove_s,
          "cells": cells, "cells_per_s": cells / warm_s,
          "cells_per_s_cold": cells / prove_s, "proof_bytes": len(vblob),
          "proof_sha256": hashlib.sha256(vblob).hexdigest(), "peak_gb": v_peak_gb,
          "launches": v_launches, "plain_checks": v_checks})

    kernels = timing(dev, setup, rng, main, err, traces, launches, proved,
                     ctxs, cfg, p_launches, vmr, v_launches)
    print(setup["nvidia_smi"].splitlines()[0], flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


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


def quotient_ops(prog) -> int:
    """The fewest operations per row for a quotient program's function: its
    node operations; the alpha fold with the powers of alpha precomputed
    (a base root is one scale and one add, an extension root one product
    and one add); per selector read, its difference with x, a batch
    inverse and the product with Z_H (Z_H and 1/Z_H take 2^lqd values, a
    table); and the 1/Z_H scale."""
    cost = {qmod.ADD_BB: ADD_OPS, qmod.SUB_BB: ADD_OPS, qmod.NEG_B: ADD_OPS,
            qmod.MUL_BB: MUL_OPS, qmod.ADD_EE: EXT_ADD, qmod.SUB_EE: EXT_ADD,
            qmod.NEG_E: EXT_ADD, qmod.MUL_EE: EXT_MUL, qmod.ADD_EB: ADD_OPS,
            qmod.SUB_EB: ADD_OPS, qmod.SUB_BE: EXT_ADD, qmod.MUL_EB: EXT_SCALE,
            qmod.FOLD_B: EXT_SCALE + EXT_ADD, qmod.FOLD_E: EXT_MUL + EXT_ADD}
    ops = sum(cost.get(int(op), 0) for op in prog.code[:, 0]) + EXT_SCALE
    for bit, with_inverse in ((1, True), (2, True), (4, False)):
        if prog.sel_mask & bit:
            ops += ADD_OPS + (BATCH_INV + MUL_OPS if with_inverse else 0)
    return ops


def reduced_open_ops(w: int, npts: int) -> int:
    """The fewest operations per row of K13: the column combination (w
    scales and adds), then per point z - x (a base sub), a batch inverse,
    p(z) - comb, two products (by the inverse and by alpha_pow) and the add
    into ro."""
    return w * (EXT_SCALE + EXT_ADD) + npts * (
        ADD_OPS + EXT_BATCH_INV + 2 * EXT_MUL + 2 * EXT_ADD)


def columns_cost(prog) -> tuple:
    """(distinct columns loaded, operations) per row of a columns program:
    its node operations, no fold and no selectors."""
    cost = {qmod.ADD_BB: ADD_OPS, qmod.SUB_BB: ADD_OPS, qmod.NEG_B: ADD_OPS,
            qmod.MUL_BB: MUL_OPS}
    loads = {(int(a) >> 1, int(b)) for op, _, a, b in prog.code if op == qmod.LOAD_B}
    return len(loads), sum(cost.get(int(op), 0) for op in prog.code[:, 0])


def perm_cols_ops(layout) -> int:
    """The fewest operations per row of K9: per interaction its fields'
    scales and adds, alpha + bus, a batch inverse, the count's scale and
    the add into its chunk."""
    return sum(int(nf) * (EXT_SCALE + EXT_ADD) + ADD_OPS + EXT_BATCH_INV
               + EXT_SCALE + EXT_ADD for nf in layout.table[:, 1])


def lookup_scatter(cols, layout, sizes) -> tuple:
    """The live sends' (index, count) pairs of one AIR over the three tables
    laid end to end, and the words the function must read (each send's
    count, and its fields where the count is live); for the index_add_
    yardstick and the bound."""
    range_h, tuple_h, sizes1 = sizes
    offsets = {lookup.RANGE: 0, lookup.BITWISE: range_h,
               lookup.TUPLE: range_h + lookup.BITWISE_BINS}
    limit = {lookup.RANGE: range_h, lookup.BITWISE: lookup.BITWISE_BINS,
             lookup.TUPLE: tuple_h}
    c = bb.from_monty_plain(cols).long()
    idxs, cnts, words = [], [], 0
    for kind, rx, ry, rz, rc in layout.table.tolist():
        x, y, cnt = c[rx], c[ry], c[rc]
        if kind == lookup.RANGE:
            high = torch.bitwise_left_shift(torch.ones_like(y), torch.clamp(y, max=30))
            idx = torch.where(y == 0, 0, (high - 1 + x) & 0xFFFFFFFF)
        elif kind == lookup.TUPLE:
            idx = (x * sizes1 + y) & 0xFFFFFFFF
        else:
            idx = ((x * 256 + y) * 2 + c[rz]) & 0xFFFFFFFF
        live = cnt != 0
        words += int(cnt.numel()) + int(live.sum()) * (3 if kind == lookup.BITWISE else 2)
        keep = live & (idx < limit[kind])
        idxs.append(idx[keep] + offsets[kind])
        cnts.append(cnt[keep])
    return torch.cat(idxs), torch.cat(cnts), words


def timing(dev, setup, rng, main, err, traces, launches, proved, ctxs, cfg,
           p_launches, vmr, v_launches) -> list:
    """Each kernel and its plain version at the paths' shapes."""
    tree = main["tree"]
    # ---- path 1 kernels: K1 to_monty of the widest trace; K3 the LDE of the
    # tallest batch; K4 the leaf hash; K5 the top layer with injection
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

    # ---- path 2 kernels at the prove's shapes: K6 the prove's whole query
    # gather; K7 the prove's own quotient inputs of FibonacciAir at 2^22;
    # the others on FibonacciAir at 2^22
    gplan, gidx = proved["record"]["gather"]
    g_words = len(gidx) * sum(int(m.shape[1]) for m, _, _ in gplan.jobs)
    qargs = proved["record"]["quotient"][0]
    prog, nq = qargs[0], 1 << (qargs[2] + qargs[3])
    fib_dev = bb.to_monty(bb.from_numpy(ctxs[0].common_main.astype(np.uint32), device=dev))
    log_n = int(fib_dev.shape[0]).bit_length() - 1
    fib_lde, fib_coeffs = ntt.coset_lde(fib_dev, 1, return_coeffs=True)
    zeta = words(rng, dev, 4)
    zpows = ef.powers(zeta, nq)
    g_n = bb.two_adic_generator_int(log_n)
    geos = torch.stack([bb.from_numpy(pv._geo_series(m, nq), device=dev)
                        for m in (1, g_n)])
    apows = words(rng, dev, 3, 4)
    pts = [tuple(words(rng, dev, 4) for _ in range(3)) for _ in range(2)]
    ro0 = words(rng, dev, 2 * nq, 4)
    fold_in, beta = words(rng, dev, 2 * nq, 4), words(rng, dev, 4)
    errs = {
        "ext_elementwise": max_abs_err(zpows, ef.powers_plain(zeta, nq)),
        "open_dot": max_abs_err(pv._open_dot(fib_coeffs, zpows, geos),
                                pv._open_dot_plain(fib_coeffs, zpows, geos)),
        "fri_reduced_open": max_abs_err(
            pv.reduced_open(ro0.clone(), fib_lde, apows, pts),
            pv.reduced_open_plain(ro0, fib_lde, apows, pts)),
        "fri_fold": max_abs_err(fri.fold_evals(fold_in, beta),
                                fri.fold_evals_plain(fold_in, beta)),
    }
    err = {**err, **errs}
    require(all(v == 0 for v in errs.values()), f"kernel and plain differ: {errs}")
    w_f = int(fib_lde.shape[1])
    ro_k = ro0.clone()

    # ---- path 3 kernels at the VM prove's own inputs: rv32_base_alu, the
    # tallest AIR (2^20 rows), its interaction columns, permutation
    # columns and scan, and its lookup sends
    vm, rec = vmr["vm"], vmr["record"]
    alu = vm.air_index["rv32_base_alu"]
    with_perm = [i for i, vk in enumerate(vm.pk.vk.per_air) if vk.widths.after_challenge]
    lentry = rec["logup"][with_perm.index(alu)]
    c_prog, c_src, c_log_n = lentry["columns"]
    n_alu = 1 << c_log_n
    c_loads, c_ops = columns_cost(c_prog)
    k9_args = lentry["perm_cols"]
    k9_layout = k9_args[1]
    m_alu = k9_layout.m
    perm_in = lentry["perm_scan"]
    row_sums = perm_in.long().reshape(n_alu, m_alu, 4).sum(dim=1)
    lk = rec["lookup"]
    _, h_prog, h_src, h_log_n, h_layout = next(a for a in lk["airs"]
                                               if a[0] == "rv32_base_alu")
    h_cols = qmod.evaluate_columns(h_prog, h_src, h_log_n)
    h_idx, h_cnt, h_words = lookup_scatter(h_cols, h_layout, lk["sizes"])
    range_h, tuple_total, sizes1 = lk["sizes"]
    h_tabs = lookup.new_tables(range_h, tuple_total, dev)
    h_table_words = sum(int(x.numel()) for x in h_tabs)
    flat_tab = torch.zeros(h_table_words, dtype=torch.int64, device=dev)
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
        ("ext_elementwise", "ext.cu", "openvm_tpu/field/ext.py:72",
         lambda: ef.powers(zeta, nq), lambda: ef.powers_plain(zeta, nq), 5, 1,
         nq * 16, nq * EXT_MUL, [nq, 4]),
        ("gather", "gather.cu", "openvm_tpu/merkle.py:118",
         lambda: gplan.run_device(gidx), lambda: gplan.run_plain(gidx), 20, 3,
         g_words * 8, 0, [len(gidx), len(gplan.jobs)]),
        ("quotient", "quotient.cu", "openvm_tpu/stark/evaluator.py:29",
         lambda: qmod.evaluate(*qargs), lambda: qmod.evaluate_plain(*qargs), 5, 1,
         nq * (w_f * 4 + 16 + 4), nq * quotient_ops(prog),
         [nq, int(prog.code.shape[0])]),
        ("open_dot", "open.cu", "openvm_tpu/stark/prover.py:232",
         lambda: pv._open_dot(fib_coeffs, zpows, geos),
         lambda: pv._open_dot_plain(fib_coeffs, zpows, geos), 10, 1,
         nq * (w_f * 4 + 16 + 2 * 4), nq * 2 * (EXT_SCALE + w_f * (EXT_SCALE + EXT_ADD)),
         [nq, w_f, 2]),
        ("fri_reduced_open", "fri.cu", "openvm_tpu/stark/prover.py:773",
         lambda: pv.reduced_open(ro_k, fib_lde, apows, pts),
         lambda: pv.reduced_open_plain(ro0, fib_lde, apows, pts), 5, 1,
         2 * nq * (w_f * 4 + 32 + 4),
         2 * nq * reduced_open_ops(w_f, 2),
         [2 * nq, w_f, 2]),
        ("fri_fold", "fri.cu", "openvm_tpu/fri.py:78",
         lambda: fri.fold_evals(fold_in, beta),
         lambda: fri.fold_evals_plain(fold_in, beta), 20, 2,
         2 * nq * 16 + nq * (16 + 8), nq * (EXT_ADD * 2 + EXT_SCALE + EXT_MUL + ADD_OPS),
         [2 * nq, 4]),
        ("quotient_columns", "quotient.cu", "openvm_tpu/stark/logup.py:155",
         lambda: qmod.evaluate_columns(c_prog, c_src, c_log_n),
         lambda: qmod.evaluate_columns_plain(c_prog, c_src, c_log_n), 10, 1,
         n_alu * (c_loads + c_prog.n_roots) * 4, n_alu * c_ops,
         [n_alu, c_prog.n_roots, int(c_prog.code.shape[0])]),
        ("perm_cols", "logup.cu", "openvm_tpu/stark/logup.py:247",
         lambda: logup.perm_cols(*k9_args), lambda: logup.perm_cols_plain(*k9_args),
         5, 1, n_alu * (len(k9_layout.roots) + 4 * m_alu) * 4,
         n_alu * perm_cols_ops(k9_layout), [n_alu, len(k9_layout.roots), m_alu]),
        ("perm_scan", "logup.cu", "openvm_tpu/stark/logup.py:328",
         lambda: logup.perm_scan(perm_in), lambda: logup.perm_scan_plain(perm_in),
         10, 2, n_alu * (8 * m_alu + 4) * 4, n_alu * (m_alu + 1) * EXT_ADD,
         [n_alu, 4 * m_alu]),
        ("lookup_hist", "lookup.cu", "openvm_tpu/stark/evaluator.py:253",
         lambda: lookup.lookup_hist(h_cols, h_layout, h_tabs, sizes1),
         lambda: lookup.lookup_hist_plain(h_cols, h_layout, h_tabs, sizes1), 10, 2,
         (h_words + 2 * h_table_words) * 4,
         h_words * MUL_OPS + int(h_cnt.numel()) * (3 * ADD_OPS + 1),
         [n_alu, int(h_layout.table.shape[0])]),
    ]
    library = {
        "perm_scan": (lambda: torch.cumsum(row_sums, dim=0),
                      "torch.cumsum of the int64 row sums: the prefix sum without "
                      "its reduction mod p or the concatenation"),
        "lookup_hist": (lambda: flat_tab.index_add_(0, h_idx, h_cnt),
                        "index_add_ of the live sends' precomputed indices and "
                        "counts into the three tables laid end to end: the "
                        "scatter without the index arithmetic"),
    }
    t_open_row = time.perf_counter()
    idx = main["indices"]
    for i in idx:
        merkle.open_row(tree, i)
    t_open_row = time.perf_counter() - t_open_row
    t_gather = time.perf_counter()
    merkle.gather_rows_device(tree, idx)
    t_gather = time.perf_counter() - t_gather
    kernels = []
    for name, src, replaces, fn, plain, reps, plain_reps, nbytes, ops, shape in cases:
        ms, host_ms = cuda_ms(fn, reps, host=True)
        plain_ms = cuda_ms(plain, plain_reps)
        b_ms, b_by = bound(nbytes, ops)
        lib_fn, lib_what = library.get(name, (None, NO_LIBRARY + (
            " (a modular dot product has no torch call)" if name == "open_dot" else "")))
        kernels.append({
            "name": name, "route": "cuda", "source": f"openvm_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": v_launches[name],
            "launches_path2": p_launches[name], "launches_path1": launches[name],
            "max_abs_err": err[name], "ms": ms, "host_enqueue_ms": host_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lib_fn, 10) if lib_fn else None, "library": lib_what,
            "shape": shape, "bytes": nbytes, "ops": ops})
    # path 1's stages again, warm: the NTT tables are cached now
    warm_ms = {"to_monty_lde": cuda_ms(lambda: ntt.batched_coset_ldes(
                   [bb.to_monty(t) for t in traces], cfg.fri.log_blowup), 3),
               "commit_layers": cuda_ms(lambda: merkle.commit_layers(main["ldes"]), 3)}
    emit({"phase": "timing", "nvidia_smi": setup["nvidia_smi"],
          "stage_warm_ms": warm_ms,
          "open_84_s": {"open_row_x84": t_open_row, "gather_rows_device": t_gather},
          "kernels": {k["name"]: {"kernel_ms": k["ms"], "host_enqueue_ms": k["host_enqueue_ms"],
                                  "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"]}
                      for k in kernels}})
    return kernels


if __name__ == "__main__":
    sys.exit(main())
