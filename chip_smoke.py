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
  variants  every kernel and every coset_lde argument, kernel against
            plain, mid-size; K3 at heights around its 2^11-row tile (2^10 to
            2^12, 2^21, 2^22) and widths 1 to 257, K4 at widths 0 to 101 on
            row counts that are not a multiple of its block; K7 on random
            DAGs up to the shared launch's slot limit, past it and past its
            code limit (compiled at the budget: the streamed launch, each in
            its own launch, in the quotient and the columns mode), on a
            leaf-heavy DAG at budgets of 16 and 24 words and a columns
            program at 8 (reloads of every kind of leaf), on one launch over
            a job table of heights
            2^1 to 2^12, lqd 0 and 1, and on a table mixing both modes (two
            launches), on Poseidon2Air's program over a random 2^16-row
            trace, and in the columns mode with the natural selectors; K5's
            tail on trees of 2^1 to 2^14 leaves with
            injections at every height, at tails of 2, 64 and 512 digests;
            K12 on one table of widths 1 to 380, heights 2^1 to 2^22, one
            and two points and column slices; K13 in one launch over a
            table of heights 2^1 to 2^12 (1 to 6 matrices a height, widths
            1 to 64, 1 to 3 distinct points, column slices, one zero
            denominator); K14 at every height 2^1 to 2^23, with and without
            ro; K2's power series at n = 0 to 2^22 + 3 around its blocks,
            u random, 0 and 1, one launch a series; K6 on mixed heights,
            column slices, widths 0 to 20, flips and shifts at q = 1 and 84,
            a 2^23-row source, no jobs and 2,100 jobs, through run_device
            and through run's pinned copy; K9 in one launch over a job
            table of heights 1 to 2^21 (0 to 9 fields, m = 1 to 13 chunks,
            zero denominators at a row's first, middle and last
            interaction and on a whole row) and with
            alpha zeroing a field-less interaction; K10 at m = 1 to 12
            chunks, heights off its 256-row tile and 16,385 tiles; K8 in
            one launch over AIRs of 2^20, 1000 and 1 rows with skewed
            sends, counts that wrap, indices at and past each table's edge
            and wrapping indices
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
            84 queries and 16 PoW bits; the proof's SHA-256 pinned
            (PROVE_PROOF_SHA256); one K13 launch, and no host table of the
            FRI fold or of LDE points past the tallest quotient domain built
            by the prove; one K2 power series and one K6 launch a prove, no
            elementwise K2 launch (nor on paths 1 and 3); the prove's own
            quotient inputs and query gather are run again through the
            plain versions
  vm        path 3, the RV32IM VM proof: VirtualMachine keygen -> prove ->
            verify of the fibonacci guest build_fib_program(200,000), about
            1.0 M instructions (rv32_base_alu 800 k rows, padded to 2^20),
            with FIB_EXECUTORS and the production profile (84 queries, 16
            PoW bits, log_blowup 1); stage seconds, insn/s, trace cells/s;
            the proof's SHA-256 pinned (VM_PROOF_SHA256); one K8, one K9,
            one K13, one K2 power series and one K6 launch a prove; then
            K8's tables and every AIR's K9
            columns
            and K10 scan from the prove against plain, K7
            on all 15 AIRs' quotient in one launch (LogUp roots included)
            K12 on every matrix's openings in one table and K13 on every
            matrix's reduced openings in one launch against their plain
            versions, and K6 on the prove's whole query gather, on the
            prove's own inputs
  vm_profile one more warm prove of path 3 under torch.profiler: each
            kernel's summed device ms and launches, the device's busy and
            idle share of the prove, and each kernel's path-3 bound: the
            sum of its launches' bounds at their own shapes
  continuations
            path 4, the persistent-memory VM's continuations:
            VirtualMachine(persistent=True) keygen -> execute_metered ->
            prove_continuations -> verify_segments of
            build_fib_program(600,000), 3,000,017 instructions, segmented
            at a height cap of 2^20 - 10,000 rows (fib_e2e's segments at the
            reference's margin): 3 segments, every executor trace at most
            2^20 rows; the final public value, read through the memory
            tree's public-values proof, is fib(600,001) mod 2^32; stage
            seconds per segment and summed, insn/s cold and warm (a second
            run must give the same bytes), the peak device memory above
            the phase's start (at most 1.2 times path 3's), each segment
            proof's bytes and SHA-256 (pinned, CONTINUATION_PROOF_SHA256);
            every kernel but the elementwise K2 launched, two quotient
            launches (Poseidon2Air's streamed) and one K8, K9, K13, K2
            series and K6 launch a segment; K7 over a segment's 16 AIRs
            with and without Poseidon2Air
  debug     stark.debug.check_constraints on the card (K7's columns mode
            with the natural selectors) over one segment of
            build_fib_program(20,000) at a 2^14-row cap: no failure; with
            one Poseidon2Air cell changed, the failures the plain version
            reports on the CPU
  timing    each kernel and its plain version at the paths' shapes; K3 also
            in the prove's form (return_coeffs), K4 and K5 also against the
            issue rate of the SASS they run (cuobjdump); K5 over the whole
            compress phase of path 1's main tree and of a 2^20-leaf FRI tree
            at tail thresholds of 64 to 512 digests and layer by layer; K7
            on path 3's own rv32_base_alu quotient input and on the prove's
            one launch over all 15 AIRs, and its streamed launch at 2^16
            rows; K12 and K13 on path 3's own tables; K8 and K9 on
            path 3's own one-launch inputs, with the skew of its sends and
            the host seconds of compiling the columns programs; K2's power
            series at path 3's length and K6 on path 2's and path 3's
            plans, with the host ms of one whole run and of building the
            plan; K10's
            yardstick
            torch.cumsum on the inner dimension of the (4, N) row sums (and
            on the outer dimension of (N, 4), the earlier reading); each
            device time with the card
            kept busy while the host enqueues, and beside it the reading
            whose events span the host's enqueue (ms_host)
  keccak    path 5, the keccak256 extension through continuations:
            VirtualMachine(keccak=True, persistent=True) keygen ->
            execute_metered -> prove_continuations -> verify_segments of
            build_keccak_iter_program(10,000), 30,009 instructions, at a cap
            of 20 M trace cells (the metered count's: one keccakf row a hash):
            2 segments, keccakf 2^17 rows each; the final public values
            (digest words 0 and 7 of the iterated keccak256) through the
            memory tree's public-values proof; stages, insn/s and blocks/s
            cold and warm (the same bytes twice), peak memory, the segment
            proofs' SHA-256 (KECCAK_PROOF_SHA256); two quotient launches a
            segment (Poseidon2Air, keccakf and keccak_sponge in K7's
            streamed launch) and one K8, K9, K13, K2 series and K6 launch;
            K7's launch plan; every kernel against plain on segment 0's own
            inputs (keccakf's quotient on its first and last 2^14 rows, the
            last block's next rows wrapping to the first); K7's streamed
            launch timed on segment 0's keccakf and keccak_sponge jobs
            beside its bound and the global-memory mode's figure, keccakf and
            keccak_sponge compiled at budgets of 48 to 384 words, each
            against plain on its first 2^14 rows
  sha256    path 6, the sha256 extension: VirtualMachine(sha256=True)
            keygen -> prove -> verify of build_sha256_iter_program(4,000),
            12,009 instructions (Sha256Air 2^18 rows), one cold prove; the
            public values against hashlib, the proof's SHA-256
            (SHA_PROOF_SHA256), stages, insn/s, blocks/s, peak memory, K7's
            two launches (sha256's two programs streamed), each part alone,
            every kernel against plain on the prove's own inputs
  u256      path 7, sha256 with the int256 and modular-arithmetic
            extensions: VirtualMachine(sha256=True, bigint=True,
            moduli=(secp256k1's p, n)) keygen -> prove -> verify of
            build_u256_iter_program(1,024), 67,630 instructions (54,274
            int256 ops, 10,240 modular ops, 1,024 sha256 blocks), one cold
            prove; every extension chip at its pinned height
            (U256_LOG_HEIGHTS), the public values against
            u256_iter_reference, the proof's SHA-256 (U256_PROOF_SHA256),
            stages, insn/s, u256 ops/s, peak memory; K7's two launches
            (the 14 extension programs streamed: its plan checked),
            rv32_base_alu's job equal in either launch, the streamed launch
            alone and the shared one without it against their bounds;
            every kernel against plain on the prove's own inputs
  ecrecover path 8, the short-Weierstrass ECC extension with keccak and the
            modular chips of secp256k1's p and n and the default (full
            RV32IM) executors: VirtualMachine keygen -> prove -> verify of
            build_ecrecover_program(64), the EVM's ecrecover over 64
            signatures (360,528 instructions, 28,612 EC ops), one cold
            prove; instructions, EC and modular rows and keccak blocks equal
            to ecrecover_counts, a real row in every RV32IM chip, the
            pinned heights (ECRECOVER_LOG_HEIGHTS), the public values
            against ecrecover_reference, the proof's SHA-256
            (ECRECOVER_PROOF_SHA256), stages and each ECC chip's tracegen
            seconds, insn/s, signatures/s, EC ops/s, peak memory; K7's two
            launches (the ten extension programs streamed), the streamed
            launch alone with its jobs and the shared one without it
            against their bounds; every kernel against plain on the
            prove's own inputs
  pairing   path 9, BN254 pairing checks on the Fp2 chips, with BN254's
            modular chips and the default executors: VirtualMachine
            keygen -> prove -> verify of build_pairing_program(2), the
            Miller loop and residue check over two inputs of four finite,
            valid pairs (60,127 instructions, 48,222 Fp2 ops, two
            HintFinalExp phantoms), one cold prove;
            instructions and Fp2 and modular rows equal to pairing_counts,
            the pinned heights (PAIRING_LOG_HEIGHTS), the public values
            (every check held, c's words) against pairing_reference, the
            proof's SHA-256 (PAIRING_PROOF_SHA256), stages, the Fp2 chips'
            tracegen seconds and the hints' host seconds, insn/s, checks/s,
            Fp2 ops/s, peak memory; K7's two launches (the five extension
            programs streamed), the streamed launch alone with its jobs and
            the shared one without it against their bounds; every kernel
            against plain on the prove's own inputs
  native    path 10, the native (recursion) VM: VirtualMachine(
            NativeConfig's chips) keygen -> prove -> verify of
            build_native_query_program(84, 21, 20), the FRI query phase
            of a leaf verifier (84 queries in a runtime loop, each a
            VERIFY_BATCH of depth 21 over 56 opened felts, a
            FRI_REDUCED_OPENING and 20 FRI layers, each a VERIFY_BATCH
            and a fold in extension arithmetic; 92,224 instructions,
            21,841 Poseidon2 rows), one cold prove; instructions and every
            chip's rows equal to native_query_counts, a real row in every
            native executor chip, the pinned heights (NATIVE_LOG_HEIGHTS),
            the 8 public values against native_query_reference, the
            proof's SHA-256 (NATIVE_PROOF_SHA256), stages and each native
            chip's tracegen seconds, insn/s, queries/s, peak memory; K7's
            two launches (six programs streamed), the streamed launch
            alone with its jobs and the shared one without it against
            their bounds; every kernel against plain on the prove's own
            inputs
  leaf      path 11, the leaf verifier: build_leaf_program over path 4's
            first segment proof (its VM's verifying key and log degrees;
            no app prove again) and serialize_proof_felts, then
            VirtualMachine(NativeConfig(num_native_pvs=44)) keygen ->
            commit_exe -> prove -> verify of that program at natural heights
            and the production profile, one cold prove: the leaf program
            verifies the segment's STARK proof inside the native VM (about
            280,000 instructions, 40,000 host Poseidon2 permutations in
            the preflight); the 44 public values against the reference's
            leaf layout read from the segment's own proof (its program
            commitment, the connector's and the memory tree's public
            values, zeros), the proof's SHA-256 (LEAF_PROOF_SHA256), every
            height within static_height_profile, the segment's proof with
            one quotient-commitment felt changed refused by the leaf
            program's preflight; stages (build, serialize, preflight and
            its host permutations, tracegen, prove, keygen and commit_exe,
            verify, plain checks), insn/s, app proofs/s, each chip's rows
            and heights, peak memory; K7's two launches (six programs
            streamed), the streamed launch alone with its jobs and the
            shared one without it against their bounds; every kernel
            against plain on the prove's own inputs

then a {"kernels": [...]} line (each kernel's launches on paths 1 to 11, its
__global__ entries, and K7's streamed launch on path 5's shapes) and, last,
{"ok": true, "device": {...}}.
Any failure raises and exits non-zero before the last line.  The kernels
compute over integers, so every comparison is exact equality.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from openvm_tpu_torch import _build, fri, merkle, ntt, poseidon2 as p2, stark
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.field import ext as ef
from openvm_tpu_torch.native_compiler import (build_leaf_program, serialize_proof_felts,
                                              static_height_profile)
from openvm_tpu_torch.stark import codec, logup, lookup, prover as pv, quotient as qmod
from openvm_tpu_torch.stark.config import FriParameters, StarkConfig
from openvm_tpu_torch.stark.debug import check_constraints
from openvm_tpu_torch.stark.symbolic import SymbolicDag
from openvm_tpu_torch.vm.circuit.poseidon2_chip import Poseidon2Air
from openvm_tpu_torch.vm.guest import (BN254_P, ECRECOVER_MODULI, FIB_EXECUTORS,
                                       SECP256K1_CURVE, U256_MODULI,
                                       build_ecrecover_program, build_fib_program,
                                       build_keccak_iter_program,
                                       build_native_query_program, build_pairing_program,
                                       build_sha256_iter_program,
                                       build_u256_iter_program, ecrecover_counts,
                                       ecrecover_reference, ecrecover_stream, fib,
                                       iter_insns, native_query_counts,
                                       native_query_reference, native_query_stream,
                                       pairing_counts, pairing_reference,
                                       pairing_stream, u256_iter_counts,
                                       u256_iter_reference)
from openvm_tpu_torch.vm.machine import (FULL_EXECUTORS, NATIVE_EXECUTORS, NativeConfig,
                                         Rv32Config, VirtualMachine)
from openvm_tpu_torch.vm.interpreter import ExecutionError
from openvm_tpu_torch.vm.memory_tree import pv_proof, verify_pv_proof
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

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
# The full-size proofs of the prove phase (path 2, 958,433 bytes) and of the
# vm phase (path 3, 1,221,209 bytes) as the slice-3 kernels made them on
# the H100: every later kernel change is held to the same bytes.
PROVE_PROOF_SHA256 = \
    "61fc23a45089327e5b372489bbd451502832fc1fe577038e7559a6895ec7ae91"
VM_PROOF_SHA256 = \
    "ed00812571abd6d0b592d2147a6f505e0198a3064724a41ca63e37d87e7de1e3"
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))

# Path 3: the fibonacci guest's loop count; 5 instructions an iteration.
VM_FIB_N = 200_000
# Path 4: the fibonacci guest in persistent memory, proved in continuation
# segments of fib_e2e's 2^20 rows (SURVEY.md:568) with the reference's
# margin of 10,000 rows under the cap (SURVEY.md:569): 3,000,017
# instructions (``fib_insns``), 4 ALU rows and 1 branch row an iteration,
# 3 segments.
CONT_FIB_N = 600_000
CONT_LIMITS = {"max_height": (1 << 20) - 10_000}
CONT_SEGMENTS = 3
# The SHA-256 of path 4's segment proofs (1,438,817, 1,438,817 and
# 1,375,281 bytes) as this script's first run of path 4 on the H100 made
# them: every later change is held to the same bytes.
CONTINUATION_PROOF_SHA256 = (
    "fe61a5df2b66e5485e8824190318993f5e51898dc44c6c6caada3c1ff49a7a68",
    "c59c9351528c43f97929662855edcbb33cae5eaffc0d30c4240ed7084d2f560c",
    "dca8f075362035ea89b85630d335c05db55dcac836446fe5ee62c913a8af15c2")
# Path 5: the keccak-iteration guest in persistent memory through
# continuations, the reference's keccak workload (bench.py:161-182 proves
# its keccak256 guest ELF, not in this repository, that way): 10,000
# keccak256 hashes of a 32-byte buffer in place, 30,009 instructions.  The
# metered segmentation (the JAX package's, copied) counts one keccakf row a
# hash where the trace has 24 (2,633 + 1,253 + 74 cells a hash counted), so
# the cells' cap splits the run: 2 segments, 5,332 hashes in the first
# (keccakf 127,968 rows, padded to 2^17), 4,668 in the second (2^17).  Until
# path 8 came, 30,000 hashes at an 80 M cap (keccakf 2^19 and 2^18): the
# whole script then took 1,106 s, and 1,001 s at 15,000 hashes (PERF.md).
KECCAK_ITER_N = 10_000
KECCAK_LIMITS = {"max_height": (1 << 20) - 10_000, "max_cells": 20_000_000}
KECCAK_SEGMENTS = 2
KECCAK_LOG_HEIGHTS = ({"keccakf": 17, "keccak_sponge": 13}, {"keccakf": 17, "keccak_sponge": 13})
# Digest words 0 and 7 after keccak256 is applied KECCAK_ITER_N times to 32
# zero bytes (vm.circuit.keccak.keccak256): the guest's public values.
KECCAK_ITER_PVS = [6, 123, 68, 203, 53, 119, 168, 205]
# The SHA-256 of path 5's segment proofs (3,007,089 bytes each) as this
# script's first run of path 5 at KECCAK_ITER_N on the H100 made them:
# every later change is held to the same bytes.
KECCAK_PROOF_SHA256 = (
    "ff8ec00e8fbf002fe93de0106a87ee1af4a7d85045e9228aac5167527b59df8a",
    "601504b69cf246760b3224d21b322a9805914e482d404d8809fdad16c63f1cd8")
# Path 6: the sha256-iteration guest in volatile memory, one cold prove (no
# warm one: the script's time): 4,000 sha256 hashes of a 32-byte buffer in
# place (Sha256Air 256,000 rows, sha256_sponge 4,000: 2^18 and 2^12).
SHA_ITER_N = 4_000
SHA_LOG_HEIGHTS = {"sha256": 18, "sha256_sponge": 12}
# The SHA-256 of path 6's proof (1,612,265 bytes) as this script's first
# run of path 6 on the H100 made it.
SHA_PROOF_SHA256 = "66d9903b23013e70426123364fbcf18984eca0bdb57529d1830fb052a031e3a8"
# Path 7: the sha256 + u256 guest in volatile memory, one cold prove:
# BASELINE.json's config 3 ("sha256 + u256/bigint guest mixing multiple
# extension chips per proof") with the modular chips of secp256k1's two
# moduli (config 4's).  U256_ITER_N iterations of a sha256 block, 44 int256
# ALU-type ops, six 256-bit branches, three masking ops and five modular
# ops a modulus (vm.guest.build_u256_iter_program).  At 2,048 iterations
# the whole script took 912.8 s of command time (PERF.md): 1,024 keep
# int256_alu at 23,553 rows, 2^15.
U256_ITER_N = 1_024
U256_CONFIG = dict(executors=FIB_EXECUTORS, sha256=True, bigint=True, moduli=U256_MODULI)
U256_LOG_HEIGHTS = {"sha256": 16, "sha256_sponge": 10, "int256_alu": 15,
                    "int256_shift": 14, "int256_lt": 13, "int256_mul": 12,
                    "int256_blt": 12, "int256_beq": 11,
                    **{f"modular_{kind}_{k}": lh for k in (0, 1)
                       for kind, lh in (("addsub", 11), ("muldiv", 11), ("iseq", 10))}}
# The programs of K7's streamed launch on path 7: every extension AIR's.
U256_STREAMED = tuple(U256_LOG_HEIGHTS)
# The SHA-256 of path 7's proof (4,423,001 bytes) as this script's first
# run of path 7 at U256_ITER_N on the H100 made it.
U256_PROOF_SHA256 = "5adef6d64193ba1fc63322b1eec849427815f530243a5a553e9a31230c823591"
# Path 8: the ecrecover guest in volatile memory, one cold prove: BASELINE.json's
# config 4 ("ECDSA verify guest (k256 ECC MSM + modular arithmetic chips)"),
# the reference's ecrecover bench (SURVEY.md:571), in the JAX package's
# ecrecover config (tests/test_real_elf_breadth.py:193-196): the default
# executors, keccak, the modular chips of secp256k1's p and n and the curve.
# ECRECOVER_N signatures, each from its own seeded key: about 5,630
# instructions, 255 EC_DOUBLE and 190 EC_ADD_NE a signature.  At 128
# signatures the phase took 161.4 s of command time, past the 150 s it may
# take (PERF.md), so it runs 64: sw_add_ne_0 and sw_double_0 2^14 rows.
ECRECOVER_N = 64
ECRECOVER_SEED = SEED
ECRECOVER_CONFIG = dict(executors=FULL_EXECUTORS, keccak=True, moduli=ECRECOVER_MODULI,
                        curves=(SECP256K1_CURVE,))
ECRECOVER_LOG_HEIGHTS = {"rv32_base_alu": 17, "rv32_load_store": 16, "rv32_shift": 16,
                         "rv32_branch_eq": 15, "rv32_branch_lt": 15, "rv32_div_rem": 15,
                         "rv32_mul": 14, "rv32_hint_store": 12, "rv32_jal_lui": 9,
                         "rv32_jalr": 9, "rv32_auipc": 7, "rv32_less_than": 6,
                         "range_tuple": 19, "sw_add_ne_0": 14, "sw_double_0": 14,
                         "keccakf": 11, "keccak_sponge": 6, "modular_muldiv_0": 8,
                         "modular_muldiv_1": 8, "modular_addsub_0": 7, "modular_addsub_1": 6,
                         "modular_iseq_0": 6, "modular_iseq_1": 0}
# The programs of K7's streamed launch on path 8: every extension AIR's.
ECRECOVER_STREAMED = ("keccak_sponge", "keccakf", "sw_add_ne_0", "sw_double_0",
                      *(f"modular_{kind}_{k}" for k in (0, 1)
                        for kind in ("addsub", "muldiv", "iseq")))
# The SHA-256 of path 8's proof (6,070,653 bytes) as this script's first run
# of path 8 at ECRECOVER_N on the H100 made it.
ECRECOVER_PROOF_SHA256 = "c072ba3ccab75f79a898bb4f9b16fba6cf0c3a0eda9ac26984bfa4bb150bc6c4"
# Path 9: the pairing guest in volatile memory, one cold prove: the
# reference's pairing bench (SURVEY.md:571, section 2.11) as the Miller
# loop and residue check of four finite, valid pairs (one Groth16
# verification's check; EIP-197's on-curve, subgroup and infinity cases
# are not run), every check run in the VM on the Fp2 chips:
# Rv32Config(moduli=(BN254_P,), fp2=(BN254_P,)) with the default
# executors.  PAIRING_N inputs, each from its own seed: 30,385
# instructions, 24,131 Fp2 ops (13,669 MUL, 364 DIV, 7,628 ADD, 2,450 SUB)
# and 60 modular ops an input.
PAIRING_N = 2
PAIRING_PAIRS = 4
PAIRING_SEED = SEED
PAIRING_CONFIG = dict(executors=FULL_EXECUTORS, moduli=(BN254_P,), fp2=(BN254_P,))
PAIRING_LOG_HEIGHTS = {"fp2_muldiv_0": 15, "fp2_addsub_0": 15, "modular_addsub_0": 7,
                       "modular_muldiv_0": 4, "modular_iseq_0": 5, "rv32_base_alu": 14,
                       "rv32_hint_store": 10, "rv32_load_store": 9, "rv32_jal_lui": 8,
                       "program": 15, "memory_boundary": 11, "range_tuple": 19}
# The programs of K7's streamed launch on path 9: every extension AIR's
# (fp2_muldiv_0 45,093 instructions at 48 words, fp2_addsub_0 5,659).
PAIRING_STREAMED = ("modular_addsub_0", "modular_muldiv_0", "modular_iseq_0",
                    "fp2_addsub_0", "fp2_muldiv_0")
# The SHA-256 of path 9's proof (3,357,917 bytes) as this script's first
# run of path 9 at PAIRING_N on the H100 made it.
PAIRING_PROOF_SHA256 = "6b64d550e5ab4bd4179053ca6f404e89f7eebb8438d6d9a7dd157ff30a78d8a4"
# Path 10: the native (recursion) VM, NativeConfig's chips: the FRI query
# phase of a leaf verifier at the production profile (84 queries; the
# reference's leaf verifier, extensions/native/recursion, as
# vm.guest.build_native_query_program): a runtime loop over the queries,
# each one VERIFY_BATCH of depth 21 over its opened rows (32 + 16 felts at
# level 0, 8 at level 1), one FRI_REDUCED_OPENING over the 56 felts, and 20
# FRI layers, each a VERIFY_BATCH of depth 20 - l and a fold in extension
# arithmetic; 92,224 instructions, 21,841 Poseidon2 permutations.
NATIVE_ARGS = (84, 21, 20, SEED)
NATIVE_LOG_HEIGHTS = {"verify_batch": 16, "native_loadstore4": 16, "poseidon2": 15,
                      "native_field_arithmetic": 14, "native_branch_eq": 14,
                      "native_field_extension": 14, "fri_reduced_opening": 13,
                      "verify_batch_inside": 12, "phantom": 11, "native_jal_rangecheck": 10,
                      "native_loadstore": 8, "native_poseidon2": 7}
# The programs of K7's streamed launch on path 10.
NATIVE_STREAMED = ("poseidon2", "native_field_extension", "native_loadstore4", "native_poseidon2",
                   "fri_reduced_opening", "verify_batch")
# The SHA-256 of path 10's proof (1,599,737 bytes) as this script's first
# run of path 10 on the H100 made it.
NATIVE_PROOF_SHA256 = "3723f05f594a19ef13eb10b23112f046f8b3a2eb65ed878cf28879d6a65b8825"
# Path 11: the leaf verifier, build_leaf_program over path 4's first
# segment proof, proved on the native VM in the reference's leaf layout
# (openvm_tpu/sdk.py:190: NativeConfig with 44 native public values; pv[0..8]
# the app program's commitment, pv[8..12] the connector's public values,
# pv[12..28] the memory-merkle public values, pv[28..44] zero), at natural
# heights.  The verified proof is the one path 4 made; no app prove runs
# again.
LEAF_PVS = 44
# The programs of K7's streamed launch on path 11 (path 10's six).
LEAF_STREAMED = NATIVE_STREAMED
# The SHA-256 of path 11's proof (1,811,513 bytes) as this script's first
# run of path 11 on the H100 made it.  The JAX package cannot prove the
# leaf program (its Builder's PERM_POS2 has e = 0, ROADMAP F5), so the
# bytes have no JAX counterpart.
LEAF_PROOF_SHA256 = "84c31ea17389b84696d1fb4b240a3ff3704cf203dadb2459bd69113af9aaac6c"
# The plain K7 keeps every slot of a program over every row it evaluates:
# a job whose slots over its whole quotient domain take more than this is
# held to the kernel on blocks of QUOTIENT_BLOCK rows (keccakf's 2,890
# words over 2^20 rows would take 24 GB).  The row hashes (K4) of a VM
# prove's tallest committed matrices are held to plain on their first and
# last QUOTIENT_BLOCK rows too, and its widest main LDE (K3) on all its
# columns, PLAIN_LDE_COLUMNS at a time.
PLAIN_SLOT_BYTES = 4 << 30
QUOTIENT_BLOCK = 1 << 14
PLAIN_LDE_COLUMNS = 128
# The constraint checker on the card: the segments of a short run at a
# 2^14-row cap; one Poseidon2Air cell of a segment is changed for the
# failing case.
DEBUG_FIB_N = 20_000
DEBUG_LIMITS = {"max_height": 1 << 14}
DEBUG_TAMPER = (3, 1 + 16 + 5)  # (row, column) of the Poseidon2Air trace
# The variants' tallest heights: K3 at 2^22, K12's table up to 2^22 rows,
# K10's longest look-back chain over 2^22 + 37 rows, K9 at 2^21.
VARIANT_LOG_H = 22
# K5's compress phase is timed on a FRI tree of 2^20 leaves, path 3's largest.
FRI_TREE_LOG = 20
# Path 2 has no interactions: it runs every kernel but K8, K9, K10 and the
# columns mode of K7.
PATH2_KERNELS = ("bb_elementwise", "ntt", "poseidon2_hash_rows",
                 "poseidon2_compress_layer", "poseidon2_compress_tail",
                 "ext_powers", "gather",
                 "quotient", "open_dot", "fri_reduced_open", "fri_fold")
# Kept for its tests and variants; no path launches it.
OFF_PATH = ("ext_elementwise",)
# Launched only by K7's streamed launch: paths 4-6, not paths 1-3.
STREAMED_ONLY = ("quotient_transpose",)

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
# 13 partial rounds of 1 add, 1 S-box, 15 adds for the sum and the
# internal diagonal [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 2^-8, 1/4, 1/8,
# 2^-27, -2^-8, -1/16, -2^-27] plus the sum on 16 lanes: 16 adds, 10 adds
# for the small multiples and 9 Montgomery reductions (no 32x32 product by
# the word, counted as 6) for the powers of 1/2.
RED_OPS = 6
PERM_MULS = 8 * 16 * 4 + 13 * 4
PERM_REDS = 13 * 9
PERM_ADDS = 72 + 8 * (16 + 72) + 13 * (1 + 15 + 16 + 10)
PERM_OPS = PERM_MULS * MUL_OPS + PERM_REDS * RED_OPS + PERM_ADDS * ADD_OPS
# Issue rate for the instruction bound: 4 schedulers of an SM each issue
# one warp instruction (32 threads) a clock.
H100_SMS, ISSUE_PER_SM_CLOCK = 132, 4 * 32
# Extension arithmetic: a product is 19 Montgomery products and 12 adds.
# Batch inversion (Montgomery's trick) costs 3 products per element, base
# or extension, plus one inverse per batch, which rounds to nothing.
EXT_ADD = 4 * ADD_OPS
EXT_SCALE = 4 * MUL_OPS
EXT_MUL = 19 * MUL_OPS + 12 * ADD_OPS
BATCH_INV, EXT_BATCH_INV = 3 * MUL_OPS, 3 * EXT_MUL
# With delayed reduction (K9, csrc/logup.cu mul_d): a 32x32-bit product
# added into a 64-bit sum counts 2 (its low and high halves, with the
# carry), a reduction of the sum RED_OPS; an extension product is 19 such
# products and 7 reductions.
WIDE_MAC_OPS = 2
EXT_MUL_D = 19 * WIDE_MAC_OPS + 7 * RED_OPS
NO_LIBRARY = "no single PyTorch call computes this function"


START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the script's seconds so far."""
    if "phase" in obj:
        obj = {**obj, "script_s": time.perf_counter() - START}
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    require(a.shape == b.shape, f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def cuda_ms(fn, reps: int, host: bool = False, busy: bool = True):
    """Mean device time of fn() over reps calls after one warm-up call; with
    ``host``, also the mean host time to enqueue one call.  With ``busy``
    the card is kept busy (torch.cuda._sleep) while the host enqueues the
    calls, so that a kernel shorter than its host enqueue is timed on the
    card; a call that waits on the card (a blocking copy) still makes the
    time the host's.  Without it, the events span the host's enqueue too
    (the method before the card was kept busy): where the two readings are
    close, the host's enqueue was not what the card waited on."""
    fn()
    torch.cuda.synchronize()
    if busy:
        t0 = time.perf_counter()
        fn()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(1.5 * reps * enqueue_s, 1.0) * 2e9))
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


def near_limit_dag(fits: bool) -> tuple:
    """The first random DAG (widening operand windows) whose program takes
    over 90% of the shared launch's slot words beside its code and still
    fits it (``fits``), or the first one past the limit, which is compiled
    at the budget for the streamed launch."""
    for window in range(500, 40000, 50):
        nodes, roots = random_dag(np.random.default_rng(window), 2 * window, window)
        dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
        prog = qmod.compile_dag_code(dag, n_main=2, has_preprocessed=True, has_perm=True)
        if prog.budget:
            if not fits:
                return nodes, roots
            continue
        if fits and prog.lane_words > 0.9 * qmod.max_lane_words(int(prog.code.shape[0])):
            return nodes, roots
    raise AssertionError("no random DAG reached the slot limit")


def code_limit_dag() -> tuple:
    """A DAG whose code alone overruns the kernel's shared memory (over
    14,528 instructions of 16 bytes; the shared launch takes at most
    7,232): 6,000 short roots over leaves (``reload_dag``), whose computed
    values fit the budget as an AIR's do."""
    return reload_dag(np.random.default_rng(6000), 6000)


def columns_limit_dags() -> dict:
    """Base-valued random DAGs for the columns mode, every node a root: one
    past the shared launch's slot limit (a window of 600 keeps about 300
    values live) and one past its code limit (8,000 operations, each
    computed and stored)."""
    out = {}
    for name, n_ops, window in (("past_slots", 2000, 600), ("past_code", 8000, 16)):
        nodes, _ = random_dag(np.random.default_rng(n_ops), n_ops, window, base_only=True)
        out[name] = (nodes, [r for r in range(len(nodes)) if nodes[r][0] != "const"])
    return out


def reload_dag(rng, n_roots: int) -> tuple:
    """Leaves of every kind (``random_dag``'s) and ``n_roots`` short roots
    over leaves picked anywhere, so that every leaf is read all through the
    program: compiled at a small budget, every kind of leaf is loaded again
    many times, extension values among them."""
    nodes, _ = random_dag(rng, 0)
    n_leaves = len(nodes)
    roots = []
    for _ in range(n_roots):
        a, b, c = (int(x) for x in rng.integers(0, n_leaves, size=3))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            nodes += [("mul", a, b), ("add", len(nodes), c)]
        elif kind == 1:
            nodes += [("mul", b, c), ("sub", a, len(nodes))]
        elif kind == 2:
            nodes.append(("sub", a, b))
        else:
            nodes += [("neg", a), ("mul", len(nodes), c)]
        roots.append(len(nodes) - 1)
    return nodes, roots


def random_dag(rng, n_ops: int, window: int = 16, base_only: bool = False) -> tuple:
    """A random constraint DAG over two main parts (3 and 2 columns), a
    preprocessed matrix (2), a permutation matrix (2 ext columns), 3
    publics, 2 challenges, 1 exposed value and the selectors (with
    ``base_only``, the constants, main and preprocessed cells and publics
    alone); operands come from the last ``window`` nodes or from the leaves,
    so the window bounds the program's live slots.  Returns (nodes, roots)."""
    nodes = [("const", 0), ("const", 1), ("const", P - 1), ("const", 12345)]
    nodes += [("var", "main", part, off, c) for part, w in enumerate((3, 2))
              for c in range(w) for off in (0, 1)]
    nodes += [("var", "preprocessed", 0, off, c) for c in range(2) for off in (0, 1)]
    if not base_only:
        nodes += [("var", "permutation", 0, off, c) for c in range(2) for off in (0, 1)]
    nodes += [("var", "public", 0, 0, k) for k in range(3)]
    if not base_only:
        nodes += [("var", "challenge", 0, 0, k) for k in range(2)]
        nodes += [("var", "exposed", 0, 0, 0)]
        nodes += [("sel", s) for s in qmod.SELECTORS]
    n_leaves = len(nodes)
    for _ in range(n_ops):
        k = len(nodes)
        ab = [int(rng.integers(0, n_leaves)) if rng.random() < 0.3
              else int(rng.integers(max(0, k - window), k)) for _ in range(2)]
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


def phase_variants(dev, rng) -> dict:
    """Every kernel against its plain version at mid sizes; returns K7's
    programs by name (``streamed_variant_timing`` times the budgeted ones)."""
    errs = {}
    # K3 around its tile of 2^11 rows: heights 2^10, 2^11, 2^12 (one and
    # two passes) at every width and every argument set; 2^21 (11 + 10
    # stages) and 2^22 at the widths whose plain version fits the card
    tk = ntt.K_MAX
    shapes = [(0, 5), (1, 3)] + [(lh, w) for lh in (tk - 1, tk, tk + 1)
                                 for w in (1, 7, 8, 9, 45, 101, 257)]
    shapes += [(2 * tk - 1, w) for w in (1, 8, 9, 45)] + [(VARIANT_LOG_H, w) for w in (1, 7)]
    for log_n, w in shapes:
        x = bb.monty(rng.integers(0, bb.P, size=(1 << log_n, w)), device=dev)
        errs[f"ntt/{log_n}x{w}"] = max_abs_err(ntt.ntt(x), ntt.ntt_plain(x))
        errs[f"intt/{log_n}x{w}"] = max_abs_err(ntt.intt(x), ntt.intt_plain(x))
        for lb, shift, bitrev_out, in_shift, coeffs in (
                (1, 31, True, 1, False), (2, 7, False, 31, True),
                (0, 31, False, 11, False), (3, 31, True, 1, True)):
            if log_n > 2 * tk - 1 and lb > 1:
                continue
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
    # K4: rows not a multiple of its 128-row block, the 32-column window
    for n, w in [(1000, w) for w in (0, 1, 7, 8, 9, 16, 17, 33, 101)] + [(4173, 101)]:
        m = bb.monty(rng.integers(0, bb.P, size=(n, w)), device=dev)
        errs[f"hash_rows/{n}x{w}"] = max_abs_err(p2.hash_rows(m), p2.hash_rows_plain(m))

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
    errs.update(series_variants(dev, eb[9]))

    # K7+K11: random DAGs at 2^12 rows, next_step 2: ~2,000 nodes, and one
    # whose slots come within 10% of the shared launch's limit beside its
    # code; then past the limit, compiled at the budget for the streamed
    # launch, each in its own launch: the next larger one (past the slot
    # limit), one whose code alone overruns shared memory, a leaf-heavy one
    # at budgets of 16 and 24 words (every kind of leaf loaded again, base
    # and extension values sharing the one word file) and the 2,000-node
    # one at 24 words (computed values spilled and filled).  Then one
    # launch over a job table of heights 2^1 to 2^12, lqd 0 and 1, one
    # table that mixes both modes (two launches), and FibonacciAir at 2^12.
    vals = dict(publics=bb.to_monty_np(rng.integers(0, P, size=3)),
                challenges=bb.to_monty_np(rng.integers(0, P, size=(2, 4))),
                exposed=bb.to_monty_np(rng.integers(0, P, size=(1, 4))),
                alpha=bb.to_monty_np(rng.integers(0, P, size=4)))
    log_n, lqd = 11, 1
    srcs = [words(rng, dev, 1 << (log_n + 1), w) for w in (3, 2, 2, 8)]
    srcs[1] = torch.cat([srcs[1], srcs[2]], dim=1)[:, :2]  # a column slice
    big, qprogs = {}, {}
    reloads = reload_dag(np.random.default_rng(120), 120)
    for name, (nodes, roots), budget in (
            ("dag2k", random_dag(np.random.default_rng(1960), 1960), None),
            ("near_limit", near_limit_dag(True), None),
            ("past_slots", near_limit_dag(False), None),
            ("past_code", code_limit_dag(), None),
            ("reloads_16", reloads, 16), ("reloads_24", reloads, 24),
            ("spills_24", random_dag(np.random.default_rng(1960), 1960), 24)):
        dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
        prog = qmod.compile_dag(dag, n_main=2, has_preprocessed=True,
                                has_perm=True, budget=budget, **vals)
        qprogs[name] = prog
        n_instr = int(prog.code.shape[0])
        require(bool(prog.budget) == (name[:4] in ("past", "relo", "spil"))
                and (prog.reloads > 0 or not name.startswith("reloads"))
                and (prog.spills > 0 or not name.startswith("spills")),
                f"{name}: budget {prog.budget}, {prog.reloads} reloads, "
                f"{prog.spills} spills")
        big[name] = {"nodes": len(nodes), "instructions": n_instr,
                     "lane_words": prog.lane_words, "budget": prog.budget,
                     "reloads": prog.reloads, "spills": prog.spills,
                     "limit": qmod.max_lane_words(n_instr),
                     "threads": qmod.launch_plan([prog])[0][-1]}
        before = _build.LAUNCHES["quotient"]
        errs[f"quotient/{name}"] = max_abs_err(
            qmod.evaluate(prog, srcs, log_n, lqd),
            qmod.evaluate_plain(prog, srcs, log_n, lqd))
        require(_build.LAUNCHES["quotient"] == before + 1, f"quotient/{name}: one launch")
    require(big["past_code"]["limit"] < 0, "the code-limit program's code fits shared memory")
    # Poseidon2Air's own program (path 4, the streamed launch) over a random
    # 2^16-row trace
    p2vk = stark.keygen([Poseidon2Air()], TEST_STARK, device=dev).vk.per_air[0]
    p2lqd = p2vk.log_quotient_degree
    prog = qmod.compile_dag(p2vk.dag, n_main=1, has_preprocessed=False, has_perm=True,
                            **vals)
    require(prog.budget == qmod.BUDGET, "Poseidon2Air's program is not budgeted")
    p2srcs = [words(rng, dev, 1 << (16 + p2lqd), Poseidon2Air().width),
              words(rng, dev, 1 << (16 + p2lqd), 4 * p2vk.widths.after_challenge)]
    before = _build.LAUNCHES["quotient"]
    errs["quotient/poseidon2"] = max_abs_err(qmod.evaluate(prog, p2srcs, 16, p2lqd),
                                             qmod.evaluate_plain(prog, p2srcs, 16, p2lqd))
    require(_build.LAUNCHES["quotient"] == before + 1, "quotient/poseidon2: one launch")
    big["poseidon2"] = {"instructions": int(prog.code.shape[0]),
                        "lane_words": prog.lane_words, "lqd": p2lqd,
                        "budget": prog.budget, "reloads": prog.reloads,
                        "threads": qmod.launch_plan([prog])[0][-1]}
    del p2srcs
    nodes, roots = random_dag(np.random.default_rng(400), 400)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    jprog = qmod.compile_dag(dag, n_main=2, has_preprocessed=True, has_perm=True,
                             **vals)
    jobs = [(k - q, q) for k in range(1, 13) for q in (0, 1) if k - q >= 0]
    jsrcs = [[words(rng, dev, 1 << (ln + q + 1), w) for w in (3, 2, 2, 8)]
             for ln, q in jobs]
    got = qmod.evaluate_many([jprog] * len(jobs), jsrcs, [j[0] for j in jobs],
                             [j[1] for j in jobs])
    errs["quotient/jobs"] = max(
        max_abs_err(g, qmod.evaluate_plain(jprog, s_, ln, q))
        for g, s_, (ln, q) in zip(got, jsrcs, jobs))
    # both modes in one table: the shared launch's jobs in one launch, the
    # budgeted ones in the streamed launch
    mixed = [(jprog, 3, 1), (qprogs["past_slots"], 6, 1), (qprogs["near_limit"], 1, 0),
             (qprogs["past_code"], 2, 0), (jprog, 11, 0), (qprogs["reloads_16"], 4, 1),
             (qprogs["spills_24"], 10, 1)]
    msrcs = [[words(rng, dev, 1 << (ln + q + 1), w) for w in (3, 2, 2, 8)]
             for _, ln, q in mixed]
    before = _build.LAUNCHES["quotient"]
    got = qmod.evaluate_many([m[0] for m in mixed], msrcs, [m[1] for m in mixed],
                             [m[2] for m in mixed])
    require(_build.LAUNCHES["quotient"] == before + 2, "a mixed table takes two launches")
    errs["quotient/mixed_modes"] = max(
        max_abs_err(g, qmod.evaluate_plain(pr, s_, ln, q))
        for g, s_, (pr, ln, q) in zip(got, msrcs, mixed))
    # the streamed launch's column-major copies: heights and widths around
    # the 32 x 32 tile, a column slice (row stride above the width), only
    # the first rows
    for n, w, width in ((1, 1, 1), (31, 33, 33), (33, 31, 40), (1000, 7, 9),
                        (4096, 2633, 2633), (3000, 100, 100)):
        src = words(rng, dev, n + 5, width)[:, width - w:]
        errs[f"quotient_transpose/{n}x{w}"] = max_abs_err(qmod.transpose(src, n),
                                                          qmod.transpose_plain(src, n))
    fib_dag = stark.keygen([FibonacciAir()], StarkConfig(), device=dev).vk.per_air[0].dag
    fprog = qmod.compile_dag(fib_dag, n_main=1, has_preprocessed=False,
                             has_perm=False, publics=[1, 2, 3], alpha=vals["alpha"])
    fsrc = [words(rng, dev, 1 << 13, 2)]
    errs["quotient/fib"] = max_abs_err(qmod.evaluate(fprog, fsrc, 12, 0),
                                       qmod.evaluate_plain(fprog, fsrc, 12, 0))

    # K5's tail against plain: trees of 2^1 to 2^14 leaves with a matrix at
    # every height (an injection at every layer), tails from 2, 64 (one
    # block of the cluster) and the default 512 digests (all 8 blocks)
    for log_h in range(1, 15):
        mats = [words(rng, dev, 1 << k, 1 + k % 3) for k in range(log_h, -1, -1)]
        want = merkle.commit_layers_plain(mats)
        for tail_max in (2, 64, merkle.TAIL_MAX):
            got = merkle.commit_layers(mats, tail_max=tail_max)
            errs[f"compress_tail/2^{log_h}/{tail_max}"] = max(
                max_abs_err(a, b) for a, b in zip(got, want))

    # K12: one job table of widths 1, 2, 4, 5, 33 and 380 at heights 2^1 to
    # 2^22, one and two points, column slices (a row stride above the
    # width); then K13 and K14 at 2^12
    zp = words(rng, dev, 1 << VARIANT_LOG_H, 4)
    widths = (1, 2, 4, 5, 33, 380)
    ojobs = []
    for log_h in range(1, VARIANT_LOG_H + 1):
        w = widths[log_h % len(widths)]
        while (w << log_h) > 1 << 24:  # the plain version's int64 (N, W, 4) product
            w = widths[widths.index(w) - 1]
        base = words(rng, dev, 1 << log_h, w + 3)
        coeffs = base[:, 1:1 + w] if log_h % 2 else base[:, :w].contiguous()
        mults = [int(x) for x in rng.integers(1, P, size=1 + log_h % 2)]
        ojobs.append((coeffs, mults))
    ojobs.append((words(rng, dev, 1 << 9, 380), [1, 7]))
    before = _build.LAUNCHES["open_dot"]
    got = pv.open_many(ojobs, zp)
    require(_build.LAUNCHES["open_dot"] == before + 2, "K12: two launches a table")
    want = pv.open_many_plain(ojobs, zp)
    errs["open_dot/table"] = max(max_abs_err(a, b) for a, b in zip(got, want))
    open_table = [[int(c.shape[0]), int(c.shape[1]), int(c.stride(0)), len(m)]
                  for c, m in ojobs]
    del ojobs, got, want, zp
    # K13 in one launch over a table of heights 2^1 to 2^12: 1 to 6
    # matrices a height, widths 1 to 64 (column slices among them), 1 to 3
    # distinct points, matrices opened at one or two of them, and one point
    # equal to an LDE point (a zero denominator)
    ro_jobs, ro_shape = ro_variant_jobs(rng, dev)
    before = _build.LAUNCHES["fri_reduced_open"]
    got = pv.reduced_open_many(*ro_jobs)
    require(_build.LAUNCHES["fri_reduced_open"] == before + 1, "K13: one launch a table")
    want = pv.reduced_open_many_plain(*ro_jobs)
    require(sorted(got) == sorted(want), "K13: heights")
    errs["reduced_open/table"] = max(max_abs_err(got[k], want[k]) for k in want)
    del ro_jobs, got, want
    # K14 at every height 2^1 to 2^23, with and without ro
    beta = words(rng, dev, 4)
    for log_h in range(1, 24):
        ev, ro = words(rng, dev, 1 << log_h, 4), words(rng, dev, 1 << (log_h - 1), 4)
        errs[f"fri_fold/2^{log_h}"] = max_abs_err(fri.fold_evals(ev, beta),
                                                  fri.fold_evals_plain(ev, beta))
        errs[f"fri_fold/2^{log_h}/ro"] = max_abs_err(fri.fold_evals(ev, beta, ro),
                                                     fri.fold_evals_plain(ev, beta, ro))
    ev = words(rng, dev, 4096, 4)

    # K6: see gather_variants
    errs.update(gather_variants(dev, rng, ev))

    # K7 columns mode: a random DAG's base roots over 2^12 natural rows, and
    # the same at a budget of 8 words (its leaf roots among them); base-valued
    # DAGs past the slot limit and past the code limit, each in its own
    # streamed launch
    nodes, roots = random_dag(np.random.default_rng(1960), 1960)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    tags = qmod._tags(dag, range(len(nodes)))
    base_roots = [r for r in range(len(nodes)) if tags[r] == "b"
                  and nodes[r][0] not in ("sel",)][-40:] + [0, 3]
    cprog = qmod.compile_columns(dag, base_roots, n_main=2, has_preprocessed=True,
                                 publics=bb.to_monty_np(rng.integers(0, P, size=3)))
    csrc = [s[:1 << 12] for s in srcs[:3]]
    cols = qmod.evaluate_columns(cprog, csrc, 12)
    errs["quotient_columns"] = max_abs_err(cols, qmod.evaluate_columns_plain(cprog, csrc, 12))
    cprog = qmod.compile_columns(dag, base_roots, n_main=2, has_preprocessed=True,
                                 publics=bb.to_monty_np(rng.integers(0, P, size=3)), budget=8)
    require(cprog.reloads > 0, "columns at a budget of 8 words: no reload")
    big["columns/reloads_8"] = {"instructions": int(cprog.code.shape[0]),
                                 "reloads": cprog.reloads, "lane_words": cprog.lane_words}
    errs["quotient_columns/reloads_8"] = max_abs_err(
        qmod.evaluate_columns(cprog, csrc, 12), qmod.evaluate_columns_plain(cprog, csrc, 12))
    # the constraint checker's programs read the natural domain's 0/1
    # selectors: the same roots and the selectors themselves as roots
    sel_roots = [r for r in range(len(nodes)) if nodes[r][0] == "sel"]
    cprog = qmod.compile_columns(dag, base_roots + sel_roots, n_main=2,
                                 has_preprocessed=True, selectors=True,
                                 publics=bb.to_monty_np(rng.integers(0, P, size=3)))
    require(cprog.sel_mask == 7, f"columns with selectors: sel_mask {cprog.sel_mask}")
    errs["quotient_columns/selectors"] = max_abs_err(
        qmod.evaluate_columns(cprog, csrc, 12), qmod.evaluate_columns_plain(cprog, csrc, 12))
    for name, (nodes, roots) in columns_limit_dags().items():
        cprog = qmod.compile_columns(SymbolicDag(nodes=nodes, constraint_roots=[]), roots,
                                     n_main=2, has_preprocessed=True,
                                     publics=bb.to_monty_np(rng.integers(0, P, size=3)))
        require(cprog.budget, f"columns/{name} fits the shared launch")
        big[f"columns/{name}"] = {"roots": len(roots),
                                  "instructions": int(cprog.code.shape[0]),
                                  "lane_words": cprog.lane_words, "budget": cprog.budget,
                                  "reloads": cprog.reloads,
                                  "limit": qmod.max_lane_words(int(cprog.code.shape[0]))}
        before = _build.LAUNCHES["quotient_columns"]
        cols = qmod.evaluate_columns(cprog, csrc, 12)
        require(_build.LAUNCHES["quotient_columns"] == before + 1,
                f"columns/{name}: one launch")
        errs[f"quotient_columns/{name}"] = max_abs_err(
            cols, qmod.evaluate_columns_plain(cprog, csrc, 12))
        del cols

    # K9 in one launch over a job table of heights 1 to 2^21: 0 to 9 fields
    # an interaction, m = 1, 3, 12 and 13 chunks (interactions sharing
    # output rows in the 13-chunk layout), and a layout whose rows
    # 0, 1 and 2 have a zero denominator at their first, middle and last
    # interaction and row 3 at every one; then a table whose alpha zeroes a
    # field-less
    # interaction on every row.  K10 on the tallest and shortest buffers.
    perm_jobs, perm_errs = k9_variants(dev, rng)
    errs.update(perm_errs)
    # K10 alone over m = 1 to 12 chunks at heights that are not a multiple
    # of its tile, and 2^22 + 37 rows (16,385 tiles: a long look-back chain)
    scan_shapes = [(n, m) for m in range(1, 13)
                   for n in (1, 255, 257, 1000 + 37 * m, (1 << 14) + m)]
    scan_shapes += [((1 << VARIANT_LOG_H) + 37, 1), ((1 << VARIANT_LOG_H) + 1, 2)]
    for n, m in scan_shapes:
        perm = logup.perm_buffer(n, m, dev)
        perm.copy_(words(rng, dev, n, 4 * m))
        want = logup.perm_scan_plain(perm)
        got = logup.perm_scan(perm)
        errs[f"perm_scan/{n}x{m}"] = max(max_abs_err(got[0], want[0]),
                                         max_abs_err(got[1], want[1]))
        del perm, want, got

    # K8 in one launch over AIRs of 2^20, 1000 and 1 rows: skewed sends
    # (90% on bits 14 value 0, bitwise and tuple bin 0, all private or
    # head bins), counts that wrap uint32 in one bin (private and global),
    # indices at and past each table's edge, wrapping tuple and bitwise
    # indices; two calls add into the same tables
    hist_heights, hist_errs = k8_variants(dev, rng)
    errs.update(hist_errs)
    bad = {k: v for k, v in errs.items() if v}
    emit({"phase": "variants", "cases": len(errs), "mismatched": bad,
          "quotient_dags": big, "quotient_jobs": jobs,
          "quotient_mixed": [(int(m[0].code.shape[0]), m[1], m[2], m[0].budget)
                             for m in mixed],
          "open_table": open_table, "reduced_open_table": ro_shape,
          "perm_scan_shapes": scan_shapes,
          "perm_cols_jobs": perm_jobs, "lookup_hist_heights": hist_heights})
    require(not bad, f"kernel and plain disagree: {bad}")
    return qprogs


def series_variants(dev, u) -> dict:
    """K2's power series against its plain version, one launch a series:
    u random, 0 and 1, n around its blocks of POW_T x POW_E powers, up to
    path 2's 2^22 and past it, and once from a tensor."""
    errs = {}
    before = _build.LAUNCHES["ext_powers"]
    n_pows = 0
    for which, x in (("random", u), ("zero", torch.zeros_like(u)),
                     ("one", ef.ones((), device=dev))):
        for n in (0, 1, 2, 3, 255, 256, 257, 4099, 1 << 20, (1 << 22) + 3):
            got = ef.powers_host(x.tolist(), n, dev)
            errs[f"ext_powers/{which}/{n}"] = max_abs_err(got, ef.powers_plain(x, n))
            n_pows += n > 0
            del got
    errs["ext_powers/tensor"] = max_abs_err(ef.powers(u, 4099), ef.powers_plain(u, 4099))
    require(_build.LAUNCHES["ext_powers"] == before + n_pows + 1,
            "K2's power series: one launch a series")
    return errs


def gather_variants(dev, rng, ev) -> dict:
    """K6 against its plain version, in one launch a plan, through
    ``run_device`` and through ``run`` (its pinned copy): a mixed-height
    tree of widths 1, 3, 4, 8 (digests) and 13 with its paths, shifted;
    column slices whose row stride exceeds their width, off and on 16-byte
    boundaries, with flips and shifts, and a width-0 slice; fold-style
    siblings; at q = 1 and q = 84; a table of 0 jobs; a 2^23-row source;
    and a table of 2,100 jobs at q = 1 (a block's one-word units span 256
    jobs)."""
    errs = {}
    mats = [words(rng, dev, h, w) for h, w in ((4096, 3), (1024, 1), (4096, 4),
                                               (256, 13), (4096, 8))]
    tree = merkle.commit(mats)
    big = words(rng, dev, 4096, 20)
    tall = words(rng, dev, 1 << 23, 4)

    def check(name, plan, idx):
        before = _build.LAUNCHES["gather"]
        want = plan.run_plain(idx)
        errs[f"gather/{name}"] = max_abs_err(plan.run_device(idx), want)
        flat = [torch.from_numpy(b.reshape(-1).astype(np.int64)) for b in plan.run(idx)]
        errs[f"gather/{name}/run"] = max_abs_err(
            torch.cat(flat) if flat else torch.zeros(0, dtype=torch.int64), want.cpu())
        live = any(int(m.shape[1]) for m, _, _ in plan.jobs) and len(idx)
        require(_build.LAUNCHES["gather"] == before + (2 if live else 0),
                f"K6 {name}: one launch a run")

    for q in (1, 84):
        idx = rng.integers(0, 4096, size=q).tolist()
        plan = merkle.GatherPlan()
        plan.add_tree(tree)
        plan.add_tree(tree, 3, rows=False)
        for m, s, f in ((big, 0, 0), (big[:, 4:8], 1, 1), (big[:, 3:16], 2, 0),
                        (big[:, 8:9], 0, 1), (big[:, 0:0], 0, 0), (big[:2048, 1:4], 1, 1),
                        (big[:, 12:20], 3, 1), (ev, 1, 1)):
            plan.add(m, s, f)
        check(f"mixed/q{q}", plan, idx)
        plan = merkle.GatherPlan()
        plan.add(tall, 0, 1)
        plan.add(tall[:, 1:4], 2, 0)
        check(f"2^23/q{q}", plan, rng.integers(0, 1 << 23, size=q).tolist())
    check("no_jobs", merkle.GatherPlan(), [1, 2, 3])
    plan = merkle.GatherPlan()
    for k in range(2100):
        plan.add(mats[k % 5] if k % 7 else big[:, k % 20:k % 20 + 1], k % 3, k % 2)
    check("2100_jobs/q1", plan, [int(rng.integers(0, 256))])
    check("2100_jobs/q84", plan, rng.integers(0, 256, size=84).tolist())
    return errs


def ro_variant_jobs(rng, dev) -> tuple:
    """K13's variant table: heights 2^1 to 2^12 in rising order (the table
    puts them largest first), 1 to 6 matrices a height of widths 1 to 64
    (rows of 16-byte units and of words, column slices of both kinds), 1 to
    3 distinct points a height, each matrix opened at one or two of them;
    at height 2^5 one point is the LDE point of row 7, a zero denominator;
    at height 2^1 a matrix opened twice at one point.  Returns ((jobs, alpha), [log_h, width, row stride, points] a matrix)."""
    def ext():
        return tuple(int(v) for v in rng.integers(0, P, size=4))

    widths = (1, 4, 64, 3, 48, 33, 8, 45, 2, 32, 13, 60)
    jobs, shape = [], []
    for log_h in range(1, 13):
        zs = [ext() for _ in range(1 + log_h % 3)]
        if log_h == 5:
            zs[0] = (bb.from_monty_int(int(ntt.lde_points_np(5)[7])), 0, 0, 0)
        for k in range(1 + (log_h * 5) % 6):
            w = widths[(log_h + k) % len(widths)]
            if k % 3 == 2:
                mat = words(rng, dev, 1 << log_h, w + 3)[:, 1:1 + w]
            elif k % 3 == 1 and w % 4 == 0:
                mat = words(rng, dev, 1 << log_h, w + 8)[:, 4:4 + w]
            else:
                mat = words(rng, dev, 1 << log_h, w)
            pick = sorted({k % len(zs), (k + 1) % len(zs)} if k % 2 else {k % len(zs)})
            jobs.append((mat, [(zs[q], ext(), ext()) for q in pick]))
            shape.append([log_h, w, int(mat.stride(0)), len(pick)])
        if log_h == 1:  # a one-row trace's LDE, opened at zeta and zeta g_1 = zeta
            jobs.append((words(rng, dev, 2, 5), [(zs[0], ext(), ext()) for _ in range(2)]))
            shape.append([1, 5, 5, 2])
    return (jobs, ext()), shape


def solve_mod_p(a: list, b: list) -> list:
    """x with a x = b over F_p (a square and invertible), by elimination."""
    n = len(a)
    m = [[int(v) % P for v in row] + [int(bv) % P] for row, bv in zip(a, b)]
    for c in range(n):
        piv = next(r for r in range(c, n) if m[r][c])
        m[c], m[piv] = m[piv], m[c]
        inv = pow(m[c][c], -1, P)
        m[c] = [v * inv % P for v in m[c]]
        for r in range(n):
            if r != c and m[r][c]:
                f = m[r][c]
                m[r] = [(v - f * w) % P for v, w in zip(m[r], m[c])]
    return [m[r][n] for r in range(n)]


def perm_variant_layout(rows: list, rng, shared: bool = False) -> logup.InteractionLayout:
    """An InteractionLayout of (first field row, fields, chunk, is_send)
    rows over consecutive output rows, random bus ids; with ``shared``,
    every other entry reads a row that an earlier interaction reads too."""
    table = np.asarray(rows, dtype=np.int32)
    n_roots = int(max(r[0] + r[1] + 1 for r in rows))
    entries = np.arange(n_roots, dtype=np.int32)
    if shared:
        entries = np.where(entries % 2, entries // 2, entries)
    return logup.InteractionLayout(
        roots=list(range(n_roots)), rows=entries, table=table,
        bus_m=bb.to_monty_np(rng.integers(0, P, size=len(rows), dtype=np.uint64)),
        m=int(table[:, 2].max()) + 1, f_max=int(table[:, 1].max()))


def zero_denominators(cols, layout, alpha_m, bpows_m, rows_its: dict) -> None:
    """Set 4 fields of each (row, interaction) of ``rows_its`` so that its
    denominator alpha + bus + sum_j beta^(j+1) f_j is 0 (the interactions
    have at least 4 fields): a 4 x 4 system over F_p in canonical values."""
    canon = lambda w: bb.from_monty_int(int(w))  # noqa: E731
    beta = [[canon(bpows_m[j][k]) for j in range(4)] for k in range(4)]
    for row, its in rows_its.items():
        for i in its:
            first, nf = int(layout.table[i, 0]), int(layout.table[i, 1])
            at = layout.rows[first:first + nf]
            rest = [sum(canon(bpows_m[j][k]) * canon(cols[at[j], row])
                        for j in range(4, nf)) for k in range(4)]
            rhs = [-(canon(alpha_m[k]) + (canon(layout.bus_m[i]) if k == 0 else 0)
                     + rest[k]) for k in range(4)]
            f = solve_mod_p(beta, rhs)
            for j in range(4):
                cols[at[j], row] = bb.to_monty_int(f[j])


def k9_variants(dev, rng) -> tuple:
    """K9 (and K10 on its output) against plain on one-launch job tables;
    returns (the job table's (layout, height) pairs, errors)."""
    errs = {}
    layouts = {
        "mixed": perm_variant_layout([(0, 2, 0, 1), (3, 0, 0, 0), (4, 4, 1, 1),
                                      (9, 1, 2, 0), (11, 3, 2, 1)], rng),
        "one_chunk": perm_variant_layout([(0, 9, 0, 0), (10, 1, 0, 1)], rng),
        "twelve_chunks": perm_variant_layout([(3 * i, 2, i, i % 2) for i in range(12)], rng),
        "zeros": perm_variant_layout([(5 * i, 4, i // 2, (i + 1) % 2) for i in range(5)], rng),
        "load_store_like": perm_variant_layout(
            [(10 * i, 1 + (3 * i) % 9, i * 13 // 22, int(i % 3 != 0)) for i in range(22)],
            rng, shared=True),
    }
    jobs = [("mixed", 1), ("zeros", 2), ("one_chunk", 1000), ("twelve_chunks", 4099),
            ("load_store_like", 1 << 12), ("zeros", 1 << (VARIANT_LOG_H - 1))]
    alpha = bb.to_monty_np(rng.integers(0, P, size=4, dtype=np.uint64))
    bpows = bb.to_monty_np(rng.integers(0, P, size=(9, 4), dtype=np.uint64))
    cols = []
    for name, n in jobs:
        lay = layouts[name]
        c = bb.to_monty_np(rng.integers(0, P, size=(len(lay.roots), n), dtype=np.uint64))
        if name == "zeros":
            zero_denominators(c, lay, alpha, bpows,
                              {0: [0], 1: [2], 2: [4], 3: range(5)} if n > 3 else {1: [0, 4]})
        cols.append(bb.from_numpy(c, device=dev))
    lays = [layouts[name] for name, _ in jobs]
    plain = [logup.perm_cols_plain(c, lay, bb.from_numpy(alpha, device=dev),
                                   bb.from_numpy(bpows, device=dev))
             for c, lay in zip(cols, lays)]
    # row 3 is all zero denominators, row 2's last chunk holds only its
    # zero one; rows 0 and 1 keep their other interactions
    require(not plain[-1][3].any() and not plain[-1][2, 8:].any()
            and bool(plain[-1][:2].all()), "the zero denominators' rows are not as planted")
    before = _build.LAUNCHES["perm_cols"]
    got = logup.perm_cols_many(cols, lays, alpha, bpows)
    require(_build.LAUNCHES["perm_cols"] == before + 1, "K9: one launch a table")
    for (name, n), g, w in zip(jobs, got, plain):
        errs[f"perm_cols/{name}/{n}"] = max_abs_err(g, w)
    for k in (0, len(jobs) - 1):
        want, have = logup.perm_scan_plain(got[k]), logup.perm_scan(got[k])
        errs[f"perm_scan/{jobs[k][1]}"] = max(max_abs_err(have[0], want[0]),
                                              max_abs_err(have[1], want[1]))
    del got, plain
    # alpha = -bus of the field-less interaction 1: zero on every row
    lay = layouts["mixed"]
    alpha0 = np.zeros(4, dtype=np.uint32)
    alpha0[0] = P - int(lay.bus_m[1])
    c = words(rng, dev, len(lay.roots), 1000)
    errs["perm_cols/alpha_zero"] = max_abs_err(
        logup.perm_cols(c, lay, alpha0, bpows),
        logup.perm_cols_plain(c, lay, bb.from_numpy(alpha0, device=dev),
                              bb.from_numpy(bpows, device=dev)))
    return [(name, n) for name, n in jobs], errs


def k8_variants(dev, rng) -> tuple:
    """K8 against plain on one job table; returns (heights, errors)."""
    range_h, tuple_h, sizes1 = 1 << 16, 256 * 2048, 2048
    layout = lookup.SendLayout(roots=list(range(7)), table=np.asarray(
        [(lookup.RANGE, 0, 1, 1, 2), (lookup.BITWISE, 3, 4, 5, 2),
         (lookup.TUPLE, 3, 4, 4, 6)], dtype=np.int32))
    heights = [1 << 20, 1000, 1]
    cols = []
    for n in heights:
        v = rng.integers(0, 300, size=(7, n)).astype(np.uint64)
        v[1] = rng.integers(0, 17, size=n)
        v[2] = rng.integers(0, P, size=n)
        v[2, rng.random(n) < 0.1] = 0
        v[5] = rng.integers(0, 2, size=n)
        v[6] = rng.integers(0, P, size=n)
        hot = rng.random(n) < 0.9
        v[0, hot], v[1, hot], v[3, hot], v[4, hot], v[5, hot] = 0, 14, 0, 0, 0
        if n == 1000:  # every count p - 1: bins that wrap, private and global
            v[2], v[6] = P - 1, P - 1
            v[:2, 500:] = ((300,), (10,))
        # the edges: the last bin of each table, then the first past it
        edge = [(0, 16, 255, 255, 1), (1, 16, 256, 0, 0), (0, 16, 255, 2047, 1),
                ((1 << 23) + 1, 1, (1 << 21) + 5, 9, 0), (5, 31, (1 << 23) + 1, 3, 1)]
        for r, (val, bits, x, y, xr) in enumerate(edge[:min(n, len(edge))]):
            v[[0, 1, 3, 4, 5], r] = (val, bits, x, y, xr)
        cols.append(bb.monty(v, device=dev))
    k_tabs = lookup.new_tables(range_h, tuple_h, dev)
    p_tabs = lookup.new_tables(range_h, tuple_h, dev)
    before = _build.LAUNCHES["lookup_hist"]
    for _ in range(2):  # the second call adds into the first call's counts
        lookup.lookup_hist_many(cols, [layout] * 3, k_tabs, sizes1)
        for c in cols:
            lookup.lookup_hist_plain(c, layout, p_tabs, sizes1)
    require(_build.LAUNCHES["lookup_hist"] == before + 2, "K8: one launch a table")
    errs = {f"lookup_hist/{name}": max_abs_err(a, b)
            for name, a, b in zip(("range", "bitwise", "tuple"), k_tabs, p_tabs)}
    require(int(p_tabs[0][range_h - 1]) != 0 and int(p_tabs[1][-1]) != 0
            and int(p_tabs[0][(1 << 14) - 1]) != 0, "the K8 edge and hot bins are empty")
    return heights, errs


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


def run_vm(dev, config: Rv32Config, exe=None, warm: bool = True, inputs=None) -> dict:
    """Path 3 (paths 6 to 10 with ``exe`` and its ``inputs``): VirtualMachine
    keygen -> prove -> verify of the guest under the VM ``config`` through
    the port's entry points, the fibonacci guest by default; then, with
    ``warm``, a warm prove that must give the same bytes."""
    vm = VirtualMachine(config, device=dev)
    exe = exe or build_fib_program(VM_FIB_N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vm.keygen()
    commit = vm.commit_exe(exe)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    stages: dict = {}
    record: dict = {}
    proof, pre = vm.prove(exe, inputs=inputs, stages=stages, record=record)
    t2 = time.perf_counter()
    result = vm.verify(proof, expected_exe_commit=commit, exe=exe)
    t3 = time.perf_counter()
    launches = dict(_build.LAUNCHES)  # keygen, cold prove and verify
    out = {"vm": vm, "exe": exe, "proof": proof, "pre": pre, "result": result,
           "stages_s": stages, "record": record, "launches": launches,
           "s": {"keygen_and_commit_exe": t1 - t0, "prove": t2 - t1, "verify": t3 - t2}}
    if warm:
        # again, warm, as bench.py:91-96 re-measures a prove that took under
        # a third of its budget: the domain tables are built by now
        out["warm_stages_s"] = {}
        again, _ = vm.prove(exe, inputs=inputs, stages=out["warm_stages_s"])
        out["s"]["prove_warm"] = time.perf_counter() - t3
        require(codec.encode_proof(again) == codec.encode_proof(proof),
                "a second prove of the same guest gave other bytes")
    return out


def check_vm_kernels(vm, record: dict) -> dict:
    """K1, K3, K4 and K5 (``check_commit_kernels``), K7 (columns mode),
    K8, K9, K10, K7 (quotient), K12, K2, K13, K14 and K6 of a VM prove
    (path 3's, 6's or 7's, or one segment's of path 4 or 5) against their plain
    versions on the prove's own inputs: the main commit, the tables of
    the prove's one K8 launch over every AIR's sends, each AIR's chunk
    columns from its one K9 launch and its permutation trace, every AIR's
    quotient from one launch, every matrix's openings from one table and
    every matrix's reduced openings from one launch."""
    t0 = time.perf_counter()
    blocks: dict = {}
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
    # K7 on every AIR in one call, as the prove ran it (a second, streamed
    # launch for the budgeted programs); a job too large for the plain
    # version's slot file is compared on its first and last QUOTIENT_BLOCK
    # rows
    qrec = record["quotient"]
    got = qmod.evaluate_many(*(list(col) for col in zip(*qrec)))
    q_err = {}
    for i, g in enumerate(got):
        name, (prog, _, log_n, lqd) = vm.airs[i].name, qrec[i]
        nq = 1 << (log_n + lqd)
        if 8 * prog.lane_words * nq <= PLAIN_SLOT_BYTES:
            q_err[name] = max_abs_err(g, qmod.evaluate_plain(*qrec[i]))
            continue
        ranges = [(0, QUOTIENT_BLOCK), (nq - QUOTIENT_BLOCK, nq)]
        q_err[name] = max(max_abs_err(g[lo:hi], qmod.evaluate_plain(*qrec[i], lo, hi))
                          for lo, hi in ranges)
        blocks[name] = {"rows": nq, "compared": ranges,
                        "next_wraps_to": [0, (1 << lqd) - 1]}
    # the streamed launch's column-major copies of its jobs' sources, on
    # their first and last QUOTIENT_BLOCK rows
    t_err = {}
    for i, (prog, srcs, log_n, lqd) in enumerate(qrec):
        if not prog.budget:
            continue
        nq = 1 << (log_n + lqd)
        b = min(QUOTIENT_BLOCK, nq)
        for k, m in enumerate(srcs):
            t = qmod.transpose(m, nq)
            t_err[f"{vm.airs[i].name}/{k}"] = max(
                max_abs_err(t[:, lo:hi], m[lo:hi].t()) for lo, hi in ((0, b), (nq - b, nq)))
            del t
    # K12 on every matrix of the openings in one table, as the prove ran it
    ojobs, zpows = record["openings"]
    open_err = max(max_abs_err(a, b) for a, b in
                   zip(pv.open_many(ojobs, zpows), pv.open_many_plain(ojobs, zpows)))
    # K13 on every matrix of the reduced openings in one launch
    rjobs = record["reduced_openings"]
    got, want = pv.reduced_open_many(*rjobs), pv.reduced_open_many_plain(*rjobs)
    require(sorted(got) == sorted(want), "K13: heights")
    # K2's zeta power series, and K14 on every fold of the FRI commit phase
    zpows = record["openings"][1]
    folds, betas, ro_polys = record["fri_folds"]
    fold_err = max(max_abs_err(
        fri.fold_evals(e, b, ro_polys.get(int(e.shape[0]).bit_length() - 2)),
        fri.fold_evals_plain(e, b, ro_polys.get(int(e.shape[0]).bit_length() - 2)))
        for e, b in zip(folds, betas))
    # K6 on the prove's whole query gather
    gplan, gidx = record["gather"]
    errs = {"quotient_columns": max(cols_err.values()), "lookup_hist": hist_err,
            "perm_cols": max(perm_err.values()), "perm_scan": max(scan_err.values()),
            "quotient": max(q_err.values()), "open_dot": open_err,
            "quotient_transpose": max(t_err.values(), default=0),
            "ext_powers": max_abs_err(zpows, ef.powers_plain(zpows[1], int(zpows.shape[0]))),
            "fri_fold": fold_err,
            "fri_reduced_open": max(max_abs_err(got[k], want[k]) for k in want),
            "gather": max_abs_err(gplan.run_device(gidx), gplan.run_plain(gidx))}
    commit = check_commit_kernels(vm, record)
    errs.update(commit.pop("max"))
    require(all(v == 0 for v in errs.values()),
            f"kernel and plain differ on the VM prove's inputs: {cols_err} "
            f"{perm_err} {scan_err} {q_err} {t_err} {errs}")
    return {"max": errs, "main_commit": commit, "s": time.perf_counter() - t0,
            "columns_airs": len(cols_err), "perm_airs": len(perm_err),
            "open_jobs": len(ojobs), "reduced_open_jobs": len(rjobs[0]),
            "gather_jobs": len(gplan.jobs), "quotient_blocks": blocks,
            "transposed_sources": sorted(t_err),
            "quotient_airs": {vm.airs[i].name: {"log_n": r[2], "lqd": r[3],
                                                "instructions": int(r[0].code.shape[0]),
                                                "lane_words": r[0].lane_words,
                                                "budget": r[0].budget,
                                                "reloads": r[0].reloads}
                              for i, r in enumerate(qrec)}}


def check_commit_kernels(vm, record: dict) -> dict:
    """K1, K3, K4 and K5 of a VM prove's main commit against their plain
    versions on the prove's own inputs.  K1: the widest AIR's trace made
    Montgomery again from its canonical words.  K3: its main LDE, as
    the prove's batched call made it, against the plain LDE of its trace,
    PLAIN_LDE_COLUMNS columns at a time.  K4 and K5: the main tree built
    again as the prove builds it (``merkle.commit_layers``); the row hashes
    of the matrices of each height (every column) against plain on their
    first and last QUOTIENT_BLOCK rows, and every layer above the leaves
    against the plain compression of the layer below and those hashes."""
    lb = vm.pk.vk.config.fri.log_blowup
    ctxs = record["ctxs"]
    # an AIR's quotient sources start with its cached mains' LDEs, then its
    # common main's: the LDEs the main commit took
    commons = [src[len(c.cached_mains)] for c, (_, src, _, _) in zip(ctxs, record["quotient"])]
    w = max(range(len(ctxs)), key=lambda i: int(ctxs[i].common_main.shape[1]))
    trace, lde = ctxs[w].common_main, commons[w]
    # K1 on the whole canonical trace, as ``bb.monty`` ran it on the upload
    rows = range(0, int(trace.shape[0]), QUOTIENT_BLOCK)
    canon = torch.empty_like(trace)
    for r in rows:
        canon[r:r + QUOTIENT_BLOCK] = bb.from_monty_plain(trace[r:r + QUOTIENT_BLOCK])
    got = bb.to_monty(canon)
    monty_err = max(max(max_abs_err(got[r:r + QUOTIENT_BLOCK], bb.to_monty_plain(
        canon[r:r + QUOTIENT_BLOCK])), max_abs_err(got[r:r + QUOTIENT_BLOCK],
                                                   trace[r:r + QUOTIENT_BLOCK]))
                    for r in rows)
    del canon, got
    lde_err = max(max_abs_err(lde[:, c:c + PLAIN_LDE_COLUMNS], ntt.coset_lde_plain(
        trace[:, c:c + PLAIN_LDE_COLUMNS].contiguous(), lb))
        for c in range(0, int(trace.shape[1]), PLAIN_LDE_COLUMNS))
    by_h: dict = {}
    for m in commons:
        by_h.setdefault(int(m.shape[0]), []).append(m)
    layers = merkle.commit_layers(commons)
    hash_err, widths = 0, {}

    def row_hashes(h):
        nonlocal hash_err
        ms = by_h[h]
        m = (ms[0] if len(ms) == 1 else torch.cat(ms, dim=1)).contiguous()
        digests, b = p2.hash_rows(m), min(QUOTIENT_BLOCK, h)
        hash_err = max([hash_err] + [max_abs_err(digests[lo:hi], p2.hash_rows_plain(m[lo:hi]))
                                     for lo, hi in ((0, b), (h - b, h))])
        widths[h] = int(m.shape[1])
        return digests

    top = int(layers[0].shape[0])
    leaves = row_hashes(top)
    hash_err = max(hash_err, max_abs_err(layers[0], leaves))
    single, _ = merkle.commit_plan(top, merkle.TAIL_MAX)
    layer_err = {True: 0, False: 0}  # by whether the layer had a launch of its own
    for below, layer in zip(layers, layers[1:]):
        h = int(layer.shape[0])
        inj = row_hashes(h) if h in by_h else None
        layer_err[h in single] = max(layer_err[h in single], max_abs_err(
            layer, merkle.compress_layer_plain(below, inj)))
    return {"lde_air": vm.airs[w].name, "lde_shape": [int(lde.shape[0]), int(lde.shape[1])],
            "hash_rows_widths": widths, "hash_rows_block": QUOTIENT_BLOCK,
            "layers_compared": len(layers) - 1,
            "max": {"bb_elementwise": monty_err, "ntt": lde_err,
                    "poseidon2_hash_rows": hash_err,
                    "poseidon2_compress_layer": layer_err[True],
                    "poseidon2_compress_tail": layer_err[False]}}


def launch_summary(names: list, qrec: list) -> list:
    """K7's launches over quotient jobs (``names`` their AIRs): the AIRs of
    each, whether it is the streamed launch, slot words a row, staged code,
    threads, blocks, shared bytes a block and the warps an SM holds."""
    progs = [r[0] for r in qrec]
    heights = [1 << (r[2] + r[3]) for r in qrec]
    out = []
    for idx, streamed, lane_words, code_cap, threads in qmod.launch_plan(progs):
        total = qmod.block_plan([heights[k] for k in idx], threads)[2]
        smem = lane_words * 4 * threads + 16 * code_cap
        out.append({"airs": [names[k] for k in idx], "streamed": streamed,
                    "lane_words": lane_words, "code_words": code_cap, "threads": threads,
                    "blocks": total, "smem_bytes": smem,
                    "warps_per_sm": min(qmod.SM_SMEM_BYTES // (smem + 1024), 32)
                    * threads // 32})
    return out


def fib_u32(n: int) -> int:
    """fib(n) mod 2^32."""
    a, b = 0, 1
    for _ in range(n):
        a, b = b, (a + b) & 0xFFFFFFFF
    return a


def fib_insns(n: int) -> int:
    """The instructions build_fib_program(n) runs: 5 a loop iteration, 15
    or 16 around the loop (n loaded by one addi below 2048, else lui +
    addi), and one more when its unsigned bltu (fib(n) < fib(n + 1) mod
    2^32) is not taken and the instruction after it runs."""
    return 5 * n + (15 if n < 2048 else 16) + (fib_u32(n) >= fib_u32(n + 1))


def summed_stages(per_segment: list) -> dict:
    out: dict = {}
    for st in per_segment:
        for k, v in st.items():
            out[k] = out.get(k, 0.0) + v
    return out


def run_continuations(dev, cfg: StarkConfig, exe=None, limits=CONT_LIMITS,
                      **flags) -> dict:
    """Path 4 (path 5 with ``exe``, its ``limits`` and the config's
    extension ``flags``): the persistent VM's keygen -> execute_metered ->
    prove_continuations -> verify_segments of the guest through the port's
    entry points, the fibonacci guest by default, then a warm
    prove_continuations that must give the same bytes and records segment
    0's kernel inputs.  Every segment's device tensors are freed before the
    next segment starts: the peak is read over the cold run, before the
    record holds segment 0's."""
    vm = VirtualMachine(Rv32Config(stark=cfg, executors=FIB_EXECUTORS, persistent=True,
                                   **flags), device=dev)
    exe = exe or build_fib_program(CONT_FIB_N)
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    vm.keygen()
    commit = vm.commit_exe(exe)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    metered = vm.execute_metered(exe)
    t2 = time.perf_counter()
    stages: list = []
    proofs, tree = vm.prove_continuations(exe, segment_limits=limits, stages=stages)
    t3 = time.perf_counter()
    result = vm.verify_segments(proofs, exe, expected_exe_commit=commit)
    t4 = time.perf_counter()
    launches = dict(_build.LAUNCHES)  # keygen, cold proves and verify
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    warm_stages: list = []
    record: dict = {}
    warm, warm_tree = vm.prove_continuations(exe, segment_limits=limits,
                                             stages=warm_stages, records={0: record})
    t5 = time.perf_counter()
    blobs = [codec.encode_proof(p) for p in proofs]
    require([codec.encode_proof(p) for p in warm] == blobs
            and warm_tree.root().tolist() == tree.root().tolist(),
            "a second continuation run of the same guest gave other bytes")
    return {"vm": vm, "exe": exe, "proofs": proofs, "blobs": blobs, "tree": tree,
            "result": result, "metered": metered, "stages": stages,
            "warm_stages": warm_stages, "launches": launches, "peak_gb": peak_gb,
            "start_gb": start_gb, "record": record,
            "s": {"keygen_and_commit_exe": t1 - t0, "execute_metered": t2 - t1,
                  "prove": t3 - t2, "verify_segments": t4 - t3, "prove_warm": t5 - t4}}


def quotient_path4_timing(dev, rng, vm, heights: dict) -> dict:
    """K7 over path 4's 16 AIRs at a full segment's heights, on random
    sources and random publics, challenges and alpha (the shared launch
    and Poseidon2Air's streamed launch), against the shared launch alone
    without Poseidon2Air: its 3,658 instructions and 463 slot words a row
    sized every block of the one launch before it was budgeted (27.04 ms
    against 8.02 ms on this card then).  Every job equals its plain
    version, and the rv32_base_alu job gives the same words in both
    calls."""
    progs, srcs, log_ns, lqds = [], [], [], []
    for i, air in enumerate(vm.airs):
        vk, apk = vm.pk.vk.per_air[i], vm.pk.per_air[i]
        has_perm = bool(vk.widths.after_challenge)
        progs.append(qmod.compile_dag(
            vk.dag, n_main=len(vk.widths.main_widths()),
            has_preprocessed=apk.preprocessed_trace is not None, has_perm=has_perm,
            publics=bb.to_monty_np(rng.integers(0, P, size=max(vk.num_public_values, 1))),
            challenges=bb.to_monty_np(rng.integers(0, P, size=(2, 4))),
            exposed=bb.to_monty_np(rng.integers(0, P, size=(1, 4))),
            alpha=bb.to_monty_np(rng.integers(0, P, size=4))))
        log_ns.append(heights[air.name].bit_length() - 1)
        lqds.append(vk.log_quotient_degree)
        rows = 1 << (log_ns[-1] + lqds[-1])
        widths = vk.widths.main_widths() + (
            [vk.widths.preprocessed] if apk.preprocessed_trace is not None else []) + (
            [4 * vk.widths.after_challenge] if has_perm else [])
        srcs.append([words(rng, dev, rows, w) for w in widths])
    keep = [k for k, a in enumerate(vm.airs) if a.name != "poseidon2"]
    alu = vm.air_index["rv32_base_alu"]
    sub = [[col[k] for k in keep] for col in (progs, srcs, log_ns, lqds)]
    with_p2 = qmod.evaluate_many(progs, srcs, log_ns, lqds)
    plain_err = {air.name: max_abs_err(with_p2[i], qmod.evaluate_plain(
        progs[i], srcs[i], log_ns[i], lqds[i])) for i, air in enumerate(vm.airs)}
    require(all(v == 0 for v in plain_err.values()),
            f"K7's path-4 launch differs from plain: {plain_err}")
    without = qmod.evaluate_many(*sub)[keep.index(alu)]
    require(max_abs_err(with_p2[alu], without) == 0,
            "K7's rv32_base_alu job depends on the launch")
    del with_p2, without
    names = [a.name for a in vm.airs]
    recs = list(zip(progs, srcs, log_ns, lqds))
    p2 = [k for k in range(len(progs)) if k not in keep]
    return {"heights": {a.name: heights[a.name] for a in vm.airs},
            "launch": launch_summary(names, recs),
            "plain_max_abs_err": max(plain_err.values()),
            "ms": cuda_ms(lambda: qmod.evaluate_many(progs, srcs, log_ns, lqds), 5),
            "bound_ms": bound(*quotient_cost(recs))[0],
            "poseidon2_alone": {
                "ms": cuda_ms(lambda: qmod.evaluate_many(
                    *([col[k] for k in p2] for col in (progs, srcs, log_ns, lqds))), 5),
                "bound_ms": bound(*quotient_cost([recs[k] for k in p2]))[0]},
            "without_poseidon2": {
                "launch": launch_summary([names[k] for k in keep], [recs[k] for k in keep]),
                "ms": cuda_ms(lambda: qmod.evaluate_many(*sub), 5),
                "bound_ms": bound(*quotient_cost([recs[k] for k in keep]))[0]},
            "one_launch_before_ms": {"with_poseidon2": 27.04, "without_poseidon2": 8.02}}


def run_keccak(dev, cfg: StarkConfig) -> dict:
    """Path 5: the keccak-iteration guest's continuations (run_continuations
    with the keccak extension), held to its segments' shapes, its public
    values and pinned proofs; K7's launch plan of segment 0, every kernel
    against plain on segment 0's own inputs, and K7's streamed launch on
    segment 0's keccakf and keccak_sponge jobs (``stream_timing``)."""
    kc = run_continuations(dev, cfg, build_keccak_iter_program(KECCAK_ITER_N),
                           KECCAK_LIMITS, keccak=True)
    launches, vm = kc["launches"], kc["vm"]
    n_seg = len(kc["proofs"])
    require(all(v for k, v in launches.items() if k not in OFF_PATH),
            f"a kernel of path 5 never ran: {launches}")
    require(launches["quotient"] == 2 * n_seg
            and all(launches[k] == n_seg for k in ("lookup_hist", "perm_cols",
                                                    "fri_reduced_open", "ext_powers",
                                                    "gather"))
            and not any(launches[k] for k in OFF_PATH),
            f"path 5 takes two quotient launches (shared and streamed) and one "
            f"lookup_hist, perm_cols, fri_reduced_open, ext_powers and gather launch "
            f"a segment, and no elementwise K2: {launches}")
    instret = kc["metered"]["instret"]
    require(instret == iter_insns(KECCAK_ITER_N) and kc["metered"]["exit_code"] == 0,
            f"path 5's guest ran {instret} instructions")
    seg_heights = [{vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in proof.per_air}
                   for proof in kc["proofs"]]
    require(n_seg == KECCAK_SEGMENTS and kc["result"]["num_segments"] == n_seg
            and all(hs[name] == 1 << lh for hs, want in zip(seg_heights, KECCAK_LOG_HEIGHTS)
                    for name, lh in want.items()),
            f"path 5's segments: {seg_heights}")
    pv = pv_proof(kc["tree"])
    require(verify_pv_proof(pv) and pv["root"].tolist() == list(kc["result"]["final_root"]),
            "the public-values proof does not open the final root")
    pvs = [int(b) for b in pv["public_values"][:8]]
    require(pvs == KECCAK_ITER_PVS, f"path 5's public values {pvs}")
    shas = tuple(hashlib.sha256(b).hexdigest() for b in kc["blobs"])
    require(shas == KECCAK_PROOF_SHA256, f"path 5's segment proofs sha {shas}")
    record = kc.pop("record")
    plan = launch_summary([a.name for a in vm.airs], record["quotient"])
    require([set(e["airs"]) for e in plan if e["streamed"]]
            == [{"poseidon2", "keccakf", "keccak_sponge"}],
            f"path 5's streamed launch: {plan}")
    kc.update(launches=launches, heights=seg_heights, public_values=pvs, shas=shas,
              launch_plan=plan, plain_checks=check_vm_kernels(vm, record),
              stream=stream_timing(vm, record["quotient"]))
    return kc


# K7's streamed launch on path 5's keccakf job, the global-memory mode it
# replaced beside it (ms, measured on an NVIDIA H100 80GB HBM3, 700.00 W, on
# path 5's first segment at 30,000 iterations: these quotient rows)
GLOBAL_MODE_MS = {"keccakf": {"rows": 1 << 20, "ms": (258.6, 262.0)},
                  "keccak_sponge": {"rows": 1 << 16, "ms": (4.47, 4.53)}}
STREAM_BUDGETS = (48, 64, 128, 256, 384)


def rebudget(vm, qrec: list, name: str, budget: int):
    """The quotient job of AIR ``name`` (qrec: a prove's record) with its
    program compiled again at ``budget`` slot words a row, its pool kept:
    a budget changes the slots and the reloads, not the pool."""
    i = vm.air_index[name]
    prog, src, log_n, lqd = qrec[i]
    vk, apk = vm.pk.vk.per_air[i], vm.pk.per_air[i]
    code = qmod.compile_dag_code(vk.dag, n_main=len(vk.widths.main_widths()),
                                 has_preprocessed=apk.preprocessed_trace is not None,
                                 has_perm=bool(vk.widths.after_challenge), budget=budget)
    require(code.pool_spec == prog.pool_spec, f"{name}: the pool moved at budget {budget}")
    return (replace(code, pool=prog.pool), src, log_n, lqd)


def stream_timing(vm, qrec: list) -> dict:
    """K7's streamed launch on a segment's own keccakf and keccak_sponge
    jobs: each alone and the two together (one launch), beside their bound
    and the global-memory mode's figure; each compiled at every budget of
    STREAM_BUDGETS, each budget's words held against plain on the first
    QUOTIENT_BLOCK rows (the budgets' times at 32, 64 and 128 threads a
    block are PR 12's, PERF.md, and are not taken again); the segment's
    whole quotient call (both launches) and its shared launch alone;
    a job of fewer rows than QUOTIENT_BLOCK is compared on all its rows;
    keccak_sponge's plain version, and keccakf's on one block of
    QUOTIENT_BLOCK rows; the column-major copy of keccakf's main LDE.  The
    bound reads the program's function: reloads, spills and fills cost
    nothing, so it must equal the bound of the program compiled with no
    budget that binds."""
    idx = {vm.airs[i].name: i for i in range(len(qrec))}
    out = {}
    for name in ("keccakf", "keccak_sponge"):
        prog, _, log_n, lqd = rec = qrec[idx[name]]
        b_ms, b_by = bound(*quotient_cost([rec]))
        huge = rebudget(vm, qrec, name, 1 << 20)
        require(huge[0].reloads == 0 and bound(*quotient_cost([huge]))[0] == b_ms,
                f"{name}: the bound moved with the budget")
        out[name] = {"rows": 1 << (log_n + lqd), "instructions": int(prog.code.shape[0]),
                     "instructions_unbudgeted": int(huge[0].code.shape[0]),
                     "lane_words": prog.lane_words, "budget": prog.budget,
                     "reloads": prog.reloads, "spills": prog.spills,
                     "launch": launch_summary([name], [rec])[0],
                     "ms": cuda_ms(lambda: qmod.evaluate(*rec), 3),
                     "bound_ms": b_ms, "bound_by": b_by, "global_mode_ms": GLOBAL_MODE_MS[name]}
        sweep = {}
        for budget in STREAM_BUDGETS:
            try:
                brec = rebudget(vm, qrec, name, budget)
            except ValueError as e:  # an instruction's operands past the budget
                sweep[str(budget)] = f"does not compile: {e}"
                continue
            got = qmod.evaluate(*brec)
            block = min(QUOTIENT_BLOCK, 1 << (log_n + lqd))
            err = max_abs_err(got[:block], qmod.evaluate_plain(*brec, 0, block))
            require(err == 0, f"{name} at budget {budget} differs from plain")
            del got
            sweep[str(budget)] = {"instructions": int(brec[0].code.shape[0]),
                                  "reloads": brec[0].reloads, "spills": brec[0].spills,
                                  "lane_words": brec[0].lane_words}
        out[name]["sweep"] = sweep
    sp = qrec[idx["keccak_sponge"]]
    out["keccak_sponge"]["plain_ms"] = cuda_ms(lambda: qmod.evaluate_plain(*sp), 1)
    kf = qrec[idx["keccakf"]]
    # the column-major copy of keccakf's main LDE that the launch makes;
    # the plain version is itself the one PyTorch call that does it
    m, nq = kf[1][0], 1 << (kf[2] + kf[3])
    out["transpose"] = {"shape": [nq, int(m.shape[1])],
                        "ms": cuda_ms(lambda: qmod.transpose(m, nq), 3),
                        "plain_ms": cuda_ms(lambda: qmod.transpose_plain(m, nq), 3),
                        "bound_ms": bound(2 * nq * int(m.shape[1]) * 4, 0)[0]}
    out["keccakf"]["plain_ms_block"] = cuda_ms(
        lambda: qmod.evaluate_plain(*kf, 0, QUOTIENT_BLOCK), 1)
    out["keccakf"]["plain_block_rows"] = QUOTIENT_BLOCK
    both = [kf, sp]
    cols = [list(col) for col in zip(*both)]
    b_ms, b_by = bound(*quotient_cost(both))
    out["keccak_launch"] = {"ms": cuda_ms(lambda: qmod.evaluate_many(*cols), 3),
                            "bound_ms": b_ms, "bound_by": b_by,
                            "launch": launch_summary(["keccakf", "keccak_sponge"], both)[0]}
    every = [list(col) for col in zip(*qrec)]
    out["segment_quotient_ms"] = cuda_ms(lambda: qmod.evaluate_many(*every), 3)
    shared = [r for r in qrec if not r[0].budget]
    out["shared_launch_ms"] = cuda_ms(
        lambda: qmod.evaluate_many(*(list(col) for col in zip(*shared))), 3)
    return out


def require_one_prove(launches: dict, path: str) -> None:
    """A volatile VM prove with large programs (paths 6 and 7): every
    kernel but the elementwise K2 ran, K7 in two launches (shared and
    streamed), and one lookup_hist, perm_cols, fri_reduced_open,
    ext_powers and gather launch."""
    require(all(v for k, v in launches.items() if k not in OFF_PATH),
            f"a kernel of {path} never ran: {launches}")
    require(launches["quotient"] == 2
            and all(launches[k] == 1 for k in ("lookup_hist", "perm_cols",
                                               "fri_reduced_open", "ext_powers", "gather"))
            and not any(launches[k] for k in OFF_PATH),
            f"{path} takes two quotient launches (shared and streamed) and one "
            f"lookup_hist, perm_cols, fri_reduced_open, ext_powers and gather launch "
            f"a prove and no elementwise K2: {launches}")


def quotient_split(vm, qrec: list, streamed_names, path: str) -> tuple:
    """K7 over a VM prove's own jobs: the streamed launch must hold exactly
    ``streamed_names``' programs, and the job of the shared launch's largest
    program must be the same whichever launch it shares.  Returns
    (both launches, the streamed programs alone, the shared launch without
    them), each timed beside its bound."""
    names = [a.name for a in vm.airs]
    keep = [i for i, name in enumerate(names) if name not in streamed_names]
    sub = [qrec[i] for i in keep]
    streamed = [qrec[i] for i in range(len(qrec)) if i not in keep]
    key = max(keep, key=lambda i: int(qrec[i][0].code.shape[0]))
    with_streamed = qmod.evaluate_many(*(list(col) for col in zip(*qrec)))[key]
    without = qmod.evaluate_many(*(list(col) for col in zip(*sub)))[keep.index(key)]
    require(max_abs_err(with_streamed, without) == 0,
            f"K7's {names[key]} job depends on the launch")
    both = {"launch": launch_summary(names, qrec),
            "ms": cuda_ms(lambda: qmod.evaluate_many(*(list(c) for c in zip(*qrec))), 5),
            "bound_ms": bound(*quotient_cost(qrec))[0]}
    require([set(e["airs"]) for e in both["launch"] if e["streamed"]]
            == [set(streamed_names)], f"{path}'s K7 plan: {both['launch']}")
    alone = {"ms": cuda_ms(lambda: qmod.evaluate_many(*(list(c) for c in zip(*streamed))), 5),
             "bound_ms": bound(*quotient_cost(streamed))[0]}
    rest = {"launch": launch_summary([names[i] for i in keep], sub),
            "ms": cuda_ms(lambda: qmod.evaluate_many(*(list(c) for c in zip(*sub))), 5),
            "bound_ms": bound(*quotient_cost(sub))[0]}
    return both, alone, rest


def run_sha(dev, cfg: StarkConfig) -> dict:
    """Path 6: the sha256-iteration guest's volatile VM proof (run_vm with
    the sha256 extension), held to its heights, its public values and its
    pinned proof; K7's two launches (sha256's two programs streamed) and
    the shared launch alone without them, beside the one launch before
    (164.0 ms against 0.19-0.20 without sha256's programs), and every
    kernel against plain on the prove's own inputs."""
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    r = run_vm(dev, Rv32Config(stark=cfg, executors=FIB_EXECUTORS, sha256=True),
               build_sha256_iter_program(SHA_ITER_N), warm=False)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, vm, pre = r["launches"], r["vm"], r["pre"]
    require_one_prove(launches, "path 6")
    require(pre.exit_code == 0 and pre.instret == iter_insns(SHA_ITER_N),
            f"path 6's guest ran {pre.instret} instructions")
    heights = {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in r["proof"].per_air}
    require(all(heights[name] == 1 << lh for name, lh in SHA_LOG_HEIGHTS.items()),
            f"path 6's heights: {heights}")
    digest = bytes(32)
    for _ in range(SHA_ITER_N):
        digest = hashlib.sha256(digest).digest()
    pvs = list(r["result"]["public_values"][:8])
    require(pvs == list(digest[:4]) + list(digest[28:32]), f"path 6's public values {pvs}")
    blob = codec.encode_proof(r["proof"])
    sha = hashlib.sha256(blob).hexdigest()
    require(sha == SHA_PROOF_SHA256, f"path 6's proof sha {sha}")
    both, alone, rest = quotient_split(vm, r["record"]["quotient"], ("sha256", "sha256_sponge"),
                                       "path 6")
    quotient = {**both, "sha256_alone": alone, "without_sha256": rest,
                "one_launch_before_ms": {"with_sha256": [162.8, 164.0],
                                         "without_sha256": [0.19, 0.20]}}
    r.update(launches=launches, heights=heights, public_values=pvs, blob=blob, sha=sha,
             peak_gb=peak_gb, start_gb=start_gb, quotient=quotient,
             plain_checks=check_vm_kernels(vm, r.pop("record")))
    return r


def phase_keccak(dev, cfg: StarkConfig, err: dict) -> tuple:
    """Path 5 (``run_keccak``) and its line; folds its plain checks into
    ``err``.  Returns its launches and K7's streamed-launch timing."""
    kc = run_keccak(dev, cfg)
    ks = kc["s"]
    err.update({k: max(v, err.get(k, 0)) for k, v in kc["plain_checks"]["max"].items()})
    emit({"phase": "keccak", "guest": f"build_keccak_iter_program({KECCAK_ITER_N})",
          "executors": list(FIB_EXECUTORS), "keccak": True, "persistent": True,
          "limits": KECCAK_LIMITS, "insns": kc["metered"]["instret"],
          "keccak_blocks": KECCAK_ITER_N, "segments": len(kc["proofs"]),
          "metered": kc["metered"], "heights": kc["heights"],
          "queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "s": ks, "stage_s": summed_stages(kc["stages"]),
          "warm_stage_s": summed_stages(kc["warm_stages"]),
          "segment_stage_s": kc["stages"], "segment_warm_stage_s": kc["warm_stages"],
          "insn_per_s": kc["metered"]["instret"] / ks["prove_warm"],
          "insn_per_s_cold": kc["metered"]["instret"] / ks["prove"],
          "blocks_per_s": KECCAK_ITER_N / ks["prove_warm"],
          "blocks_per_s_cold": KECCAK_ITER_N / ks["prove"],
          "verified": True, "public_values": kc["public_values"],
          "proof_bytes": [len(b) for b in kc["blobs"]], "proof_sha256": list(kc["shas"]),
          "peak_gb": kc["peak_gb"], "peak_above_start_gb": kc["peak_gb"] - kc["start_gb"],
          "launches": kc["launches"], "quotient_launch_plan": kc["launch_plan"],
          "plain_checks": kc["plain_checks"], "quotient_stream": kc["stream"]})
    return kc["launches"], kc["stream"]


def phase_sha(dev, cfg: StarkConfig, err: dict) -> dict:
    """Path 6 (``run_sha``) and its line; folds its plain checks into
    ``err``.  Returns its launches."""
    sr = run_sha(dev, cfg)
    err.update({k: max(v, err.get(k, 0)) for k, v in sr["plain_checks"]["max"].items()})
    s_insns, s_prove = sr["pre"].instret, sr["s"]["prove"]
    emit({"phase": "sha256", "guest": f"build_sha256_iter_program({SHA_ITER_N})",
          "executors": list(FIB_EXECUTORS), "sha256": True, "insns": s_insns,
          "sha256_blocks": SHA_ITER_N, "heights": sr["heights"],
          "queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "s": sr["s"], "stage_s": sr["stages_s"],
          "insn_per_s_cold": s_insns / s_prove, "blocks_per_s_cold": SHA_ITER_N / s_prove,
          "verified": True, "public_values": sr["public_values"],
          "proof_bytes": len(sr["blob"]), "proof_sha256": sr["sha"],
          "peak_gb": sr["peak_gb"], "peak_above_start_gb": sr["peak_gb"] - sr["start_gb"],
          "launches": sr["launches"], "quotient": sr["quotient"],
          "plain_checks": sr["plain_checks"]})
    return sr["launches"]


def run_u256(dev, cfg: StarkConfig) -> dict:
    """Path 7: the sha256 + u256 guest's volatile VM proof (run_vm with the
    sha256, int256 and modular extensions), held to its heights, its
    public values and its pinned proof; K7's two launches (the 14
    extension programs streamed), the streamed launch alone and the
    shared one without it beside their bounds, and every kernel against
    plain on the prove's own inputs."""
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    r = run_vm(dev, Rv32Config(stark=cfg, **U256_CONFIG), build_u256_iter_program(U256_ITER_N),
               warm=False)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, vm, pre = r["launches"], r["vm"], r["pre"]
    require_one_prove(launches, "path 7")
    counts = u256_iter_counts(U256_ITER_N)
    rows = {k: len(next(iter(v.values()))) for k, v in pre.records.items()}
    ops = {"int256": sum(v for k, v in rows.items() if k.startswith("int256_")),
           "modular": sum(v for k, v in rows.items() if k.startswith("modular_"))}
    require(pre.exit_code == 0 and pre.instret == counts["insns"]
            and ops["int256"] == counts["int256_ops"]
            and ops["modular"] == counts["modular_ops"]
            and rows["sha256_sponge"] == counts["sha256_blocks"],
            f"path 7's guest ran {pre.instret} instructions, {ops} ops: {rows}")
    heights = {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in r["proof"].per_air}
    require(all(heights[name] == 1 << lh for name, lh in U256_LOG_HEIGHTS.items()),
            f"path 7's heights: {heights}")
    pvs = list(r["result"]["public_values"])
    require(pvs == u256_iter_reference(U256_ITER_N), f"path 7's public values {pvs}")
    blob = codec.encode_proof(r["proof"])
    sha = hashlib.sha256(blob).hexdigest()
    require(sha == U256_PROOF_SHA256, f"path 7's proof sha {sha}")
    qrec = r["record"]["quotient"]
    both, alone, rest = quotient_split(vm, qrec, U256_STREAMED, "path 7")
    alone["jobs"] = {a.name: {"log_rows": q[2] + q[3], "instructions": int(q[0].code.shape[0])}
                     for a, q in zip(vm.airs, qrec) if a.name in U256_STREAMED}
    quotient = {**both, "streamed_alone": alone, "without_streamed": rest}
    r.update(launches=launches, heights=heights, public_values=pvs, blob=blob, sha=sha,
             peak_gb=peak_gb, start_gb=start_gb, quotient=quotient, rows=rows, ops=ops,
             plain_checks=check_vm_kernels(vm, r.pop("record")))
    return r


def phase_u256(dev, cfg: StarkConfig, err: dict) -> dict:
    """Path 7 (``run_u256``) and its line; folds its plain checks into
    ``err``.  Returns its launches."""
    ur = run_u256(dev, cfg)
    err.update({k: max(v, err.get(k, 0)) for k, v in ur["plain_checks"]["max"].items()})
    insns, prove_s = ur["pre"].instret, ur["s"]["prove"]
    n_ops = ur["ops"]["int256"] + ur["ops"]["modular"]
    emit({"phase": "u256", "guest": f"build_u256_iter_program({U256_ITER_N})",
          "executors": list(FIB_EXECUTORS), "sha256": True, "bigint": True,
          "moduli": [hex(m) for m in U256_MODULI], "insns": insns,
          "int256_ops": ur["ops"]["int256"], "modular_ops": ur["ops"]["modular"],
          "sha256_blocks": U256_ITER_N, "rows": ur["rows"], "heights": ur["heights"],
          "queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "s": ur["s"], "stage_s": ur["stages_s"],
          "insn_per_s_cold": insns / prove_s, "u256_ops_per_s_cold": n_ops / prove_s,
          "verified": True, "public_values": ur["public_values"][:20],
          "proof_bytes": len(ur["blob"]), "proof_sha256": ur["sha"],
          "peak_gb": ur["peak_gb"], "peak_above_start_gb": ur["peak_gb"] - ur["start_gb"],
          "launches": ur["launches"], "quotient": ur["quotient"],
          "plain_checks": ur["plain_checks"]})
    return ur["launches"]


def run_ecrecover(dev, cfg: StarkConfig) -> dict:
    """Path 8: the ecrecover guest's volatile VM proof (run_vm with the
    default executors, keccak, both moduli and the curve), held to its
    counts, its heights, its public values and its pinned proof; K7's two
    launches (the extension programs streamed), the streamed launch alone
    with its jobs and the shared one without it beside their bounds, and
    every kernel against plain on the prove's own inputs."""
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    r = run_vm(dev, Rv32Config(stark=cfg, **ECRECOVER_CONFIG), build_ecrecover_program(ECRECOVER_N),
               warm=False, inputs=ecrecover_stream(ECRECOVER_N, ECRECOVER_SEED))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, vm, pre = r["launches"], r["vm"], r["pre"]
    require_one_prove(launches, "path 8")
    counts = ecrecover_counts(ECRECOVER_N, ECRECOVER_SEED)
    rows = {k: len(next(iter(v.values()))) for k, v in pre.records.items()}
    got = {"insns": pre.instret, "ec_add_ne": rows.get("sw_add_ne_0", 0),
           "ec_double": rows.get("sw_double_0", 0),
           "keccak_blocks": rows.get("keccak_sponge", 0),
           **{k: rows.get(k, 0) for k in counts if k.startswith("modular_")}}
    require(pre.exit_code == 0 and got == counts,
            f"path 8's guest: exit {pre.exit_code}, {got} against {counts}")
    idle = [a.name for a in vm.airs if a.name.startswith("rv32_") and not rows.get(a.name)]
    require(not idle, f"RV32IM chips without a real row on path 8: {idle}")
    heights = {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in r["proof"].per_air}
    require(ECRECOVER_LOG_HEIGHTS is not None
            and all(heights[name] == 1 << lh for name, lh in ECRECOVER_LOG_HEIGHTS.items()),
            f"path 8's heights: {heights}")
    pvs = list(r["result"]["public_values"])
    require(pvs == ecrecover_reference(ECRECOVER_N, ECRECOVER_SEED),
            f"path 8's public values {pvs}")
    blob = codec.encode_proof(r["proof"])
    sha = hashlib.sha256(blob).hexdigest()
    require(sha == ECRECOVER_PROOF_SHA256, f"path 8's proof sha {sha}")
    qrec = r["record"]["quotient"]
    both, alone, rest = quotient_split(vm, qrec, ECRECOVER_STREAMED, "path 8")
    alone["jobs"] = {a.name: {"log_rows": q[2] + q[3], "instructions": int(q[0].code.shape[0])}
                     for a, q in zip(vm.airs, qrec) if a.name in ECRECOVER_STREAMED}
    alone["instruction_rows"] = sum(int(q[0].code.shape[0]) << (q[2] + q[3])
                                    for a, q in zip(vm.airs, qrec)
                                    if a.name in ECRECOVER_STREAMED)
    quotient = {**both, "streamed_alone": alone, "without_streamed": rest}
    tracegen_s = r["record"]["tracegen_s"]
    r.update(launches=launches, heights=heights, public_values=pvs, blob=blob, sha=sha,
             peak_gb=peak_gb, start_gb=start_gb, quotient=quotient, rows=rows, counts=counts,
             tracegen_s={k: tracegen_s[k] for k in ("sw_add_ne_0", "sw_double_0", "keccakf")},
             plain_checks=check_vm_kernels(vm, r.pop("record")))
    return r


def phase_ecrecover(dev, cfg: StarkConfig, err: dict) -> dict:
    """Path 8 (``run_ecrecover``) and its line; folds its plain checks into
    ``err``.  Returns its launches."""
    t0 = time.perf_counter()
    er = run_ecrecover(dev, cfg)
    err.update({k: max(v, err.get(k, 0)) for k, v in er["plain_checks"]["max"].items()})
    insns, prove_s, c = er["pre"].instret, er["s"]["prove"], er["counts"]
    ec_ops = c["ec_add_ne"] + c["ec_double"]
    emit({"phase": "ecrecover", "guest": f"build_ecrecover_program({ECRECOVER_N})",
          "seed": ECRECOVER_SEED, "executors": list(FULL_EXECUTORS), "keccak": True,
          "moduli": [hex(m) for m in ECRECOVER_MODULI],
          "curves": [[hex(m), a] for m, a in ECRECOVER_CONFIG["curves"]],
          "signatures": ECRECOVER_N, "insns": insns, "counts": c, "rows": er["rows"],
          "heights": er["heights"], "queries": cfg.fri.num_queries,
          "pow_bits": cfg.fri.proof_of_work_bits, "s": er["s"], "stage_s": er["stages_s"],
          "tracegen_s": er["tracegen_s"], "insn_per_s_cold": insns / prove_s,
          "signatures_per_s_cold": ECRECOVER_N / prove_s,
          "ec_ops_per_s_cold": ec_ops / prove_s,
          "verified": True, "public_values": er["public_values"][:24],
          "proof_bytes": len(er["blob"]), "proof_sha256": er["sha"],
          "peak_gb": er["peak_gb"], "peak_above_start_gb": er["peak_gb"] - er["start_gb"],
          "launches": er["launches"], "quotient": er["quotient"],
          "plain_checks": er["plain_checks"], "phase_s": time.perf_counter() - t0})
    return er["launches"]


def run_pairing(dev, cfg: StarkConfig) -> dict:
    """Path 9: the pairing guest's volatile VM proof (run_vm with the
    default executors, BN254's modular and Fp2 chips), held to its counts,
    its heights, its public values and its pinned proof; the host seconds
    of the HintFinalExp phantoms (``PreflightResult.hint_s``); K7's two
    launches (the extension programs streamed), the streamed launch alone
    with its jobs and the shared one without it beside their bounds, and
    every kernel against plain on the prove's own inputs."""
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    r = run_vm(dev, Rv32Config(stark=cfg, **PAIRING_CONFIG),
               build_pairing_program(PAIRING_N, PAIRING_PAIRS), warm=False,
               inputs=pairing_stream(PAIRING_N, PAIRING_PAIRS, PAIRING_SEED))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, vm, pre = r["launches"], r["vm"], r["pre"]
    hint_s = pre.hint_s
    require_one_prove(launches, "path 9")
    counts = pairing_counts(PAIRING_N, PAIRING_PAIRS)
    rows = {k: len(next(iter(v.values()))) for k, v in pre.records.items()}
    got = {"insns": pre.instret, **{k: rows.get(k, 0) for k in counts if k != "insns"}}
    require(pre.exit_code == 0 and got == counts and len(hint_s) == PAIRING_N,
            f"path 9's guest: exit {pre.exit_code}, {got} against {counts}, "
            f"{len(hint_s)} hints")
    heights = {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in r["proof"].per_air}
    require(all(heights[name] == 1 << lh for name, lh in PAIRING_LOG_HEIGHTS.items()),
            f"path 9's heights: {heights}")
    pvs = list(r["result"]["public_values"])
    require(pvs == pairing_reference(PAIRING_N, PAIRING_PAIRS, PAIRING_SEED)
            and pvs[:4] == list(PAIRING_N.to_bytes(4, "little")),
            f"path 9's public values {pvs}")
    blob = codec.encode_proof(r["proof"])
    sha = hashlib.sha256(blob).hexdigest()
    require(sha == PAIRING_PROOF_SHA256, f"path 9's proof sha {sha}")
    qrec = r["record"]["quotient"]
    both, alone, rest = quotient_split(vm, qrec, PAIRING_STREAMED, "path 9")
    alone["jobs"] = {a.name: {"log_rows": q[2] + q[3], "instructions": int(q[0].code.shape[0])}
                     for a, q in zip(vm.airs, qrec) if a.name in PAIRING_STREAMED}
    alone["instruction_rows"] = sum(int(q[0].code.shape[0]) << (q[2] + q[3])
                                    for a, q in zip(vm.airs, qrec)
                                    if a.name in PAIRING_STREAMED)
    quotient = {**both, "streamed_alone": alone, "without_streamed": rest}
    tracegen_s = r["record"]["tracegen_s"]
    r.update(launches=launches, heights=heights, public_values=pvs, blob=blob, sha=sha,
             peak_gb=peak_gb, start_gb=start_gb, quotient=quotient, rows=rows, counts=counts,
             hint_s=hint_s,
             tracegen_s={k: tracegen_s[k] for k in ("fp2_muldiv_0", "fp2_addsub_0")},
             plain_checks=check_vm_kernels(vm, r.pop("record")))
    return r


def phase_pairing(dev, cfg: StarkConfig, err: dict) -> dict:
    """Path 9 (``run_pairing``) and its line; folds its plain checks into
    ``err``.  Returns its launches."""
    t0 = time.perf_counter()
    pr = run_pairing(dev, cfg)
    err.update({k: max(v, err.get(k, 0)) for k, v in pr["plain_checks"]["max"].items()})
    insns, prove_s, c = pr["pre"].instret, pr["s"]["prove"], pr["counts"]
    fp2_ops = c["fp2_addsub_0"] + c["fp2_muldiv_0"]
    emit({"phase": "pairing", "guest": f"build_pairing_program({PAIRING_N}, {PAIRING_PAIRS})",
          "seed": PAIRING_SEED, "executors": list(FULL_EXECUTORS),
          "moduli": [hex(BN254_P)], "fp2": [hex(BN254_P)], "checks": PAIRING_N,
          "pairs": PAIRING_PAIRS, "insns": insns, "counts": c, "rows": pr["rows"],
          "heights": pr["heights"], "queries": cfg.fri.num_queries,
          "pow_bits": cfg.fri.proof_of_work_bits, "s": pr["s"], "stage_s": pr["stages_s"],
          "tracegen_s": pr["tracegen_s"], "hint_s": pr["hint_s"],
          "insn_per_s_cold": insns / prove_s, "checks_per_s_cold": PAIRING_N / prove_s,
          "fp2_ops_per_s_cold": fp2_ops / prove_s,
          "verified": True, "public_values": pr["public_values"],
          "proof_bytes": len(pr["blob"]), "proof_sha256": pr["sha"],
          "peak_gb": pr["peak_gb"], "peak_above_start_gb": pr["peak_gb"] - pr["start_gb"],
          "launches": pr["launches"], "quotient": pr["quotient"],
          "plain_checks": pr["plain_checks"], "phase_s": time.perf_counter() - t0})
    return pr["launches"]


def run_native(dev, cfg: StarkConfig) -> dict:
    """Path 10: the FRI query phase of a leaf verifier as a native program
    (run_vm with ``NativeConfig``'s chips), held to its counts, its heights,
    its public values and its pinned proof; every native executor chip
    with real rows; K7's two launches (the large programs streamed), the
    streamed launch alone with its jobs and the shared one without it
    beside their bounds, and every kernel against plain on the prove's own
    inputs."""
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    exe = build_native_query_program(*NATIVE_ARGS)
    stream = native_query_stream(*NATIVE_ARGS)
    inputs_s = time.perf_counter() - t0
    _build.reset_launches()
    r = run_vm(dev, NativeConfig(stark=cfg), exe, warm=False, inputs=stream)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, vm, pre = r["launches"], r["vm"], r["pre"]
    require_one_prove(launches, "path 10")
    t0 = time.perf_counter()
    counts = native_query_counts(*NATIVE_ARGS)
    reference = native_query_reference(*NATIVE_ARGS)
    reference_s = time.perf_counter() - t0
    rows = {k: len(next(iter(v.values()))) for k, v in pre.records.items()}
    heights = {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in r["proof"].per_air}
    got = {"insns": pre.instret, "poseidon2": int(r["record"]["ctxs"][
        vm.air_index["poseidon2"]].common_main.shape[0]),
        **{k: rows.get(k, 0) for k in counts if k not in ("insns", "poseidon2")}}
    want = {**counts, "poseidon2": 1 << max(counts["poseidon2"] - 1, 0).bit_length()}
    require(pre.exit_code == 0 and got == want, f"path 10's guest: exit {pre.exit_code}, "
            f"{got} against {want}")
    idle = [name for name in NATIVE_EXECUTORS if not rows.get(name)]
    require(not idle, f"native chips without a real row on path 10: {idle}")
    require(all(heights[name] == 1 << lh for name, lh in NATIVE_LOG_HEIGHTS.items()),
            f"path 10's heights: {heights}")
    pvs = list(r["result"]["public_values"])
    require(pvs == reference + [0] * (len(pvs) - len(reference)),
            f"path 10's public values {pvs} against {reference}")
    blob = codec.encode_proof(r["proof"])
    sha = hashlib.sha256(blob).hexdigest()
    require(sha == NATIVE_PROOF_SHA256, f"path 10's proof sha {sha}")
    qrec = r["record"]["quotient"]
    both, alone, rest = quotient_split(vm, qrec, NATIVE_STREAMED, "path 10")
    alone["jobs"] = {a.name: {"log_rows": q[2] + q[3], "instructions": int(q[0].code.shape[0])}
                     for a, q in zip(vm.airs, qrec) if a.name in NATIVE_STREAMED}
    alone["instruction_rows"] = sum(int(q[0].code.shape[0]) << (q[2] + q[3])
                                    for a, q in zip(vm.airs, qrec)
                                    if a.name in NATIVE_STREAMED)
    quotient = {**both, "streamed_alone": alone, "without_streamed": rest}
    tracegen_s = r["record"]["tracegen_s"]
    r.update(launches=launches, heights=heights, public_values=pvs, blob=blob, sha=sha,
             peak_gb=peak_gb, start_gb=start_gb, quotient=quotient, rows=rows, counts=counts,
             inputs_s=inputs_s, reference_s=reference_s,
             tracegen_s={k: tracegen_s[k] for k in (*NATIVE_EXECUTORS, "poseidon2")},
             plain_checks=check_vm_kernels(vm, r.pop("record")))
    return r


def phase_native(dev, cfg: StarkConfig, err: dict) -> dict:
    """Path 10 (``run_native``) and its line; folds its plain checks into
    ``err``.  Returns its launches."""
    t0 = time.perf_counter()
    nr = run_native(dev, cfg)
    err.update({k: max(v, err.get(k, 0)) for k, v in nr["plain_checks"]["max"].items()})
    insns, prove_s, c = nr["pre"].instret, nr["s"]["prove"], nr["counts"]
    n_queries, depth, n_layers, seed = NATIVE_ARGS
    emit({"phase": "native", "guest": "build_native_query_program(%d, %d, %d, seed=%d)"
          % NATIVE_ARGS, "config": "NativeConfig", "executors": list(NATIVE_EXECUTORS),
          "queries": n_queries, "depth": depth, "fri_layers": n_layers, "seed": seed,
          "insns": insns, "counts": c, "rows": nr["rows"], "heights": nr["heights"],
          "fri_queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "s": nr["s"], "inputs_s": nr["inputs_s"], "reference_s": nr["reference_s"],
          "stage_s": nr["stages_s"], "tracegen_s": nr["tracegen_s"],
          "insn_per_s_cold": insns / prove_s, "queries_per_s_cold": n_queries / prove_s,
          "poseidon2_rows_per_s_cold": c["poseidon2"] / prove_s,
          "verified": True, "public_values": nr["public_values"],
          "proof_bytes": len(nr["blob"]), "proof_sha256": nr["sha"],
          "peak_gb": nr["peak_gb"], "peak_above_start_gb": nr["peak_gb"] - nr["start_gb"],
          "launches": nr["launches"], "quotient": nr["quotient"],
          "plain_checks": nr["plain_checks"], "phase_s": time.perf_counter() - t0})
    return nr["launches"]


def leaf_public_values(app: dict) -> list:
    """The leaf program's 44 public values in the reference's layout, read
    from the app segment's own proof: its program commitment (cached main
    commit 0), the connector's and the memory-merkle AIR's public values,
    and 16 zeros."""
    proof, idx = app["proof"], app["air_index"]
    by_air = {pa.air_id: pa for pa in proof.per_air}
    return ([int(v) for v in np.asarray(proof.commitments.main_trace[0]).reshape(-1)]
            + [int(v) for v in by_air[idx["connector"]].public_values]
            + [int(v) for v in by_air[idx["memory_merkle"]].public_values]
            + [0] * (LEAF_PVS - 28))


def leaf_rejects(exe, app: dict) -> dict:
    """The leaf program's preflight of the app proof with one felt of its
    quotient commitment changed: a non-zero exit or an ExecutionError."""
    bad = copy.deepcopy(app["proof"])
    q = [int(v) for v in np.asarray(bad.commitments.quotient).reshape(-1)]
    q[0] = (q[0] + 1) % P
    bad.commitments.quotient = np.asarray(q, dtype=np.uint64)
    t0 = time.perf_counter()
    try:
        pre = PreflightInterpreter(exe, LEAF_PVS).execute(
            inputs=serialize_proof_felts(app["vk"], bad))
        out = {"exit_code": pre.exit_code, "insns": pre.instret}
    except ExecutionError as e:
        out = {"execution_error": str(e)[:200]}
    out["s"] = time.perf_counter() - t0
    require(out.get("exit_code") != 0, f"path 11 accepted a tampered app proof: {out}")
    return out


def run_leaf(dev, cfg: StarkConfig, app: dict) -> dict:
    """Path 11: the leaf verifier program over path 4's first segment proof
    (``app``: its VM's verifying key, the proof and the AIRs' indices),
    proved on the native VM (run_vm with ``NativeConfig``'s chips and 44
    public values); its public values against the segment's own, its
    pinned proof, a tampered app proof refused by the preflight, K7's two
    launches beside their bounds, and every kernel against plain on the
    prove's own inputs."""
    torch.cuda.synchronize()
    start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    vk, proof = app["vk"], app["proof"]
    require([pa.air_id for pa in proof.per_air] == list(range(len(vk.per_air)))
            and app["air_index"]["connector"] == 1 and app["air_index"]["memory_merkle"] == 3,
            "path 11 reads the connector at air 1 and the memory tree at air 3")
    log_degrees = [pa.log_degree for pa in proof.per_air]
    t0 = time.perf_counter()
    exe, meta = build_leaf_program(vk, log_degrees, expose_memory_pvs=True)
    t1 = time.perf_counter()
    hints = serialize_proof_felts(vk, proof)
    t2 = time.perf_counter()
    profile = static_height_profile(exe)
    rejected = leaf_rejects(exe, app)
    _build.reset_launches()
    r = run_vm(dev, NativeConfig(stark=cfg, num_native_pvs=LEAF_PVS), exe, warm=False,
               inputs=hints)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    launches, vm, pre = r["launches"], r["vm"], r["pre"]
    require_one_prove(launches, "path 11")
    require(pre.exit_code == 0 and pre.instret > 0, f"path 11's leaf program exited "
            f"{pre.exit_code} after {pre.instret} instructions")
    pvs = [int(v) for v in r["result"]["public_values"]]
    want = leaf_public_values(app)
    require(pvs == want, f"path 11's public values {pvs} against {want}")
    rows = {k: len(next(iter(v.values()))) for k, v in pre.records.items()}
    heights = {vm.airs[pa.air_id].name: 1 << pa.log_degree for pa in r["proof"].per_air}
    require(all(heights.get(k, 1) <= h for k, h in profile.items()),
            f"path 11's heights {heights} past the static profile {profile}")
    blob = codec.encode_proof(r["proof"])
    sha = hashlib.sha256(blob).hexdigest()
    require(sha == LEAF_PROOF_SHA256, f"path 11's proof sha {sha}")
    qrec = r["record"]["quotient"]
    both, alone, rest = quotient_split(vm, qrec, LEAF_STREAMED, "path 11")
    alone["jobs"] = {a.name: {"log_rows": q[2] + q[3], "instructions": int(q[0].code.shape[0])}
                     for a, q in zip(vm.airs, qrec) if a.name in LEAF_STREAMED}
    quotient = {**both, "streamed_alone": alone, "without_streamed": rest}
    tracegen_s = r["record"]["tracegen_s"]
    r.update(launches=launches, heights=heights, public_values=pvs, blob=blob, sha=sha,
             peak_gb=peak_gb, start_gb=start_gb, quotient=quotient, rows=rows,
             profile=profile, insns_static=meta["num_insns"], rejected=rejected,
             build_s=t1 - t0, serialize_s=t2 - t1, hint_vectors=len(hints),
             hint_felts=sum(len(h) for h in hints),
             host_permutations={"n": r["pre"].host_perms, "s": r["pre"].host_perm_s},
             tracegen_s={k: tracegen_s[k] for k in (*NATIVE_EXECUTORS, "poseidon2")},
             plain_checks=check_vm_kernels(vm, r.pop("record")))
    return r


def phase_leaf(dev, cfg: StarkConfig, app: dict, err: dict) -> dict:
    """Path 11 (``run_leaf``) and its line; folds its plain checks into
    ``err``.  Returns its launches."""
    t0 = time.perf_counter()
    lr = run_leaf(dev, cfg, app)
    err.update({k: max(v, err.get(k, 0)) for k, v in lr["plain_checks"]["max"].items()})
    insns, prove_s, s = lr["pre"].instret, lr["s"]["prove"], lr["s"]
    stages = lr["stages_s"]
    emit({"phase": "leaf", "program": "build_leaf_program(path 4's segment 0, "
          "expose_memory_pvs=True)", "config": f"NativeConfig(num_native_pvs={LEAF_PVS})",
          "app_log_degrees": [pa.log_degree for pa in app["proof"].per_air],
          "insns": insns, "insns_static": lr["insns_static"],
          "static_profile": lr["profile"], "rows": lr["rows"], "heights": lr["heights"],
          "hint_vectors": lr["hint_vectors"], "hint_felts": lr["hint_felts"],
          "fri_queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "stage_s": {"build": lr["build_s"], "serialize": lr["serialize_s"],
                      "preflight": stages["preflight"],
                      "host_permutations": lr["host_permutations"]["s"],
                      "tracegen": stages["tracegen"], "prove": prove_s,
                      "keygen_and_commit_exe": s["keygen_and_commit_exe"],
                      "verify": s["verify"], "plain_checks": lr["plain_checks"]["s"],
                      "tamper_preflight": lr["rejected"]["s"]},
          "prove_stage_s": stages, "tracegen_s": lr["tracegen_s"],
          "host_permutations": lr["host_permutations"],
          "insn_per_s_cold": insns / prove_s, "app_proofs_per_s_cold": 1 / prove_s,
          "verified": True, "public_values": lr["public_values"],
          "tampered_app_proof": lr["rejected"],
          "proof_bytes": len(lr["blob"]), "proof_sha256": lr["sha"],
          "peak_gb": lr["peak_gb"], "peak_above_start_gb": lr["peak_gb"] - lr["start_gb"],
          "launches": lr["launches"], "quotient": lr["quotient"],
          "plain_checks": lr["plain_checks"], "phase_s": time.perf_counter() - t0})
    return lr["launches"]


def tamper_poseidon2(vm, ctxs: list, device) -> list:
    """``ctxs`` with one Poseidon2Air cell (DEBUG_TAMPER) changed, every
    matrix on ``device``."""
    out = []
    for ctx in ctxs:
        common = ctx.common_main.to(device)
        if vm.airs[ctx.air_id].name == "poseidon2":
            m = bb.canonical_np(common)
            row, col = DEBUG_TAMPER
            m[row, col] = (m[row, col] + 1) % P
            common = bb.monty(m, device=device)
        out.append(stark.AirProvingContext(
            air_id=ctx.air_id, common_main=common,
            cached_mains=[m.to(device) for m in ctx.cached_mains],
            public_values=list(ctx.public_values)))
    return out


def run_debug_check(dev, vm) -> dict:
    """stark.debug.check_constraints over one segment of a short run: on the
    card (K7's columns mode with selectors) the good contexts pass; with one
    Poseidon2Air cell changed they fail, with the failures the plain version
    reports on the CPU (a CPU proving key of the same VM)."""
    exe = build_fib_program(DEBUG_FIB_N)
    t0 = time.perf_counter()
    segments, _ = vm.segment_contexts(exe, segment_limits=DEBUG_LIMITS)
    t1 = time.perf_counter()
    ctxs = segments[1]
    before = _build.LAUNCHES["quotient_columns"]
    good = check_constraints(vm.pk, ctxs, raise_on_error=False)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check_launches = _build.LAUNCHES["quotient_columns"] - before
    bad = check_constraints(vm.pk, tamper_poseidon2(vm, ctxs, dev), raise_on_error=False)
    cpu_vm = VirtualMachine(Rv32Config(stark=vm.config.stark, executors=FIB_EXECUTORS,
                                       persistent=True), device="cpu")
    t3 = time.perf_counter()
    cpu_vm.keygen()
    cpu_bad = check_constraints(cpu_vm.pk, tamper_poseidon2(vm, ctxs, torch.device("cpu")),
                                raise_on_error=False)
    t4 = time.perf_counter()
    require(good == [], f"check_constraints failed on a good segment: {good[:3]}")
    require(check_launches == len(ctxs), f"the checker made {check_launches} columns "
            f"launches for {len(ctxs)} AIRs")
    require(bad and bad == cpu_bad,
            f"the tampered segment: card {bad[:3]}, CPU plain {cpu_bad[:3]}")
    return {"guest": f"build_fib_program({DEBUG_FIB_N})", "limits": DEBUG_LIMITS,
            "segments": len(segments), "checked_segment": 1,
            "heights": {vm.airs[c.air_id].name: int(c.common_main.shape[0]) for c in ctxs},
            "columns_launches": check_launches, "good_failures": 0,
            "tampered": list(DEBUG_TAMPER), "tampered_failures": len(bad),
            "first_failure": bad[0], "cpu_first_failure": cpu_bad[0],
            "s": {"segment_contexts": t1 - t0, "check_card": t2 - t1,
                  "check_card_tampered": t3 - t2, "cpu_keygen_and_check": t4 - t3}}


def kernel_names() -> list:
    """The __global__ functions of openvm_tpu_torch/csrc."""
    names = []
    for f in sorted(_build.CSRC.glob("*.cu")):
        names += re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(",
                            f.read_text())
    return names


# Each kernel's __global__ functions (csrc/), by its _build.LAUNCHES name.
GLOBALS = {"bb_elementwise": ("bb_elementwise_kernel",), "ntt": ("ntt_pass_kernel",),
           "poseidon2_hash_rows": ("poseidon2_hash_rows_kernel",),
           "poseidon2_compress_layer": ("poseidon2_compress_layer_kernel",),
           "poseidon2_compress_tail": ("poseidon2_compress_tail_kernel",),
           "ext_elementwise": ("ext_elementwise_kernel",),
           "ext_powers": ("ext_powers_kernel",), "gather": ("gather_kernel",),
           "quotient": ("quotient_kernel", "quotient_stream_kernel"),
           "open_dot": ("open_partial_kernel", "open_reduce_kernel"),
           "fri_reduced_open": ("reduced_open_kernel",), "fri_fold": ("fri_fold_kernel",),
           "quotient_columns": ("columns_kernel", "columns_stream_kernel"),
           "quotient_transpose": ("transpose_kernel",),
           "perm_cols": ("perm_cols_kernel",), "perm_scan": ("perm_scan_kernel",),
           "lookup_hist": ("lookup_hist_kernel",)}


def profile_prove(vm, exe) -> dict:
    """One more warm VirtualMachine.prove under torch.profiler (CPU and CUDA
    activities): each kernel's summed device ms and launches by its
    __global__ name (and by wrapper, GLOBALS), the other device work, and
    the device's busy and idle share of the prove's wall time (the union of
    device intervals over the host clock around the prove, profiler on).
    Each launch's bound at its own shape is summed per kernel as well
    (``path3_bounds``, from the launches' arguments and the prove's
    record).  If the profiler sees no device time, CUDA events around
    every _build.launch instead."""
    from torch.profiler import ProfilerActivity, profile
    names = kernel_names()
    calls, launch = [], _build.launch

    def captured(kernel, fn_name, device, *args):
        launch(kernel, fn_name, device, *args)
        calls.append((kernel, fn_name, args))

    record: dict = {}
    torch.cuda.synchronize()
    _build.launch = captured
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vm.prove(exe, record=record)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        _build.launch = launch
    bounds = path3_bounds(calls, record)
    per: dict = {}
    other = {"ms": 0.0, "calls": 0}
    spans = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        hit = max((n for n in names if n in e.name), key=len, default=None)
        slot = per.setdefault(hit, {"ms": 0.0, "calls": 0}) if hit else other
        slot["ms"] += (end - start) / 1e3
        slot["calls"] += 1
    if sum(v["ms"] for v in per.values()) > 0:
        busy_us, last = 0.0, float("-inf")
        for start, end in sorted(spans):
            busy_us += max(0.0, end - max(start, last))
            last = max(last, end)
        by_kernel = {k: sum(per.get(g, {"ms": 0.0})["ms"] for g in gs)
                     for k, gs in GLOBALS.items()}
        return {"method": "torch.profiler", "wall_s": wall,
                "device_busy_share": busy_us / 1e6 / wall,
                "device_idle_share": 1 - busy_us / 1e6 / wall,
                "kernels": per, "ms_by_kernel": by_kernel, "other_device": other,
                "bounds": bounds}
    # CUDA events around each launch: kernels only, no copies
    recs = []

    def timed(kernel, fn_name, device, *args):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        launch(kernel, fn_name, device, *args)
        b.record()
        recs.append((kernel, a, b))

    _build.launch = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vm.prove(exe)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        _build.launch = launch
    per = {}
    for kernel, a, b in recs:
        slot = per.setdefault(kernel, {"ms": 0.0, "calls": 0})
        slot["ms"] += a.elapsed_time(b)
        slot["calls"] += 1
    busy = sum(v["ms"] for v in per.values()) / 1e3
    return {"method": "cuda events around _build.launch (the profiler showed "
            "no device time)", "wall_s": wall, "kernel_busy_share": busy / wall,
            "kernel_idle_share": 1 - busy / wall, "kernels": per,
            "ms_by_kernel": {k: v["ms"] for k, v in per.items()}, "bounds": bounds}


def path3_bounds(calls: list, record: dict) -> dict:
    """Per kernel, the sum over one prove's launches of each launch's bound
    at its own shape (the larger of its bytes and its operations, as
    ``bound``), from the launches' arguments (``calls``: (kernel, C entry,
    args) in launch order) and, for the table-driven kernels, the prove's
    ``record``: K7 from its programs, K7 columns and K9 from the AIRs'
    columns programs and layouts, K8 from its sends, K12 and K13 from their
    jobs, K6 from its plan."""
    out = {k: {"bound_ms": 0.0, "launches": 0, "bytes": 0, "ops": 0} for k in GLOBALS}

    def add(kernel, nbytes, ops):
        row = out[kernel]
        row["bound_ms"] += bound(nbytes, ops)[0]
        row["bytes"] += nbytes
        row["ops"] += ops

    for kernel, fn, a in calls:
        out[kernel]["launches"] += 1
        if fn == "ovt_bb_elementwise":  # op, a, b, out, n
            code, n = a[0], a[4]
            reads = 1 if code in (0, 1) else 2
            add(kernel, n * 4 * (reads + 1),
                n * (MUL_OPS if code in (0, 2) else RED_OPS if code == 1 else ADD_OPS))
        elif fn == "ovt_ext_powers":  # u0, u1, u2, u3, out, n
            add(kernel, a[5] * 16, a[5] * EXT_MUL_D)
        elif fn == "ovt_ext_elementwise":  # op, a, b, out, n, bcast
            code, b, n, bcast = a[0], a[2], a[4], a[5]
            b_words = 0 if b is None or bcast else (1 if code == 3 else 4)
            add(kernel, n * 4 * (8 + b_words),
                n * (EXT_MUL, EXT_ADD, EXT_ADD, EXT_SCALE, EXT_BATCH_INV)[code])
        elif fn == "ovt_ntt_pass":  # src, dst, tw, in, out, log_n, w, s0, k, n_in, rev
            log_n, w, k, n_in = a[5], a[6], a[8], a[9]
            n = 1 << log_n
            add(kernel, (n_in + n) * w * 4,
                k * (n // 2) * w * (MUL_OPS + 2 * ADD_OPS)
                + (n_in * w * MUL_OPS if a[3] is not None else 0)
                + (n * w * MUL_OPS if a[4] is not None else 0))
        elif fn == "ovt_poseidon2_hash_rows":  # in, out, n, w
            n, w = a[2], a[3]
            add(kernel, n * (w * 4 + 32), n * -(-w // 8) * PERM_OPS)
        elif fn == "ovt_poseidon2_compress_layer":  # prev, inj, out, h
            h, inj = a[3], a[1] is not None
            add(kernel, h * 32 * (3 + inj), h * (1 + inj) * PERM_OPS)
        elif fn == "ovt_poseidon2_compress_tail":  # prev, injs, outs, n, h0
            injs, n_layers, h0 = a[1], a[3], a[4]
            perms = sum((h0 >> t) * (1 + (injs[t] is not None)) for t in range(n_layers))
            add(kernel, 2 * h0 * 32 + perms * 32, perms * PERM_OPS)
        elif fn == "ovt_fri_fold":  # evals, beta, roots, ro, half, log_h, out
            add(kernel, *fold_cost(a[4], a[3] is not None))
        elif fn == "ovt_perm_scan":  # buf, n, m, status, cumsum
            add(kernel, *perm_scan_cost(a[1], a[2]))
    # table-driven kernels, from the record
    for prog, _, log_n, lqd in record["quotient"]:
        add("quotient", *quotient_cost([(prog, None, log_n, lqd)]))
    lk = record["lookup"]
    columns = [(prog, src, log_n) for _, prog, src, log_n, _ in lk["airs"]]
    columns += [e["columns"] for e in record["logup"]]
    for prog, _, log_n in columns:
        loads, ops = columns_cost(prog)
        add("quotient_columns", (1 << log_n) * (loads + prog.n_roots) * 4, (1 << log_n) * ops)
    for e in record["logup"]:
        cols, layout = e["perm_cols"][:2]
        n = int(cols.shape[1])
        add("perm_cols", n * (len(layout.roots) + 4 * layout.m) * 4, n * perm_cols_ops(layout))
    scatter = [lookup_scatter(qmod.evaluate_columns(prog, src, log_n), layout, lk["sizes"])
               for _, prog, src, log_n, layout in lk["airs"]]
    add("lookup_hist", *hist_cost(scatter, lk["tables"]))
    add("open_dot", *open_cost(*record["openings"]))
    add("fri_reduced_open", *reduced_open_cost(record["reduced_openings"][0]))
    add("gather", *gather_cost(*record["gather"]))
    return out


def sass_permutation() -> dict:
    """SASS instructions of one Poseidon2 permutation in K4's kernel, from
    cuobjdump -sass of the built library: the rounds are loops (unroll 1),
    so the three largest innermost loops are the beginning full rounds, the
    partial rounds and the ending full rounds; one permutation issues 4, 13
    and 4 of their bodies (the initial external layer outside them is not
    counted, so the count is a lower bound)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    txt = subprocess.run([tool, "-sass", str(_build.build())], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    body = next(p for p in re.split(r"\n\s*Function : ", txt)
                if "poseidon2_hash_rows" in p.splitlines()[0])
    ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []
    for a, t in ins:
        m = re.search(r"BRA\s+(?:`\()?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= a:
            start = int(m.group(1), 16)
            loops.append((start, a, sum(1 for b, u in ins if start <= b <= a
                                        and not u.strip().startswith("NOP"))))
    inner = [lp for lp in loops
             if not any(o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    begin, partial, end = sorted(sorted(inner, key=lambda lp: -lp[2])[:3])
    per_perm = 4 * begin[2] + 13 * partial[2] + 4 * end[2]
    return {"full_round_begin": begin[2], "partial_round": partial[2],
            "full_round_end": end[2], "per_permutation": per_perm,
            "kernel_instructions": len(ins)}


def max_sm_clock_hz(dev) -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.split()
    return float(out[dev.index or 0]) * 1e6


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
    qprogs = phase_variants(dev, rng)

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
             "poseidon2_compress_layer", "poseidon2_compress_tail", "gather")
    require(all(launches[k] for k in path1), f"a path-1 kernel never ran: {launches}")
    require(launches["gather"] == 1 and not any(launches[k] for k in OFF_PATH),
            f"path 1 takes one K6 launch and no elementwise K2: {launches}")
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
    n_single = len(merkle.commit_plan(tree.max_height(), merkle.TAIL_MAX)[0])
    err["poseidon2_compress_layer"] = max(
        (max_abs_err(a, b) for a, b in zip(tree.digest_layers[1:1 + n_single],
                                           p_layers[1:1 + n_single])), default=0)
    err["poseidon2_compress_tail"] = max(
        max_abs_err(a, b) for a, b in zip(tree.digest_layers[1 + n_single:],
                                          p_layers[1 + n_single:]))
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
    ntt._PREFIX_TABLES.clear()
    proved = run_prove(dev, cfg, airs, ctxs)
    p_launches = dict(_build.LAUNCHES)
    # the host tables the prove built, before any plain version runs: K13
    # and K14 make their points on the card, so no fold table and no LDE
    # points past the tallest quotient domain (K7's)
    p_tables = {name: int(t.shape[0]) for (name, _), t in ntt._PREFIX_TABLES.items()}
    log_q = max(r[2] + r[3] for r in proved["record"]["quotient"])
    require(not {"fold_y", "fold_inv_neg2y"} & set(p_tables)
            and p_tables.get("lde_points", 0) <= 1 << log_q,
            f"path 2 built host tables of K13 or K14: {p_tables}")
    require(p_launches["fri_reduced_open"] == 1 and p_launches["ext_powers"] == 1
            and p_launches["gather"] == 1 and not any(p_launches[k] for k in OFF_PATH),
            f"path 2 takes one K13, one K2 power series and one K6 launch a prove "
            f"and no elementwise K2: {p_launches}")
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
    prove_sha = hashlib.sha256(blob).hexdigest()
    require(prove_sha == PROVE_PROOF_SHA256, f"full-size prove proof sha {prove_sha}")
    fri_proof = proved["proof"].opening.proof
    require(len(fri_proof.query_proofs) == cfg.fri.num_queries
            and len(fri_proof.commit_phase_commits)
            == max(lh for _, lh in PROVE_AIRS), "FRI proof shape")
    emit({"phase": "prove", "airs": PROVE_AIRS,
          "rows": sum(1 << lh for _, lh in PROVE_AIRS),
          "queries": cfg.fri.num_queries, "pow_bits": cfg.fri.proof_of_work_bits,
          "verified": True, "s": proved["s"], "stage_s": proved["stages_s"],
          "proof_bytes": len(blob), "proof_sha256": prove_sha,
          "peak_gb": p_peak_gb, "launches": p_launches, "host_tables": p_tables,
          "plain_max_abs_err": {"quotient": q_err, "gather": p_err["gather"],
                                "gather_jobs": len(plan.jobs)}})
    err = {**err, **{k: max(v, err.get(k, 0)) for k, v in p_err.items()}}

    # ---- path 3: the RV32IM VM proof of the fibonacci guest -----------------
    torch.cuda.synchronize()
    v_start_gb = torch.cuda.memory_allocated(dev) / 1e9
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    vmr = run_vm(dev, Rv32Config(stark=cfg, executors=FIB_EXECUTORS))
    v_launches = vmr["launches"]
    v_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    require(all(v for k, v in v_launches.items() if k not in OFF_PATH + STREAMED_ONLY)
            and not any(v_launches[k] for k in STREAMED_ONLY),
            f"a kernel of path 3 never ran, or the streamed launch ran: {v_launches}")
    require(v_launches["lookup_hist"] == 1 and v_launches["perm_cols"] == 1
            and v_launches["fri_reduced_open"] == 1 and v_launches["ext_powers"] == 1
            and v_launches["gather"] == 1 and not any(v_launches[k] for k in OFF_PATH),
            f"path 3 takes one lookup_hist, perm_cols, fri_reduced_open, "
            f"ext_powers and gather launch a prove and no elementwise K2: {v_launches}")
    vm, vproof, pre = vmr["vm"], vmr["proof"], vmr["pre"]
    require(pre.exit_code == 0 and vmr["result"]["public_values"][:4]
            == list(fib_u32(VM_FIB_N + 1).to_bytes(4, "little")), "fib guest result")
    vblob = codec.encode_proof(vproof)
    require(codec.encode_proof(codec.decode_proof(vblob)) == vblob, "VM codec round trip")
    vm_sha = hashlib.sha256(vblob).hexdigest()
    require(vm_sha == VM_PROOF_SHA256, f"full-size VM proof sha {vm_sha}")
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
          "proof_sha256": vm_sha, "peak_gb": v_peak_gb,
          "peak_above_start_gb": v_peak_gb - v_start_gb, "launches": v_launches,
          "plain_checks": v_checks})
    profile = profile_prove(vm, vmr["exe"])
    emit({"phase": "vm_profile", **profile})

    # ---- path 4: the persistent VM's continuations of the fibonacci guest ---
    cont = run_continuations(dev, cfg)
    c_launches, cvm = cont["launches"], cont["vm"]
    n_seg = len(cont["proofs"])
    require(all(v for k, v in c_launches.items() if k not in OFF_PATH),
            f"a kernel of path 4 never ran: {c_launches}")
    require(c_launches["quotient"] == 2 * n_seg
            and all(c_launches[k] == n_seg for k in ("lookup_hist", "perm_cols",
                                                      "fri_reduced_open", "ext_powers", "gather"))
            and not any(c_launches[k] for k in OFF_PATH),
            f"path 4 takes two quotient launches (shared and Poseidon2Air's streamed) and "
            f"one lookup_hist, perm_cols, fri_reduced_open, ext_powers and gather launch "
            f"a segment and no elementwise K2: {c_launches}")
    instret = cont["metered"]["instret"]
    require(instret == fib_insns(CONT_FIB_N) and cont["metered"]["exit_code"] == 0,
            f"path 4's guest ran {instret} instructions")
    seg_heights = [{cvm.airs[pa.air_id].name: 1 << pa.log_degree for pa in proof.per_air}
                   for proof in cont["proofs"]]
    require(n_seg == CONT_SEGMENTS and cont["result"]["num_segments"] == n_seg,
            f"path 4 made {n_seg} segments")
    require(all(h <= 1 << 20 for hs in seg_heights for name, h in hs.items()
                if name.startswith("rv32_")), f"an executor trace above 2^20: {seg_heights}")
    require(all(hs["rv32_base_alu"] == 1 << 20 and hs["rv32_branch_eq"] == 1 << 18
                for hs in seg_heights[:-1]), f"path 4's full segments: {seg_heights}")
    pv = pv_proof(cont["tree"])
    final_pv = int.from_bytes(bytes(pv["public_values"][:4]), "little")
    require(verify_pv_proof(pv) and pv["root"].tolist() == list(cont["result"]["final_root"]),
            "the public-values proof does not open the final root")
    require(final_pv == fib_u32(CONT_FIB_N + 1), f"path 4's public value {final_pv}")
    c_shas = tuple(hashlib.sha256(b).hexdigest() for b in cont["blobs"])
    require(c_shas == CONTINUATION_PROOF_SHA256, f"path 4's segment proofs sha {c_shas}")
    # every kernel of path 4 against its plain version on segment 0's own
    # inputs (the warm run's record): K7 over the 16 AIRs with Poseidon2Air,
    # K8 with the boundary's range sends, K9/K10 with the Merkle and
    # Poseidon2 buses, K12/K13 over Poseidon2Air's columns, K6
    c_checks = check_vm_kernels(cvm, cont.pop("record"))
    err = {**err, **{k: max(v, err.get(k, 0)) for k, v in c_checks["max"].items()}}
    c_peak_above = cont["peak_gb"] - cont["start_gb"]
    require(c_peak_above <= 1.2 * (v_peak_gb - v_start_gb),
            f"path 4's peak {c_peak_above} GB above its start, path 3's "
            f"{v_peak_gb - v_start_gb} GB")
    cs = cont["s"]
    emit({"phase": "continuations", "guest": f"build_fib_program({CONT_FIB_N})",
          "executors": list(FIB_EXECUTORS), "persistent": True, "limits": CONT_LIMITS,
          "insns": instret, "segments": n_seg, "metered": cont["metered"],
          "heights": seg_heights, "queries": cfg.fri.num_queries,
          "pow_bits": cfg.fri.proof_of_work_bits, "log_blowup": cfg.fri.log_blowup,
          "s": cs, "stage_s": summed_stages(cont["stages"]),
          "warm_stage_s": summed_stages(cont["warm_stages"]),
          "segment_stage_s": cont["stages"], "segment_warm_stage_s": cont["warm_stages"],
          "insn_per_s": instret / cs["prove_warm"], "insn_per_s_cold": instret / cs["prove"],
          "verified": True, "final_public_value": final_pv,
          "proof_bytes": [len(b) for b in cont["blobs"]], "proof_sha256": list(c_shas),
          "peak_gb": cont["peak_gb"],
          "peak_above_start_gb": c_peak_above,
          "path3_peak_above_start_gb": v_peak_gb - v_start_gb, "launches": c_launches,
          "plain_checks": c_checks,
          "quotient_one_launch": quotient_path4_timing(dev, rng, cvm, seg_heights[0])})
    emit({"phase": "debug", **run_debug_check(dev, cvm)})
    # path 11 verifies segment 0's proof: keep it, its VM's verifying key
    # and the AIRs' indices, and nothing of path 4 on the card
    app = {"vk": cvm.pk.vk, "proof": cont["proofs"][0], "air_index": dict(cvm.air_index)}
    del cont, cvm

    kernels = timing(dev, setup, rng, main, err, traces, launches, proved,
                     ctxs, cfg, p_launches, vmr, v_launches, qprogs, profile, c_launches)
    del vmr, proved

    # ---- paths 5 and 6: the keccak and sha256 extensions -------------------
    k_launches, k_stream = phase_keccak(dev, cfg, err)
    s_launches = phase_sha(dev, cfg, err)
    # ---- path 7: sha256, int256 and modular arithmetic ---------------------
    u_launches = phase_u256(dev, cfg, err)
    # ---- path 8: ecrecover, the ECC chips and every RV32IM chip -------------
    e_launches = phase_ecrecover(dev, cfg, err)
    # ---- path 9: BN254 pairing checks on the Fp2 chips ----------------------
    b_launches = phase_pairing(dev, cfg, err)
    # ---- path 10: the native VM, a leaf verifier's FRI query phase -----------
    n_launches = phase_native(dev, cfg, err)
    # ---- path 11: the leaf verifier over path 4's first segment proof ------
    l_launches = phase_leaf(dev, cfg, app, err)
    # the streamed launch's transpose, launched on paths 4-6 only: its row
    # from keccakf's main LDE on path 5
    tr = k_stream["transpose"]
    kernels.append({
        "name": "quotient_transpose", "route": "cuda",
        "source": "openvm_tpu_torch/csrc/quotient.cu",
        "entries": list(GLOBALS["quotient_transpose"]),
        "replaces": "openvm_tpu/stark/evaluator.py:29 (K7's streamed launch reads "
                    "column-major copies; no JAX counterpart)",
        "launches": v_launches["quotient_transpose"],
        "launches_path2": p_launches["quotient_transpose"],
        "launches_path1": launches["quotient_transpose"],
        "launches_path4": c_launches["quotient_transpose"], "max_abs_err": 0,
        "ms": tr["ms"], "plain_ms": tr["plain_ms"], "bound_ms": tr["bound_ms"],
        "bound_by": "bytes", "library_ms": tr["plain_ms"],
        "library": "the plain version's one call, m[:n].t().contiguous()",
        "shape": tr["shape"]})
    for k in kernels:
        k["launches_path5"], k["launches_path6"] = k_launches[k["name"]], s_launches[k["name"]]
        k["launches_path7"], k["launches_path8"] = u_launches[k["name"]], e_launches[k["name"]]
        k["launches_path9"], k["launches_path10"] = b_launches[k["name"]], n_launches[k["name"]]
        k["launches_path11"] = l_launches[k["name"]]
        k["max_abs_err"] = max(k["max_abs_err"], err.get(k["name"], 0))
    next(k for k in kernels if k["name"] == "quotient")["stream_path5"] = k_stream
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


def gather_cost(plan, idx) -> tuple:
    """(bytes, operations) of K6's function over a plan: each gathered word
    read once and written once and the indices read once; a reduction (from
    Montgomery form) a word.  The job table, the jobs' first units and the
    blocks' first jobs are the kernel's own design and are not counted."""
    total = len(idx) * sum(int(m.shape[1]) for m, _, _ in plan.jobs)
    return total * 8 + len(idx) * 8, total * RED_OPS


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
            qmod.FOLD_B: EXT_SCALE + EXT_ADD, qmod.FOLD_E: EXT_MUL + EXT_ADD,
            qmod.MADD_EB: EXT_SCALE + EXT_ADD, qmod.MSUB_EB: EXT_SCALE + EXT_ADD,
            qmod.MRSUB_EB: EXT_SCALE + EXT_ADD,
            qmod.MULFOLD_BB: MUL_OPS + EXT_SCALE + EXT_ADD,
            qmod.SUBFOLD_EE: EXT_ADD + EXT_MUL + EXT_ADD}
    ops = sum(cost.get(int(op), 0) for op in prog.code[:, 0] & qmod.OPCODE) + EXT_SCALE
    for bit, with_inverse in ((1, True), (2, True), (4, False)):
        if prog.sel_mask & bit:
            ops += ADD_OPS + (BATCH_INV + MUL_OPS if with_inverse else 0)
    return ops


def reduced_open_cost(jobs: list) -> tuple:
    """(bytes, operations) of K13 over reduced-opening jobs: each matrix
    read once and each height's ro written once; per word of a row 4
    multiply-adds into 64 bits and one more for the fold every 4 words, per
    matrix and row 4 reductions, and per matrix, row and point one delayed
    extension product and an add; per row its point x (a product) and per
    distinct point of its height 1/(z - x) in the base field: f(x) by
    Horner (4 products, 4 adds), a batch inverse (3 products), q(x) by
    Horner (two extension-by-base scales and adds, a base add) and its
    scale by 1/f; then s - C (an extension sub), one delayed product and
    an add."""
    heights: dict = {}
    nbytes = ops = 0
    for mat, pts in jobs:
        h, w = int(mat.shape[0]), int(mat.shape[1])
        heights.setdefault(h, set()).update(tuple(int(v) for v in z) for z, _, _ in pts)
        nbytes += h * w * 4
        ops += h * (w * 5 * WIDE_MAC_OPS + 4 * RED_OPS + len(pts) * (EXT_MUL_D + EXT_ADD))
    per_point = (7 * MUL_OPS + 4 * ADD_OPS + 3 * (EXT_SCALE + EXT_ADD) + ADD_OPS
                 + EXT_MUL_D + EXT_ADD)
    for h, zs in heights.items():
        nbytes += h * 16
        ops += h * (MUL_OPS + len(zs) * per_point)
    return nbytes, ops


def fold_cost(half: int, with_ro: bool) -> tuple:
    """(bytes, operations) of one K14 fold to ``half`` outputs: 32 bytes
    read and 16 written an output, 16 more read with ro; per output v1 - v0,
    its scale by 1/(-2y), beta - y, a delayed extension product and an add,
    the two products that make y and 1/(-2y), and with ro a delayed product
    and an add."""
    return (half * (48 + 16 * with_ro),
            half * (2 * EXT_ADD + EXT_SCALE + ADD_OPS + EXT_MUL_D + 2 * MUL_OPS
                    + (EXT_MUL_D + EXT_ADD) * with_ro))


def columns_cost(prog) -> tuple:
    """(distinct columns loaded, operations) per row of a columns program:
    its node operations, no fold and no selectors."""
    cost = {qmod.ADD_BB: ADD_OPS, qmod.SUB_BB: ADD_OPS, qmod.NEG_B: ADD_OPS,
            qmod.MUL_BB: MUL_OPS}
    loads = {(int(a) >> 1, int(b)) for op, _, a, b in prog.code
             if op & qmod.OPCODE == qmod.LOAD_B}
    return len(loads), sum(cost.get(int(op), 0) for op in prog.code[:, 0] & qmod.OPCODE)


def perm_cols_ops(layout) -> int:
    """The fewest operations per row of K9, priced at the delayed-reduction
    arithmetic the kernel uses: per interaction 4 multiply-adds a field
    and, every 4 fields, 4 reductions and an extension add into the
    constant alpha + bus; a batch inverse at 3 delayed extension products
    an element (none for a field-less interaction, whose denominator is a
    constant); the count's scale and the add into its chunk."""
    return sum(nf * 4 * WIDE_MAC_OPS + -(-nf // 4) * (4 * RED_OPS + EXT_ADD)
               + (3 * EXT_MUL_D if nf else 0) + EXT_SCALE + EXT_ADD
               for nf in layout.table[:, 1].tolist())


def perm_scan_cost(n: int, m: int) -> tuple:
    """(bytes, operations) of K10 over n rows of m chunks: each row's 4m
    words read and its 4 words of phi written; the row sum and the scan's
    add, an extension add a chunk."""
    return n * (4 * m + 4) * 4, n * m * EXT_ADD


def open_cost(jobs: list, zpows) -> tuple:
    """(bytes, operations) of K12 over a job table: every coefficient
    matrix once, zpows once (as far as the tallest matrix reads it), the
    openings written; per row and point a row weight (a scale and the
    product for the next power), per element and point a scale and an
    add."""
    n_max = max(int(c.shape[0]) for c, _ in jobs)
    nbytes = n_max * 16 + sum(int(c.shape[0]) * int(c.shape[1]) * 4
                              + len(m) * int(c.shape[1]) * 16 for c, m in jobs)
    ops = sum(int(c.shape[0]) * len(m) * (EXT_SCALE + MUL_OPS + int(c.shape[1])
                                          * (EXT_SCALE + EXT_ADD)) for c, m in jobs)
    return nbytes, ops


def quotient_cost(recs) -> tuple:
    """(bytes, operations) of K7 over quotient jobs (program, _, log_n,
    lqd): each cell a program loads read once, 16 bytes out a row, and
    ``quotient_ops`` a row."""
    ops = sum((1 << (r[2] + r[3])) * quotient_ops(r[0]) for r in recs)
    nbytes = 0
    for prog, _, log_n, lqd in recs:
        cells = {(int(a) >> 1, int(b), int(op) & qmod.OPCODE) for op, _, a, b in prog.code
                 if op & qmod.OPCODE in (qmod.LOAD_B, qmod.LOAD_E)}
        row_words = sum(4 if op == qmod.LOAD_E else 1 for _, _, op in cells)
        nbytes += (1 << (log_n + lqd)) * (row_words * 4 + 16)
    return nbytes, ops


def lookup_scatter(cols, layout, sizes) -> tuple:
    """The live sends' (index, count) pairs of one AIR over the three tables
    laid end to end, and the words the function must read: each distinct
    count row of the layout on every row (sends share counts), and each
    distinct field row on the rows where a send that reads it is live; for
    the index_add_ yardstick and the bound."""
    range_h, tuple_h, sizes1 = sizes
    offsets = {lookup.RANGE: 0, lookup.BITWISE: range_h,
               lookup.TUPLE: range_h + lookup.BITWISE_BINS}
    limit = {lookup.RANGE: range_h, lookup.BITWISE: lookup.BITWISE_BINS,
             lookup.TUPLE: tuple_h}
    c = bb.from_monty_plain(cols).long()
    count_rows = set(layout.table[:, 4].tolist())
    field_live: dict = {}
    idxs, cnts = [], []
    for kind, rx, ry, rz, rc in layout.table.tolist():
        cnt = c[rc]
        idx = lookup._indices(c, kind, rx, ry, rz, sizes1)
        live = cnt != 0
        for r in {rx, ry, rz} - count_rows:  # rz is ry but for bitwise sends
            field_live[r] = field_live[r] | live if r in field_live else live
        keep = live & (idx < limit[kind])
        idxs.append(idx[keep] + offsets[kind])
        cnts.append(cnt[keep])
    words = int(c.shape[1]) * len(count_rows) + sum(int(m.sum()) for m in field_live.values())
    return torch.cat(idxs), torch.cat(cnts), words


def hist_cost(scatter: list, tables) -> tuple:
    """(bytes, operations) of one K8 launch over AIRs whose
    ``lookup_scatter`` results are ``scatter``: their words read once and
    the tables read and written once; a from_monty (a reduction) a word
    read, and per kept live send its index (3 adds and a shift) and add."""
    words = sum(w for _, _, w in scatter)
    live = sum(int(cnt.numel()) for _, cnt, _ in scatter)
    table_words = sum(int(t.numel()) for t in tables)
    return (words + 2 * table_words) * 4, words * RED_OPS + live * (3 * ADD_OPS + 1)


def timing(dev, setup, rng, main, err, traces, launches, proved, ctxs, cfg,
           p_launches, vmr, v_launches, qprogs, profile, c_launches) -> list:
    """Each kernel and its plain version at the paths' shapes, with its
    path-3 device ms and path-3 bound from ``profile`` (vm_profile) and its
    launches in path 4's cold run (``c_launches``)."""
    path3_bounds, path3_ms = profile["bounds"], profile["ms_by_kernel"]
    ojobs, ozpows = vmr["record"]["openings"]
    open_path3 = {"jobs": len(ojobs), "bound_ms": bound(*open_cost(ojobs, ozpows))[0],
                  "ms": cuda_ms(lambda: pv.open_many(ojobs, ozpows), 10),
                  "ms_host": cuda_ms(lambda: pv.open_many(ojobs, ozpows), 10, busy=False)}
    # K13's one launch over path 3's reduced openings, with the host's
    # table build and upload (ms_host) and without the card kept busy
    rjobs = vmr["record"]["reduced_openings"]
    ro_path3 = {"jobs": len(rjobs[0]), "bound_ms": bound(*reduced_open_cost(rjobs[0]))[0],
                "bound_by": bound(*reduced_open_cost(rjobs[0]))[1],
                "ms": cuda_ms(lambda: pv.reduced_open_many(*rjobs), 10),
                "ms_host": cuda_ms(lambda: pv.reduced_open_many(*rjobs), 10, busy=False),
                "heights": sorted({int(m.shape[0]) for m, _ in rjobs[0]}, reverse=True)}
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
    # K5's tail at its default threshold: the last layers of a FRI tree
    h_tail = merkle.TAIL_MAX
    n_tail = h_tail.bit_length()
    tail_in = words(rng, dev, 2 * h_tail, 8)

    # ---- path 2 kernels at the prove's shapes: K6 the prove's whole query
    # gather; K7 the prove's own quotient inputs of FibonacciAir at 2^22;
    # the others on FibonacciAir at 2^22
    gplan, gidx = proved["record"]["gather"]
    qargs = proved["record"]["quotient"][0]
    prog, nq = qargs[0], 1 << (qargs[2] + qargs[3])
    fib_dev = bb.to_monty(bb.from_numpy(ctxs[0].common_main.astype(np.uint32), device=dev))
    log_n = int(fib_dev.shape[0]).bit_length() - 1
    fib_lde, fib_coeffs = ntt.coset_lde(fib_dev, 1, return_coeffs=True)
    zeta = words(rng, dev, 4)
    zeta_words = zeta.tolist()
    zpows = ef.powers_host(zeta_words, nq, dev)
    ext_a = words(rng, dev, nq, 4)
    open_jobs = [(fib_coeffs, [1, bb.two_adic_generator_int(log_n)])]
    # K13 on FibonacciAir's LDE (2^23 x 2) opened at two points
    k13 = ([(fib_lde, [tuple(tuple(int(v) for v in rng.integers(0, P, size=4))
                             for _ in range(3)) for _ in range(2)])],
           tuple(int(v) for v in rng.integers(0, P, size=4)))
    k13_got, k13_want = pv.reduced_open_many(*k13), pv.reduced_open_many_plain(*k13)
    fold_in, beta = words(rng, dev, 2 * nq, 4), words(rng, dev, 4)
    errs = {
        "ext_powers": max_abs_err(zpows, ef.powers_plain(zeta, nq)),
        "ext_elementwise": max_abs_err(ef.mul(ext_a, zeta), ef.mul_plain(ext_a, zeta)),
        "open_dot": max_abs_err(pv.open_many(open_jobs, zpows)[0],
                                pv.open_many_plain(open_jobs, zpows)[0]),
        "fri_reduced_open": max(max_abs_err(k13_got[k], k13_want[k]) for k in k13_want),
        "fri_fold": max_abs_err(fri.fold_evals(fold_in, beta),
                                fri.fold_evals_plain(fold_in, beta)),
    }
    err = {**err, **errs}
    require(all(v == 0 for v in errs.values()), f"kernel and plain differ: {errs}")
    del k13_got, k13_want
    w_f = int(fib_lde.shape[1])

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
    row_sums_t = row_sums.t().contiguous()  # (4, N): the scan on the inner dimension
    lk = rec["lookup"]
    _, h_prog, h_src, h_log_n, h_layout = next(a for a in lk["airs"]
                                               if a[0] == "rv32_base_alu")
    h_cols = qmod.evaluate_columns(h_prog, h_src, h_log_n)
    h_scatter = lookup_scatter(h_cols, h_layout, lk["sizes"])
    h_idx, h_cnt = h_scatter[:2]
    range_h, tuple_total, sizes1 = lk["sizes"]
    h_tabs = lookup.new_tables(range_h, tuple_total, dev)
    # alpha and beta's powers as host words, as the prove passes them
    k9_cols, _, k9_alpha, k9_bpows = k9_args
    k9_alpha, k9_bpows = bb.to_numpy(k9_alpha), bb.to_numpy(k9_bpows)
    flat_tab = torch.zeros(sum(int(x.numel()) for x in h_tabs), dtype=torch.int64,
                           device=dev)
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
        ("poseidon2_compress_tail", "poseidon2.cu", "openvm_tpu/merkle.py:49",
         lambda: merkle.compress_tail(tail_in, [None] * n_tail),
         lambda: merkle.compress_tail_plain(tail_in, [None] * n_tail), 10, 1,
         (2 * h_tail + 2 * h_tail - 1) * 32, (2 * h_tail - 1) * PERM_OPS,
         [2 * h_tail, 8]),
        ("ext_elementwise", "ext.cu", "openvm_tpu/field/ext.py:72",
         lambda: ef.mul(ext_a, zeta), lambda: ef.mul_plain(ext_a, zeta), 10, 1,
         nq * 32, nq * EXT_MUL, [nq, 4]),
        ("ext_powers", "ext.cu", "openvm_tpu/stark/prover.py:220",
         lambda: ef.powers_host(zeta_words, nq, dev), lambda: ef.powers_plain(zeta, nq),
         20, 1, nq * 16, nq * EXT_MUL_D, [nq, 4]),
        ("gather", "gather.cu", "openvm_tpu/merkle.py:118",
         lambda: gplan.run_device(gidx), lambda: gplan.run_plain(gidx), 20, 3,
         *gather_cost(gplan, gidx), [len(gidx), len(gplan.jobs)]),
        ("quotient", "quotient.cu", "openvm_tpu/stark/evaluator.py:29",
         lambda: qmod.evaluate(*qargs), lambda: qmod.evaluate_plain(*qargs), 5, 1,
         nq * (w_f * 4 + 16 + 4), nq * quotient_ops(prog),
         [nq, int(prog.code.shape[0])]),
        ("open_dot", "open.cu", "openvm_tpu/stark/prover.py:232",
         lambda: pv.open_many(open_jobs, zpows),
         lambda: pv.open_many_plain(open_jobs, zpows), 10, 1,
         *open_cost(open_jobs, zpows), [nq, w_f, 2]),
        ("fri_reduced_open", "fri.cu", "openvm_tpu/stark/prover.py:773",
         lambda: pv.reduced_open_many(*k13), lambda: pv.reduced_open_many_plain(*k13),
         10, 1, *reduced_open_cost(k13[0]), [2 * nq, w_f, 2]),
        ("fri_fold", "fri.cu", "openvm_tpu/fri.py:78",
         lambda: fri.fold_evals(fold_in, beta),
         lambda: fri.fold_evals_plain(fold_in, beta), 20, 2, *fold_cost(nq, False),
         [2 * nq, 4]),
        ("quotient_columns", "quotient.cu", "openvm_tpu/stark/logup.py:155",
         lambda: qmod.evaluate_columns(c_prog, c_src, c_log_n),
         lambda: qmod.evaluate_columns_plain(c_prog, c_src, c_log_n), 10, 1,
         n_alu * (c_loads + c_prog.n_roots) * 4, n_alu * c_ops,
         [n_alu, c_prog.n_roots, int(c_prog.code.shape[0])]),
        ("perm_cols", "logup.cu", "openvm_tpu/stark/logup.py:247",
         lambda: logup.perm_cols_many([k9_cols], [k9_layout], k9_alpha, k9_bpows),
         lambda: logup.perm_cols_plain(*k9_args),
         5, 1, n_alu * (len(k9_layout.roots) + 4 * m_alu) * 4,
         n_alu * perm_cols_ops(k9_layout), [n_alu, len(k9_layout.roots), m_alu]),
        ("perm_scan", "logup.cu", "openvm_tpu/stark/logup.py:328",
         lambda: logup.perm_scan(perm_in), lambda: logup.perm_scan_plain(perm_in),
         10, 2, *perm_scan_cost(n_alu, m_alu), [n_alu, 4 * m_alu]),
        ("lookup_hist", "lookup.cu", "openvm_tpu/stark/evaluator.py:253",
         lambda: lookup.lookup_hist_many([h_cols], [h_layout], h_tabs, sizes1),
         lambda: lookup.lookup_hist_plain(h_cols, h_layout, h_tabs, sizes1), 10, 2,
         *hist_cost([h_scatter], h_tabs), [n_alu, int(h_layout.table.shape[0])]),
    ]
    library = {
        "perm_scan": (lambda: torch.cumsum(row_sums_t, dim=1),
                      "torch.cumsum over the inner dimension of the (4, N) int64 row "
                      "sums: the prefix sum without its reduction mod p or the row "
                      "sums"),
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
        ms_host = cuda_ms(fn, reps, busy=False)
        plain_ms = cuda_ms(plain, plain_reps)
        b_ms, b_by = bound(nbytes, ops)
        lib_fn, lib_what = library.get(name, (None, NO_LIBRARY + (
            " (a modular dot product has no torch call)" if name == "open_dot" else "")))
        kernels.append({
            "name": name, "route": "cuda", "source": f"openvm_tpu_torch/csrc/{src}",
            "entries": list(GLOBALS[name]),
            "replaces": replaces, "launches": v_launches[name],
            "launches_path2": p_launches[name], "launches_path1": launches[name],
            "launches_path4": c_launches[name],
            "max_abs_err": err[name], "ms": ms, "ms_host": ms_host,
            "host_enqueue_ms": host_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms(lib_fn, 10) if lib_fn else None, "library": lib_what,
            "shape": shape, "bytes": nbytes, "ops": ops})
    by_name = {k["name"]: k for k in kernels}
    # the earlier yardstick, on the outer dimension of the (N, 4) row sums
    # (four columns in parallel), kept beside the new one
    by_name["perm_scan"]["library_ms_outer_dim"] = cuda_ms(
        lambda: torch.cumsum(row_sums, dim=0), 10)
    by_name["perm_scan"]["library_outer_dim"] = (
        "torch.cumsum over dim 0 of the (N, 4) int64 row sums")
    for k in kernels:
        k["path3_bound_ms"] = path3_bounds[k["name"]]["bound_ms"]
        k["path3_ms"] = path3_ms.get(k["name"])
    series_gather = series_gather_timing(dev, proved, vmr, zeta_words)
    by_name["ext_powers"]["path3_launch"] = series_gather["ext_powers_path3"]
    by_name["gather"].update(run_host_ms=series_gather["gather_path2"]["run_host_ms"],
                             kernel_ms=series_gather["gather_path2"]["kernel_ms"],
                             kernel_launches=series_gather["gather_path2"]["kernel_launches"],
                             path3_launch=series_gather["gather_path3"])
    # K3 in the prove path's form (stark/prover.py: every LDE returns its
    # raw coefficients too, one more n x w output), and its launches per LDE
    k3 = by_name["ntt"]
    k3["ms_return_coeffs"] = cuda_ms(lambda: ntt.coset_lde(joined, 1, return_coeffs=True), 5)
    k3["plain_ms_return_coeffs"] = cuda_ms(
        lambda: ntt.coset_lde_plain(joined, 1, return_coeffs=True), 1)
    k3["bound_ms_return_coeffs"] = bound(n1 * w1 * 4 * 4, k3["ops"])[0]
    _build.reset_launches()
    ntt.coset_lde(joined, 1)
    k3["launches_per_lde"] = _build.LAUNCHES["ntt"]
    k3["passes"] = {"inverse": ntt._pass_plan(log_n1), "forward": ntt._pass_plan(log_n1 + 1)}
    # K4 and K5 against the issue rate of the SASS they run
    sass = clock = None
    try:
        sass = sass_permutation()
        clock = max_sm_clock_hz(dev)
        for name, perms in (("poseidon2_hash_rows", rows_leaf * -(-w_leaf // 8)),
                            ("poseidon2_compress_layer", h5 * 2)):
            by_name[name]["sass_per_permutation"] = sass
            by_name[name]["bound_issue_ms"] = (perms * sass["per_permutation"]
                                               / (H100_SMS * ISSUE_PER_SM_CLOCK * clock) * 1e3)
            by_name[name]["max_sm_clock_hz"] = clock
    except (OSError, subprocess.SubprocessError, StopIteration, ValueError) as e:
        by_name["poseidon2_hash_rows"]["sass_per_permutation"] = f"not measured: {e}"
    compress = compress_timing(dev, rng, tree, sass, clock)
    by_name["poseidon2_compress_tail"]["tail_max"] = merkle.TAIL_MAX
    quotient_vm = quotient_timing(vmr)
    quotient_streamed = streamed_variant_timing(dev, rng, qprogs)
    hist_perm = lookup_logup_timing(vmr, dev)
    by_name["lookup_hist"].update(path3_launch=hist_perm["lookup_hist"],
                                  skew=hist_perm["skew"])
    by_name["perm_cols"]["path3_launch"] = hist_perm["perm_cols"]
    # path 1's stages again, warm: the NTT tables are cached now; stage
    # times, so the host's enqueue counts
    warm_ms = {"to_monty_lde": cuda_ms(lambda: ntt.batched_coset_ldes(
                   [bb.to_monty(t) for t in traces], cfg.fri.log_blowup), 3, busy=False),
               "commit_layers": cuda_ms(lambda: merkle.commit_layers(main["ldes"]), 3,
                                        busy=False)}
    emit({"phase": "timing", "nvidia_smi": setup["nvidia_smi"],
          "stage_warm_ms": warm_ms,
          "open_84_s": {"open_row_x84": t_open_row, "gather_rows_device": t_gather},
          "kernels": {k["name"]: {"kernel_ms": k["ms"], "ms_host": k["ms_host"],
                                  "host_enqueue_ms": k["host_enqueue_ms"],
                                  "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"]}
                      for k in kernels},
          "ntt_return_coeffs_ms": k3["ms_return_coeffs"],
          "ntt_launches_per_lde": k3["launches_per_lde"], "ntt_passes": k3["passes"],
          "poseidon2_sass": by_name["poseidon2_hash_rows"].get("sass_per_permutation"),
          "poseidon2_hash_rows_bound_issue_ms":
              by_name["poseidon2_hash_rows"].get("bound_issue_ms"),
          "compress_phase": compress, "quotient_vm": quotient_vm,
          "quotient_streamed": quotient_streamed,
          "open_dot_path3": open_path3, "reduced_open_path3": ro_path3,
          "lookup_logup_path3": hist_perm, "series_gather": series_gather,
          "path3_bounds": path3_bounds})
    return kernels


def host_ms(fn, reps: int) -> float:
    """Mean wall ms of fn() on the host clock, after one warm-up call, each
    call ended by a synchronisation (``fn``'s own, or this one's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def kernel_only_ms(fn, kernel: str, reps: int) -> dict:
    """Device ms of one ``kernel`` (a __global__ name) over reps calls of
    fn() under torch.profiler, without the copies fn enqueues.  A warm-up
    step runs one call with the device trace already on.  The trace has
    kept fewer launches than were made (18 or 19 of 20 K6 launches), so the
    mean is over the launches it kept: ``kept`` of ``made``."""
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        prof.step()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    require(spans, f"{kernel}: no launch profiled of {reps} made")
    return {"ms": sum(spans) / 1e3 / len(spans), "kept": len(spans), "made": reps}


def series_gather_timing(dev, proved, vmr, zeta_words) -> dict:
    """K2's power series at path 3's length and K6 on path 2's and path
    3's own plans: device ms (card kept busy; K6's with its upload, and its
    kernel alone under the profiler), the host ms to enqueue one call, and
    for K6 the wall ms of one whole ``run`` (table, upload, launch, pinned
    copy, wait), of building the prove's plan, and of cutting the output
    into per-job views by width runs and job by job."""
    n3 = int(vmr["record"]["openings"][1].shape[0])
    ms, enq = cuda_ms(lambda: ef.powers_host(zeta_words, n3, dev), 20, host=True)
    out = {"ext_powers_path3": {"n": n3, "ms": ms, "host_enqueue_ms": enq,
                                "ms_host": cuda_ms(lambda: ef.powers_host(zeta_words, n3, dev),
                                                   20, busy=False),
                                "bound_ms": bound(n3 * 16, n3 * EXT_MUL_D)[0]}}
    for key, rec in (("path2", proved["record"]), ("path3", vmr["record"])):
        plan, idx = rec["gather"]
        ms, enq = cuda_ms(lambda: plan.run_device(idx), 20, host=True)
        row = {"jobs": len(plan.jobs), "queries": len(idx), "words": plan.table(idx)[4],
               "ms": ms, "host_enqueue_ms": enq,
               "run_host_ms": host_ms(lambda: plan.run(idx), 20),
               "bound_ms": bound(*gather_cost(plan, idx))[0]}
        prof_ms = kernel_only_ms(lambda: plan.run_device(idx), "gather_kernel", 20)
        row["kernel_ms"] = prof_ms.pop("ms")
        row["kernel_launches"] = prof_ms  # kept by the profiler, of made
        words, q = np.zeros(row["words"], dtype=np.uint32), len(idx)

        def split(by_runs):
            # run's last step, the host buffer cut into per-job views
            views, o = [], 0
            if by_runs:  # as GatherPlan.run does
                for w, k in plan._runs:
                    views.extend(words[o:o + k * q * w].reshape(k, q, w))
                    o += k * q * w
            else:  # a view a job
                for m, _, _ in plan.jobs:
                    w = int(m.shape[1])
                    views.append(words[o:o + q * w].reshape(q, w))
                    o += q * w
            return views
        row["split_host_ms"] = {"width_runs": host_ms(lambda: split(True), 50),
                                "per_job": host_ms(lambda: split(False), 50)}

        def rebuild():
            again = merkle.GatherPlan()
            for m, s, f in plan.jobs:
                again.add(m, s, f)
        row["plan_add_host_ms"] = host_ms(rebuild, 20)
        out[f"gather_{key}"] = row
    return out


def compress_phase(leaf, inj: dict, tail_max) -> None:
    """K5's launches of one commit after its leaf hash: compress_layer for
    each layer of more than ``tail_max`` digests, then the tail; with
    ``tail_max`` None every layer its own compress_layer launch (the plan
    without a tail).  ``inj``: row digests injected by output height."""
    single, rest = merkle.commit_plan(int(leaf.shape[0]), tail_max or 1)
    if tail_max is None:
        single, rest = single + rest, []
    x = leaf
    for h in single:
        x = merkle.compress_layer(x, inj.get(h))
    if rest:
        merkle.compress_tail(x, [inj.get(h) for h in rest])


def compress_timing(dev, rng, tree, sass, clock) -> dict:
    """K5 over the whole compress phase of path 1's main tree (2^21 leaves,
    injections at 2^20 to 2^17) and of a FRI tree of 2^20 leaves, at tail
    thresholds from 64 to 512 digests and layer by layer, with bounds by
    operations and by issue from the permutation count."""
    by_h: dict = {}
    for m in tree.matrices:
        by_h.setdefault(int(m.shape[0]), []).append(m)
    max_h = tree.max_height()
    inj = {h: p2.hash_rows(torch.cat(ms, dim=1).contiguous())
           for h, ms in by_h.items() if h < max_h}
    trees = {f"path1_main_2^{max_h.bit_length() - 1}": (tree.digest_layers[0], inj),
             f"fri_2^{FRI_TREE_LOG}": (words(rng, dev, 1 << FRI_TREE_LOG, 8), {})}
    out = {}
    for name, (leaf, injd) in trees.items():
        outs = merkle.commit_plan(int(leaf.shape[0]), 1)[0] + [1]
        perms = sum(h * (2 if h in injd else 1) for h in outs)
        b_ms, b_by = bound(sum(h * 32 * (3 + (1 if h in injd else 0)) for h in outs),
                           perms * PERM_OPS)
        row = {"permutations": perms, "bound_ms": b_ms, "bound_by": b_by,
               "bound_issue_ms": (perms * sass["per_permutation"]
                                  / (H100_SMS * ISSUE_PER_SM_CLOCK * clock) * 1e3)
               if sass and clock else "not measured"}
        for t in (None, 64, 128, 256, 512):
            _build.reset_launches()
            compress_phase(leaf, injd, t)
            launches = (_build.LAUNCHES["poseidon2_compress_layer"]
                        + _build.LAUNCHES["poseidon2_compress_tail"])
            key = "layer_by_layer" if t is None else f"tail_{t}"
            row[key] = {"ms": cuda_ms(lambda: compress_phase(leaf, injd, t), 5),
                        "ms_host": cuda_ms(lambda: compress_phase(leaf, injd, t), 5,
                                           busy=False),
                        "launches": launches}
        row["default_tail_max"] = merkle.TAIL_MAX
        out[name] = row
    return out


def quotient_timing(vmr) -> dict:
    """K7 at path 3's own quotient inputs: rv32_base_alu alone and the
    prove's one launch over all 15 AIRs with the code kept on the card,
    each with its bound (quotient_ops per row)."""
    vm, qrec = vmr["vm"], vmr["record"]["quotient"]
    alu = vm.air_index["rv32_base_alu"]
    code = next(iter(vm.pk.quotient_code.values()))[1]
    cols = [list(c) for c in zip(*qrec)]

    out = {"rv32_base_alu": {"rows": 1 << (qrec[alu][2] + qrec[alu][3]),
                             "instructions": int(qrec[alu][0].code.shape[0]),
                             "lane_words": qrec[alu][0].lane_words,
                             "ops_per_row": quotient_ops(qrec[alu][0])},
           "path3_launch": {"airs": len(qrec)}}
    for key, recs in (("rv32_base_alu", [qrec[alu]]), ("path3_launch", qrec)):
        b_ms, b_by = bound(*quotient_cost(recs))
        out[key].update({"bound_ms": b_ms, "bound_by": b_by})
    for key, fn in (("rv32_base_alu", lambda: qmod.evaluate(*qrec[alu])),
                    ("path3_launch", lambda: qmod.evaluate_many(*cols, code=code))):
        out[key]["ms"] = cuda_ms(fn, 10)
        out[key]["ms_host"] = cuda_ms(fn, 10, busy=False)
    return out


def send_skew(idx: torch.Tensor, range_h: int) -> dict:
    """How path 3's live sends (kept indices, the three tables laid end to
    end as ``lookup_scatter`` gives them) fall on bins: the hottest bin's
    share, and the share that K8 adds into its private bins (the first
    RANGE_SEG values of each bit width of the range table, the first
    BITWISE_HEAD bins of the bitwise table)."""
    hist = torch.bincount(idx)
    one = idx + 1
    private = (idx >= range_h) & (idx < range_h + lookup.BITWISE_HEAD)
    for b in range(range_h.bit_length()):
        private |= (idx < range_h) & (one >= 1 << b) & (one < (1 << b) + min(
            lookup.RANGE_SEG, 1 << b))
    live = int(idx.numel())
    return {"live_sends": live, "bins_hit": int((hist > 0).sum()),
            "hottest_bin": int(hist.argmax()), "hottest_bin_share": int(hist.max()) / live,
            "private_share": int(private.sum()) / live,
            "private_bins": range_h.bit_length() * lookup.RANGE_SEG + lookup.BITWISE_HEAD}


def lookup_logup_timing(vmr, dev) -> dict:
    """K8 and K9 at path 3's own inputs, as the prove launches them: every
    AIR in one launch each, with the sum of the AIRs' bounds; the skew of
    path 3's sends; and the host seconds of compiling every AIR's columns
    programs, which the prover now does once per proving key
    (``pk.kernel_plans``)."""
    vm, rec = vmr["vm"], vmr["record"]
    lk = rec["lookup"]
    range_h, tuple_total, sizes1 = lk["sizes"]
    cols = [qmod.evaluate_columns(prog, src, log_n) for _, prog, src, log_n, _ in lk["airs"]]
    layouts = [a[4] for a in lk["airs"]]
    tabs = lookup.new_tables(range_h, tuple_total, dev)
    scatter = [lookup_scatter(c, lay, lk["sizes"]) for c, lay in zip(cols, layouts)]
    nbytes, ops = hist_cost(scatter, tabs)
    skew = send_skew(torch.cat([idx for idx, _, _ in scatter]), range_h)
    del scatter
    out = {"skew": skew}

    def launch_row(kernel, fn, nbytes, ops, airs):
        before = _build.LAUNCHES[kernel]
        fn()
        b_ms, b_by = bound(nbytes, ops)
        return {"airs": airs, "launches": _build.LAUNCHES[kernel] - before,
                "ms": cuda_ms(fn, 10), "ms_host": cuda_ms(fn, 10, busy=False),
                "bound_ms": b_ms, "bound_by": b_by}

    out["lookup_hist"] = launch_row(
        "lookup_hist", lambda: lookup.lookup_hist_many(cols, layouts, tabs, sizes1),
        nbytes, ops, len(cols))
    del cols
    plan = next(v for k, v in vm.pk.kernel_plans.items() if k[0] == "logup")
    entries = rec["logup"]
    pcols = [e["perm_cols"][0] for e in entries]
    alpha, bpows = (bb.to_numpy(x) for x in entries[0]["perm_cols"][2:])
    nbytes = sum(int(c.shape[1]) * (len(lay.roots) + 4 * lay.m) * 4
                 for c, lay in zip(pcols, plan.layouts))
    ops = sum(int(c.shape[1]) * perm_cols_ops(lay) for c, lay in zip(pcols, plan.layouts))
    out["perm_cols"] = launch_row(
        "perm_cols", lambda: logup.perm_cols_many(pcols, plan.layouts, alpha, bpows),
        nbytes, ops, len(pcols))
    # one compile of every AIR's columns programs
    sends = vm.pk.kernel_plans["lookup"]
    t0 = time.perf_counter()
    for i, _, layout in sends:
        qmod.compile_columns_code(vm.pk.vk.per_air[i].dag, layout.roots,
                                  n_main=2 if vm.airs[i].name == "program" else 1,
                                  has_preprocessed=vm.pk.per_air[i].preprocessed_trace
                                  is not None)
    t1 = time.perf_counter()
    perm_airs = [i for i, vk in enumerate(vm.pk.vk.per_air) if vk.widths.after_challenge]
    for i, layout in zip(perm_airs, plan.layouts):
        qmod.compile_columns_code(vm.pk.vk.per_air[i].dag, layout.roots,
                                  n_main=2 if vm.airs[i].name == "program" else 1,
                                  has_preprocessed=vm.pk.per_air[i].preprocessed_trace
                                  is not None)
    out["compile_columns_s"] = {"lookup_sends": t1 - t0,
                                "logup_interactions": time.perf_counter() - t1,
                                "airs": [len(sends), len(perm_airs)]}
    return out


def streamed_variant_timing(dev, rng, qprogs: dict) -> dict:
    """K7's streamed launch at 2^16 rows (log_n 15, lqd 1) on the variants'
    programs past the slot limit and past the code limit: device ms, the
    launch, bound, and equality with plain."""
    log_n, lqd = 15, 1
    srcs = [words(rng, dev, 1 << (log_n + lqd), w) for w in (3, 2, 2, 8)]
    out = {}
    for name in ("past_slots", "past_code"):
        prog = qprogs[name]
        rec = (prog, srcs, log_n, lqd)
        err = max_abs_err(qmod.evaluate(*rec), qmod.evaluate_plain(*rec))
        require(err == 0, f"the streamed launch differs from plain at 2^16: {name}")
        b_ms, b_by = bound(*quotient_cost([rec]))
        out[name] = {"rows": 1 << (log_n + lqd), "instructions": int(prog.code.shape[0]),
                     "lane_words": prog.lane_words, "reloads": prog.reloads,
                     "launch": launch_summary([name], [rec])[0],
                     "ms": cuda_ms(lambda: qmod.evaluate(*rec), 3),
                     "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    return out


if __name__ == "__main__":
    sys.exit(main())
