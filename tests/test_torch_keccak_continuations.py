"""The port's continuations of the keccak-iteration guest against
openvm_tpu's: path 5's guest and configuration at a tiny cap.

``build_keccak_iter_program(12)`` (12 keccak256 hashes of a 32-byte buffer
in place) runs in persistent memory with the keccak extension, segmented by
a cap on trace cells small enough to give two segments.  The JAX package
runs each segment only up to its STARK prove (its ``stark_prove`` replaced
by a capture of the proving contexts) on the same words, transpiled by its
own transpiler.  The port proves both segments on the CPU with its plain
versions: its metered counts and segment contexts equal the JAX package's,
and the JAX package's ``verify_segments`` accepts its segment proofs, whose
final memory opens to the iterated digest.  Like
tests/test_torch_continuations.py, this file keeps to a few test functions,
so that ``--dist loadfile`` queues it after tests/test_aggregation.py.
"""

import numpy as np
import pytest
import torch

from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu.vm import transpiler as jtranspiler
from openvm_tpu.vm.instructions import Program as JaxProgram
from openvm_tpu.vm.instructions import VmExe as JaxVmExe
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.vm import memory_tree
from openvm_tpu_torch.vm.circuit.keccak import keccak256
from openvm_tpu_torch.vm.guest import (FIB_EXECUTORS, build_keccak_iter_program,
                                       iter_insns, iter_words)
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

from test_vm_prove import TEST_STARK as JAX_TEST_STARK

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
N = 12
# about 3,960 cells a hash are counted (keccakf's 2,633 and the sponge's
# 1,253 once each, an ALU and a branch row), checked every 9 instructions
LIMITS = {"max_cells": 30_000, "check_insns": 9}


def canonical(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        return bb.canonical_np(m)
    return np.asarray(m, dtype=np.uint64) % P


@pytest.fixture(scope="module")
def runs():
    """Both packages' persistent keccak VMs, the JAX package's segment
    contexts and metered counts, the port's segment proofs, records and
    metered counts."""
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(
        stark=JAX_TEST_STARK, persistent=True, keccak=True, executors=FIB_EXECUTORS))
    jvm.keygen(cache=False)
    jexe = JaxVmExe(program=JaxProgram(
        instructions=jtranspiler.Transpiler().transpile(iter_words("keccak", N)),
        pc_base=0), pc_start=0)
    jsegs = []

    def capture(pk, ctxs):
        jsegs.append(ctxs)
        return ctxs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        _, jtree = jvm.prove_continuations(jexe, segment_limits=LIMITS)
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, persistent=True, keccak=True,
                                   executors=FIB_EXECUTORS), device="cpu")
    vm.keygen()
    exe = build_keccak_iter_program(N)
    records = {0: {}, 1: {}}
    proofs, tree = vm.prove_continuations(exe, segment_limits=LIMITS, records=records)
    return {"jax_vm": jvm, "jexe": jexe, "jax": jsegs, "jax_tree": jtree,
            "jax_metered": jvm.execute_metered(jexe), "vm": vm, "exe": exe,
            "records": records, "proofs": proofs, "tree": tree,
            "metered": vm.execute_metered(exe)}


def test_segment_contexts_equal_jax(runs):
    """Two segments, each AIR's trace (keccakf's padding permutations
    included) and public values equal to the JAX package's, and the same
    metered counts."""
    vm = runs["vm"]
    assert runs["metered"] == runs["jax_metered"]
    assert runs["metered"]["instret"] == iter_insns(N)
    assert len(runs["proofs"]) == len(runs["jax"]) == 2
    for segment, theirs in enumerate(runs["jax"]):
        ours = runs["records"][segment]["ctxs"]
        heights = {vm.airs[c.air_id].name: int(c.common_main.shape[0]) for c in ours}
        assert heights["keccakf"] >= 24 * 2, (segment, heights)
        for tc, jc in zip(ours, theirs):
            name = (segment, vm.airs[tc.air_id].name)
            assert tc.air_id == jc.air_id, name
            assert np.array_equal(canonical(tc.common_main), canonical(jc.common_main)), name
            for a, b in zip(tc.cached_mains, jc.cached_mains):
                assert np.array_equal(canonical(a), canonical(b)), name
            assert [int(v) % P for v in tc.public_values] == \
                [int(v) % P for v in jc.public_values], name


def test_jax_verify_segments_accepts_port_proofs(runs):
    jvm, vm = runs["jax_vm"], runs["vm"]
    jproofs = [jcodec.decode_proof(codec.encode_proof(p)) for p in runs["proofs"]]
    theirs = jvm.verify_segments(jproofs, runs["jexe"],
                                 expected_exe_commit=jvm.commit_exe(runs["jexe"]))
    ours = vm.verify_segments(runs["proofs"], runs["exe"],
                              expected_exe_commit=vm.commit_exe(runs["exe"]))
    assert theirs["num_segments"] == ours["num_segments"] == 2
    proof_pv = memory_tree.pv_proof(runs["tree"])
    assert proof_pv["root"].tolist() == ours["final_root"] == theirs["final_root"]
    assert runs["tree"].root().tolist() == runs["jax_tree"].root().tolist()
    digest = bytes(32)
    for _ in range(N):
        digest = keccak256(digest)
    assert [int(b) for b in proof_pv["public_values"][:8]] == \
        list(digest[:4]) + list(digest[28:32])
