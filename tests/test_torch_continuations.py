"""The port's continuations against openvm_tpu's: fib(20) proved in three
segments of 40 instructions, and fib(400) segmented by trace height.

The JAX package runs each segment only up to its STARK prove (its
``stark_prove`` replaced by a capture of the proving contexts).  The port
proves every fib(20) segment on the CPU with its plain versions: its
segment contexts equal the JAX package's, its segment proofs' SHA-256 equal
the pinned hashes of the JAX package's (recomputed live under
OPENVM_SLOW), the JAX package's ``verify_segments`` accepts them, and a
broken memory-root chain fails the port's ``verify_segments``.  Segment 0's
proof drives both packages' leaf verifier programs through their
preflights (no prove).  fib(400) at a height cap of 256 rows gives the JAX
package's metered counts, segments, public values and height profile
(contexts only, no prove), and the Python preflight loop gives the C++
core's segments.  tests/test_torch_persistent.py holds the single-segment
persistent proof and the checker.  This file keeps to a few test
functions: at seven, ``--dist loadfile`` queues it just ahead of
tests/test_aggregation.py's six (see tests/test_torch_persistent.py's
docstring).
"""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from openvm_tpu.native_compiler import verifier_program as jvp
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm import machine as jmachine
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.native_compiler import build_leaf_program, serialize_proof_felts
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.verifier import VerificationError
from openvm_tpu_torch.vm import machine, memory_tree
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program, fib
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

from test_vm_prove import TEST_STARK as JAX_TEST_STARK
from test_vm_prove import build_fib_program as jax_build_fib_program
from test_torch_recursion import assert_programs_equal, rejects

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
# sha256 of openvm_tpu's encode_proof bytes for each segment of
# VirtualMachine(Rv32Config(stark=TEST_STARK, persistent=True,
# executors=FIB_EXECUTORS)).prove_continuations(build_fib_program(20),
# max_insns_per_segment=40) (tests/test_vm_prove.py's guest)
FIB20_SEGMENT_PROOF_SHA256 = (
    "a18db16ad1af10ee09966f8a5e14d116923ac4f9faf0fdd7c6b431df19f63498",
    "c586b412a24e1e01d4c3cba615846b24eec363c0a965b5e490deee79301cc9a8",
    "fb3863fab1d20024739f24275d941adcaaf7118c9f2ae2c8751d73347de81170")


def canonical(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        return bb.canonical_np(m)
    return np.asarray(m, dtype=np.uint64) % P


def _jax_segments(jvm, exe, **kw):
    """The JAX package's per-segment proving contexts of a continuation
    run, its STARK prove replaced by a capture."""
    segments = []

    def capture(pk, ctxs):
        segments.append(ctxs)
        return ctxs

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        _, tree = jvm.prove_continuations(exe, **kw)
    return segments, tree


@pytest.fixture(scope="module")
def vms():
    """Both packages' persistent VMs, after keygen."""
    jvm = jmachine.VirtualMachine(jmachine.Rv32Config(
        stark=JAX_TEST_STARK, persistent=True, executors=FIB_EXECUTORS))
    jvm.keygen(cache=False)
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, persistent=True,
                                   executors=FIB_EXECUTORS), device="cpu")
    vm.keygen()
    return jvm, vm


@pytest.fixture(scope="module")
def fib20(vms):
    """fib(20) at 40 instructions a segment: the JAX package's contexts,
    the port's contexts and segment proofs, and segment 1's record."""
    jvm, vm = vms
    jsegs, _ = _jax_segments(jvm, jax_build_fib_program(20),
                             max_insns_per_segment=40)
    exe = build_fib_program(20)
    segs, _ = vm.segment_contexts(exe, max_insns_per_segment=40)
    record: dict = {}
    proofs, tree = vm.prove_continuations(exe, max_insns_per_segment=40,
                                          records={1: record})
    return {"jax_vm": jvm, "jax": jsegs, "vm": vm, "port": segs,
            "proofs": proofs, "tree": tree, "exe": exe, "record": record}


def test_segment_contexts_equal(fib20):
    vm = fib20["vm"]
    assert len(fib20["port"]) == len(fib20["jax"]) == 3
    for segment, (ours, theirs) in enumerate(zip(fib20["port"], fib20["jax"])):
        for tc, jc in zip(ours, theirs):
            name = (segment, vm.airs[tc.air_id].name)
            assert tc.air_id == jc.air_id, name
            assert np.array_equal(canonical(tc.common_main),
                                  canonical(jc.common_main)), name
            for a, b in zip(tc.cached_mains, jc.cached_mains):
                assert np.array_equal(canonical(a), canonical(b)), name
            assert [int(v) % P for v in tc.public_values] == \
                [int(v) % P for v in jc.public_values], name
    # prove_continuations' record of segment 1: its contexts and the inputs
    # of every kernel of its prove
    record = fib20["record"]
    assert {"ctxs", "lookup", "logup", "quotient", "openings",
            "reduced_openings", "gather"} <= set(record)
    assert len(record["quotient"]) == len(vm.airs)
    for tc, rc in zip(fib20["port"][1], record["ctxs"]):
        assert np.array_equal(canonical(tc.common_main), canonical(rc.common_main))
        assert list(tc.public_values) == list(rc.public_values)


def test_jax_verify_segments_accepts_port_proofs(fib20):
    jvm, vm = fib20["jax_vm"], fib20["vm"]
    jexe = jax_build_fib_program(20)
    jproofs = [jcodec.decode_proof(codec.encode_proof(p)) for p in fib20["proofs"]]
    result = jvm.verify_segments(jproofs, jexe,
                                 expected_exe_commit=jvm.commit_exe(jexe))
    ours = vm.verify_segments(fib20["proofs"], fib20["exe"],
                              expected_exe_commit=vm.commit_exe(fib20["exe"]))
    assert result["num_segments"] == ours["num_segments"] == 3
    proof_pv = memory_tree.pv_proof(fib20["tree"])
    assert proof_pv["root"].tolist() == ours["final_root"] == result["final_root"]
    assert int.from_bytes(bytes(proof_pv["public_values"][:4]), "little") == fib(21)


def test_segment_proofs_equal_jax(fib20):
    """The three segment proofs' SHA-256 are the JAX package's
    (``FIB20_SEGMENT_PROOF_SHA256``); with OPENVM_SLOW=1 the JAX package
    proves the segments again here (about 25 minutes of XLA:CPU compiles
    and proves) and its bytes equal the port's."""
    blobs = [codec.encode_proof(p) for p in fib20["proofs"]]
    assert tuple(hashlib.sha256(b).hexdigest() for b in blobs) == \
        FIB20_SEGMENT_PROOF_SHA256
    if os.environ.get("OPENVM_SLOW"):
        jproofs, _ = fib20["jax_vm"].prove_continuations(
            jax_build_fib_program(20), max_insns_per_segment=40)
        assert [jcodec.encode_proof(p) for p in jproofs] == blobs


def test_broken_root_chain_fails(fib20, monkeypatch):
    vm = fib20["vm"]
    proofs = copy.deepcopy(fib20["proofs"])
    mk = proofs[1].per_air[vm.air_index["memory_merkle"]]
    mk.public_values[0] = (mk.public_values[0] + 1) % P
    with pytest.raises(VerificationError):
        vm.verify_segments(proofs, fib20["exe"])
    # past the STARK check, the chain check itself refuses it
    monkeypatch.setattr(machine, "stark_verify", lambda vk, proof: None)
    with pytest.raises(VerificationError, match="memory root chain broken"):
        vm.verify_segments(proofs, fib20["exe"])


def test_leaf_program_verifies_segment_0(fib20):
    """build_leaf_program over segment 0's proof equals the JAX package's
    with PERM_POS2's e masked; one blob, decoded by each package's codec,
    serialises to one hint stream; each package's preflight of its own
    program exits 0 with the reference's leaf public values (openvm_tpu/
    sdk.py:190, 44 of them), read from the segment's own proof: its
    program commitment, the connector's and the memory tree's public
    values, zeros.  The segment's proof with one quotient-commitment felt
    changed is refused."""
    vm, jvm, proof = fib20["vm"], fib20["jax_vm"], fib20["proofs"][0]
    log_degrees = [pa.log_degree for pa in proof.per_air]
    exe, meta = build_leaf_program(vm.pk.vk, log_degrees, expose_memory_pvs=True)
    jexe, jmeta = jvp.build_leaf_program(jvm.pk.vk, log_degrees, expose_memory_pvs=True)
    assert meta == jmeta
    assert_programs_equal(exe, jexe)
    blob = codec.encode_proof(proof)
    hints = serialize_proof_felts(vm.pk.vk, codec.decode_proof(blob))
    assert hints == jvp.serialize_proof_felts(jvm.pk.vk, jcodec.decode_proof(blob))
    want = ([int(v) for v in proof.commitments.main_trace[0]]
            + _proof_pvs(vm, proof, "connector") + _proof_pvs(vm, proof, "memory_merkle")
            + [0] * 16)
    for pre in (PreflightInterpreter(exe, 44).execute(inputs=hints),
                JaxPreflight(jexe, 44).execute(inputs=hints)):
        assert pre.exit_code == 0
        assert [pre.touched.get((3, k), [0])[0] for k in range(44)] == want
    bad = copy.deepcopy(proof)
    q = [int(v) for v in bad.commitments.quotient]
    q[0] = (q[0] + 1) % P
    bad.commitments.quotient = np.asarray(q, dtype=np.uint64)
    assert rejects(exe, serialize_proof_felts(vm.pk.vk, bad), 44)


def _proof_pvs(vm, proof, name):
    return [int(v) for v in proof.per_air[vm.air_index[name]].public_values]


def _pvs(vm, ctxs, name):
    return [int(v) for v in next(c for c in ctxs
                                 if vm.airs[c.air_id].name == name).public_values]


def test_python_loop_segments_equal_native_core(vms):
    """The Python preflight loop (``native=False``) gives the C++ core's
    segment contexts."""
    vm, exe = vms[1], build_fib_program(20)
    native_segs, _ = vm.segment_contexts(exe, max_insns_per_segment=40)
    python_segs, _ = vm.segment_contexts(exe, max_insns_per_segment=40,
                                         native=False)
    assert len(native_segs) == len(python_segs) == 3
    for a_ctxs, b_ctxs in zip(native_segs, python_segs):
        for a, b in zip(a_ctxs, b_ctxs):
            assert np.array_equal(canonical(a.common_main), canonical(b.common_main))
            assert list(a.public_values) == list(b.public_values)


METERED_LIMITS = {"max_height": 256, "check_insns": 16}


@pytest.fixture(scope="module")
def fib400(vms):
    """fib(400) segmented by trace height: both packages' metered counts,
    height profiles and per-segment contexts (no prove)."""
    jvm, vm = vms
    jexe, exe = jax_build_fib_program(400), build_fib_program(400)
    jsegs, jtree_ = _jax_segments(jvm, jexe, segment_limits=METERED_LIMITS)
    segs, tree = vm.segment_contexts(exe, segment_limits=METERED_LIMITS)
    return {"jax": jsegs, "port": segs, "tree": tree, "jax_tree": jtree_,
            "metered": (jvm.execute_metered(jexe), vm.execute_metered(exe)),
            "profile": (jvm.segment_height_profile(jexe, segment_limits=METERED_LIMITS),
                        vm.segment_height_profile(exe, segment_limits=METERED_LIMITS))}


def test_fib400_metered_segments_match_jax(fib400, vms):
    """execute_metered's counts, the segments, each segment's connector
    and merkle public values (chained from the initial memory's root), the
    executor heights within the cap's check quantum, the final memory's
    public value, and the per-chip height profile equal the JAX
    package's."""
    vm = vms[1]
    theirs, ours = fib400["metered"]
    assert ours == theirs
    assert ours["instret"] == 5 * 400 + 15 and ours["exit_code"] == 0
    assert len(fib400["port"]) == len(fib400["jax"]) >= 3
    for segment, (a, b) in enumerate(zip(fib400["port"], fib400["jax"])):
        for name in ("connector", "memory_merkle"):
            assert _pvs(vm, a, name) == _pvs(vm, b, name), (segment, name)
        for c in a:
            if vm.airs[c.air_id].name.startswith("rv32_"):
                assert c.common_main.shape[0] <= 512, segment
    init_root = [int(x) for x in vm.commit_init_memory(build_fib_program(400))]
    assert _pvs(vm, fib400["port"][0], "memory_merkle")[:8] == init_root
    for a, b in zip(fib400["port"], fib400["port"][1:]):
        assert _pvs(vm, a, "connector")[1] == _pvs(vm, b, "connector")[0]
        assert _pvs(vm, a, "memory_merkle")[8:] == _pvs(vm, b, "memory_merkle")[:8]
    assert fib400["tree"].root().tolist() == fib400["jax_tree"].root().tolist()
    got = memory_tree.pv_proof(fib400["tree"])["public_values"][:4]
    assert int.from_bytes(bytes(got), "little") == fib(401) % (1 << 32)
    theirs, ours = fib400["profile"]
    assert ours == theirs and ours["rv32_base_alu"] == 512
