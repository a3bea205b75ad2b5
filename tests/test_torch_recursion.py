"""The port's in-program challenger and verifier program against openvm_tpu's.

The instance is tests/test_recursion.py's: FibonacciAir at 2^4 rows under
log_blowup 1, 4 queries and 2 PoW bits.  The port proves it on the CPU; its
proof's SHA-256 is the JAX package's (``RECURSION_PROOF_SHA256``, the JAX
prove recomputed only under OPENVM_SLOW).  ``ProgramChallenger``'s executed
samples equal the host ``DuplexChallenger``'s; ``build_verifier_program``
gives JAX's program word for word but in each PERM_POS2's e operand (the
port's is 4, the JAX package's 0: ROADMAP F5); ``serialize_proof_felts``
gives JAX's hint stream from one blob; the port's preflight of its program
accepts the proof and exposes its commitment, with JAX's records and
touched words; a tampered opening, quotient commitment or public value is
refused; ``static_height_profile`` equals JAX's.  Every case runs in
seconds: JAX keygens only FibonacciAir and runs no prove.
"""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from openvm_tpu import stark as jstark
from openvm_tpu.native_compiler import verifier_program as jvp
from openvm_tpu.stark import codec as jcodec
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch import stark
from openvm_tpu_torch.challenger import DuplexChallenger
from openvm_tpu_torch.native_compiler import (Builder, ProgramChallenger,
                                              bits_to_index, build_verifier_program,
                                              serialize_proof_felts, static_height_profile)
from openvm_tpu_torch.stark import codec
from openvm_tpu_torch.vm.instructions import Poseidon2Opcode
from openvm_tpu_torch.vm.interpreter import ExecutionError
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

from test_recursion import RECUR_CONFIG as JAX_RECUR_CONFIG
from test_stark_e2e import FibonacciAir as JaxFibonacciAir, fib_trace
from test_torch_prover import FibonacciAir

torch.set_num_threads(1)

P = 2013265921
SEED = 0
RECUR_CONFIG = stark.StarkConfig(fri=stark.FriParameters(
    log_blowup=1, num_queries=4, proof_of_work_bits=2))
# sha256 of openvm_tpu's encode_proof bytes for tests/test_recursion.py's
# fib_proof fixture (FibonacciAir, fib_trace(16), RECUR_CONFIG)
RECURSION_PROOF_SHA256 = \
    "1b09cd57dc4a14d42f04991a1556d20ffbe22d93829c46944fe6ea150558f2e8"


def masked_words(exe) -> tuple:
    """The program's instructions as (opcode, a, ..., g) tuples with each
    PERM_POS2's e operand set to None, and how many were masked."""
    out, n = [], 0
    for insn in exe.program.instructions:
        word = [insn.opcode, insn.a, insn.b, insn.c, insn.d, insn.e, insn.f, insn.g]
        if insn.opcode == Poseidon2Opcode.PERM_POS2:
            word[5] = None
            n += 1
        out.append(tuple(int(v) if v is not None else None for v in word))
    return out, n


def assert_programs_equal(exe, jexe) -> int:
    """``exe`` (the port's) equals ``jexe`` (the JAX package's) word for
    word, its start and initial memory too, but in PERM_POS2's e: 4 in
    the port's, 0 in the JAX package's.  Returns the masked count."""
    ours, n = masked_words(exe)
    theirs, jn = masked_words(jexe)
    assert ours == theirs and n == jn and n > 0
    es = {(int(a.e), int(b.e)) for a, b in zip(exe.program.instructions,
                                               jexe.program.instructions)
          if a.opcode == Poseidon2Opcode.PERM_POS2}
    assert es == {(4, 0)}
    assert exe.pc_start == jexe.pc_start
    assert dict(exe.init_memory) == dict(jexe.init_memory)
    return n


def rejects(exe, hints, num_pvs: int = 32) -> bool:
    """The port's preflight refuses the hint stream: a non-zero exit or an
    ExecutionError."""
    try:
        return PreflightInterpreter(exe, num_pvs).execute(inputs=hints).exit_code != 0
    except ExecutionError:
        return True


@pytest.fixture(scope="module")
def recursion():
    """Both packages' keys of the instance, the port's CPU proof and its
    blob decoded by both codecs, and both packages' verifier programs."""
    pk = stark.keygen([FibonacciAir()], RECUR_CONFIG, device="cpu")
    trace = fib_trace(16)
    proof = stark.prove(pk, [stark.AirProvingContext(
        air_id=0, common_main=trace, public_values=[0, 1, int(trace[-1, 1])])],
        device="cpu")
    stark.verify(pk.vk, proof)
    blob = codec.encode_proof(proof)
    jpk = jstark.keygen([JaxFibonacciAir()], JAX_RECUR_CONFIG)
    log_degrees = [p.log_degree for p in proof.per_air]
    exe, meta = build_verifier_program(pk.vk, log_degrees, expose="commit")
    jexe, jmeta = jvp.build_verifier_program(jpk.vk, log_degrees, expose="commit")
    return {"pk": pk, "jpk": jpk, "proof": codec.decode_proof(blob),
            "jproof": jcodec.decode_proof(blob), "blob": blob, "exe": exe,
            "jexe": jexe, "meta": meta, "jmeta": jmeta, "trace": trace}


def test_proof_equals_jax(recursion):
    """The port's CPU proof has the JAX package's SHA-256; with
    OPENVM_SLOW=1 the JAX package proves the instance again (about 30 s)."""
    assert hashlib.sha256(recursion["blob"]).hexdigest() == RECURSION_PROOF_SHA256
    jstark.verify(recursion["jpk"].vk, recursion["jproof"])
    if os.environ.get("OPENVM_SLOW"):
        trace = recursion["trace"]
        jproof = jstark.prove(recursion["jpk"], [jstark.AirProvingContext(
            air_id=0, common_main=trace, public_values=[0, 1, int(trace[-1, 1])])])
        assert jcodec.encode_proof(jproof) == recursion["blob"]


def test_program_challenger_equals_host():
    """Observes of constants and of hinted felts, samples across the
    output buffer's end, an extension sample, sampled bits and a grinding
    witness: each value the program executes equals the host
    challenger's over the same schedule."""
    rng = np.random.default_rng(SEED)
    consts = [int(v) for v in rng.integers(0, P, size=13)]
    hinted = [int(v) for v in rng.integers(0, P, size=19)]
    b, host = Builder(), DuplexChallenger()
    ch = ProgramChallenger(b)
    arr = b.read_vec(len(hinted))
    outs, want = [], []
    for v in consts[:5]:
        ch.observe(v)
        host.observe(v)
    outs.append(ch.sample())
    want.append(host.sample())
    ch.observe_arr(arr)
    host.observe_slice(hinted)
    e = ch.sample_ext()
    outs += [e.felt(i) for i in range(4)]
    want += list(host.sample_ext())
    for _ in range(9):  # past the 8 samples of one duplexing
        outs.append(ch.sample())
        want.append(host.sample())
    for v in consts[5:]:  # exactly one rate's worth: a duplex, no pending
        ch.observe(v)
        host.observe(v)
    outs.append(bits_to_index(b, ch.sample_bits(20), 20))
    want.append(host.sample_bits(20))
    witness = host.clone().grind(4)
    ch.check_witness(4, witness)
    assert host.check_witness(4, witness)
    outs.append(ch.sample())
    want.append(host.sample())
    for k, felt in enumerate(outs):
        b.public_value(felt, k)
    b.halt(0)
    exe = b.compile()
    pre = PreflightInterpreter(exe, 32).execute(inputs=[hinted])
    assert pre.exit_code == 0
    got = [pre.touched.get((3, k), [0])[0] for k in range(len(outs))]
    assert got == want
    # a witness that does not grind ends in the fail block
    b2 = Builder()
    ch2 = ProgramChallenger(b2)
    for v in consts[:5]:
        ch2.observe(v)
    bad = next(w for w in range(1, 64) if not _checks(consts[:5], 4, w))
    ch2.check_witness(4, bad)
    b2.halt(0)
    assert PreflightInterpreter(b2.compile(), 32).execute().exit_code != 0


def _checks(observed, bits, witness) -> bool:
    host = DuplexChallenger()
    host.observe_slice(observed)
    return host.check_witness(bits, witness)


def test_verifier_program_equals_jax(recursion):
    """build_verifier_program(expose="commit") is JAX's word for word
    with PERM_POS2's e masked: 2,433 instructions, 13 of them
    PERM_POS2."""
    n = assert_programs_equal(recursion["exe"], recursion["jexe"])
    assert recursion["meta"] == recursion["jmeta"] == {"num_insns": 2433}
    assert n == 13


def test_serialize_equals_jax(recursion):
    """One blob, decoded by each package's codec, serialises to the same
    hint stream."""
    ours = serialize_proof_felts(recursion["pk"].vk, recursion["proof"])
    theirs = jvp.serialize_proof_felts(recursion["jpk"].vk, recursion["jproof"])
    assert ours == theirs
    assert all(isinstance(v, int) and 0 <= v < P for vec in ours for v in vec)


def test_preflight_equals_jax(recursion):
    """The port's preflight of its program accepts the proof and exposes
    the common-main commitment; its records and touched words equal the
    JAX preflight's of JAX's program.  It counts and times its host
    permutations: the 13 PERM_POS2 and the VERIFY_BATCH openings' 104."""
    hints = serialize_proof_felts(recursion["pk"].vk, recursion["proof"])
    pre = PreflightInterpreter(recursion["exe"], 32).execute(inputs=hints)
    jpre = JaxPreflight(recursion["jexe"], 32).execute(inputs=hints)
    assert pre.exit_code == jpre.exit_code == 0
    assert pre.instret == jpre.instret == 2297
    assert len(pre.records["native_poseidon2"]["pc"]) == 13
    assert pre.host_perms == 117 and pre.host_perm_s > 0
    exposed = [pre.touched.get((3, k), [0])[0] for k in range(8)]
    assert exposed == [int(v) for v in recursion["proof"].commitments.main_trace[-1]]
    assert pre.touched == jpre.touched
    assert pre.exec_counts == jpre.exec_counts
    assert set(pre.records) == set(jpre.records)
    for chip, cols in pre.records.items():
        assert set(cols) == set(jpre.records[chip]), chip
        for col, v in cols.items():
            assert np.array_equal(np.asarray(v), np.asarray(jpre.records[chip][col])), \
                (chip, col)


def _tamper_opening(proof):
    row = [list(map(int, v)) for v in proof.opening.values.main[0][0].local]
    row[0][0] = (row[0][0] + 1) % P
    proof.opening.values.main[0][0].local = row


def _tamper_quotient_commit(proof):
    q = [int(v) for v in np.asarray(proof.commitments.quotient)]
    q[0] = (q[0] + 1) % P
    proof.commitments.quotient = np.asarray(q, dtype=np.uint64)


def _tamper_public_value(proof):
    pvs = [int(v) for v in proof.per_air[0].public_values]
    pvs[2] = (pvs[2] + 1) % P
    proof.per_air[0].public_values = pvs


@pytest.mark.parametrize("tamper", [_tamper_opening, _tamper_quotient_commit,
                                    _tamper_public_value],
                         ids=["opening", "quotient_commit", "public_value"])
def test_tampered_proof_rejected(recursion, tamper):
    bad = copy.deepcopy(recursion["proof"])
    tamper(bad)
    with pytest.raises(stark.VerificationError):
        stark.verify(recursion["pk"].vk, bad)
    assert rejects(recursion["exe"], serialize_proof_felts(recursion["pk"].vk, bad))


def test_static_height_profile_equals_jax(recursion):
    base = {"program": 1 << 13, "native_field_arithmetic": 1 << 9}
    for kwargs in ({}, {"base_heights": base}):
        ours = static_height_profile(recursion["exe"], **kwargs)
        assert ours == jvp.static_height_profile(recursion["jexe"], **kwargs)
    assert ours["program"] == 1 << 13 and ours["native_field_arithmetic"] == 2048
