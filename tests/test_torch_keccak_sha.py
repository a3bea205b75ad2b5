"""The port's keccak256 and sha256 extensions against openvm_tpu's, without a
prove: the host hashes, the transpiled custom-0 words, the preflight records
and each of the four AIRs' traces, and the plain quotient interpreter on
sha256's two programs.

Each guest's words are transpiled by both packages and run through the JAX
package's ``PreflightInterpreter`` and the port's (its Python loop and its
C++ core, which yields the two hash opcodes to the loop): keccak at lengths
0 to 300 around its 136-byte rate, sha256 at the padding boundaries of
tests/test_vm_sha256.py:79, each aligned and with an unaligned source and
digest pointer.  The records, and the traces the AIRs make of them, must be
equal word for word.  The sha256 AIRs' DAGs are built by the port's keygen
path and by the JAX package's; the port's plain quotient of each over a
random 2-row trace equals the JAX package's HostOps (as
tests/test_torch_quotient.py does for keccakf).  No JAX keygen and no XLA
compile: the whole file takes a few seconds.
"""

import dataclasses
import functools
import hashlib

import numpy as np
import pytest
import torch

from openvm_tpu.stark.logup import append_logup_constraints as jax_append_logup
from openvm_tpu.stark.symbolic import AirBuilder as JaxAirBuilder
from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu.vm import transpiler as jtranspiler
from openvm_tpu.vm.circuit import keccak as jkeccak
from openvm_tpu.vm.circuit import sha256 as jsha
from openvm_tpu.vm.instructions import Program as JaxProgram
from openvm_tpu.vm.instructions import VmExe as JaxVmExe
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import quotient
from openvm_tpu_torch.stark.logup import append_logup_constraints
from openvm_tpu_torch.stark.symbolic import AirBuilder, SymbolicDag
from openvm_tpu_torch.vm import guest
from openvm_tpu_torch.vm.circuit import keccak, sha256
from openvm_tpu_torch.vm.guest import (DST, SRC, TERMINATE, asm_i, asm_s,
                                       hint_inputs, keccak_r, reveal, sha_r)
from openvm_tpu_torch.vm.instructions import Program, VmExe
from openvm_tpu_torch.vm.native import NativeVmHandle
from openvm_tpu_torch.vm.preflight import PreflightInterpreter
from openvm_tpu_torch.vm.transpiler import Transpiler

from test_torch_quotient import _host_ops_quotient, _lde
from test_vm_keccak import build_keccak_program as jax_build_keccak_program
from test_vm_sha256 import build_sha_program as jax_build_sha_program

torch.set_num_threads(1)

P = bb.P
KECCAK_LENGTHS = [0, 1, 100, 135, 136, 137, 272, 300]
SHA_LENGTHS = [55, 56, 60, 64, 120, 130]
# (source offset, digest offset) from SRC and DST
OFFSETS = [(0, 0), (3, 2)]
CHIPS = {"keccak": ("keccak_sponge", "keccakf"), "sha256": ("sha256_sponge", "sha256")}


def hash_words(kind, n_bytes, src_off, dst_off):
    """A guest that hashes n_bytes of hinted input at SRC + src_off into
    DST + dst_off.  The words at DST and DST + 32 hold a sentinel first, so
    an unaligned digest's edge bytes are real; digest word 1 is revealed."""
    return guest.hinted_input_words(src_off + n_bytes) + [
        (0x12345 << 12) | (2 << 7) | 0x37,     # lui  x2, 0x12345
        asm_i(0x13, 2, 2, 0x678, 0),           # addi x2, x2, 0x678
        asm_s(2, 0, 2, DST),
        asm_s(2, 0, 2, DST + 32),
        asm_i(0x13, 5, 0, DST + dst_off, 0),
        asm_i(0x13, 6, 0, SRC + src_off, 0),
        asm_i(0x13, 7, 0, n_bytes, 0),
        (keccak_r if kind == "keccak" else sha_r)(5, 6, 7),
        asm_i(0x03, 8, 0, DST + 4, 2),         # lw x8, DST+4(x0)
        reveal(8, 0, 0),
        TERMINATE,
    ]


def data_of(n_bytes):
    return bytes((7 * i + 3) & 0xFF for i in range(n_bytes))


def fields(insns):
    return [dataclasses.astuple(i) for i in insns]


def both_exes(words):
    ours = Program(instructions=Transpiler().transpile(words), pc_base=0)
    theirs = JaxProgram(instructions=jtranspiler.Transpiler().transpile(words),
                        pc_base=0)
    return VmExe(program=ours, pc_start=0), JaxVmExe(program=theirs, pc_start=0)


def assert_records_equal(ours, theirs):
    assert sorted(ours) == sorted(theirs)
    for chip, cols in theirs.items():
        assert sorted(ours[chip]) == sorted(cols), chip
        for col, v in cols.items():
            assert np.array_equal(np.asarray(ours[chip][col], dtype=np.uint64),
                                  np.asarray(v, dtype=np.uint64)), (chip, col)


# ---------------------------------------------------------------------------
# host hashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 3, 135, 136, 137, 300])
def test_host_keccak256_equals_jax(n):
    data = data_of(n)
    assert keccak.keccak256(data) == jkeccak.keccak256(data)
    assert keccak.pad_blocks(data) == jkeccak.pad_blocks(data)


def test_host_keccak256_vectors():
    assert keccak.keccak256(b"").hex() == ("c5d2460186f7233c927e7db2dcc703c0"
                                           "e500b653ca82273b7bfad8045d85a470")
    assert keccak.keccak256(b"abc").hex() == ("4e03657aea45a94fc7d47ba826c8d667"
                                              "c0d1e6e33a64a036ec44f58fa12d6c45")


@pytest.mark.parametrize("n", [0, 3, 55, 56, 64, 200])
def test_host_sha256_equals_hashlib_and_jax(n):
    data = data_of(n)
    assert sha256.sha256(data) == hashlib.sha256(data).digest() == jsha.sha256(data)


# ---------------------------------------------------------------------------
# transpiler
# ---------------------------------------------------------------------------

def test_custom0_words_transpile_as_jax():
    """KECCAK256 and SHA256 words over register triples, and the funct7
    values of funct3 0b100 that neither claims (unimp in both packages)."""
    words = [(f7 << 25) | (rs2 << 20) | (rs1 << 15) | (0b100 << 12) | (rd << 7) | 0x0B
             for f7 in (0, 1, 2, 64)
             for rd, rs1, rs2 in ((5, 6, 7), (0, 31, 1), (31, 0, 0))]
    ours = Transpiler().transpile(words)
    assert fields(ours) == fields(jtranspiler.Transpiler().transpile(words))
    assert {i.opcode for i in ours} >= {0x310, 0x320}


def test_guests_transpile_as_jax():
    """The port's copies of the tests' guests, and the iterated guests'
    words through both transpilers."""
    for n in (0, 100, 300):
        assert fields(guest.build_keccak_program(n).program.instructions) == \
            fields(jax_build_keccak_program(n).program.instructions)
        assert fields(guest.build_sha_program(n).program.instructions) == \
            fields(jax_build_sha_program(n).program.instructions)
    for kind in ("keccak", "sha256"):
        for n in (1, 2047, 2048, 30_000):
            words = guest.iter_words(kind, n)
            ours = (guest.build_keccak_iter_program if kind == "keccak"
                    else guest.build_sha256_iter_program)(n)
            assert fields(ours.program.instructions) == \
                fields(jtranspiler.Transpiler().transpile(words))


# ---------------------------------------------------------------------------
# preflight records and traces
# ---------------------------------------------------------------------------

CASES = ([("keccak", n, off) for n in KECCAK_LENGTHS for off in OFFSETS]
         + [("sha256", n, off) for n in SHA_LENGTHS for off in OFFSETS])
AIRS = {"keccak_sponge": (keccak.KeccakVmAir, jkeccak.KeccakVmAir),
        "keccakf": (keccak.KeccakfAir, jkeccak.KeccakfAir),
        "sha256_sponge": (sha256.Sha256VmAir, jsha.Sha256VmAir),
        "sha256": (sha256.Sha256Air, jsha.Sha256Air)}


@functools.lru_cache(maxsize=None)
def preflights(kind, n, offsets):
    """The case's guest through the JAX package's preflight and the
    port's Python loop and C++ core."""
    src_off, dst_off = offsets
    exe, jexe = both_exes(hash_words(kind, n, src_off, dst_off))
    assert fields(exe.program.instructions) == fields(jexe.program.instructions)
    inputs = hint_inputs(bytes(src_off) + data_of(n))
    return (JaxPreflight(jexe).execute(inputs), PreflightInterpreter(exe).execute(inputs),
            PreflightInterpreter(exe).execute(inputs, nvm=NativeVmHandle(exe)))


@pytest.mark.parametrize("kind,n,offsets", CASES,
                         ids=[f"{k}-{n}-{s}.{d}" for k, n, (s, d) in CASES])
def test_preflight_records_equal_jax(kind, n, offsets):
    theirs, python, native = preflights(kind, n, offsets)
    for ours in (python, native):
        assert_records_equal(ours.records, theirs.records)
        assert ours.touched == theirs.touched
        assert ours.public_values == theirs.public_values
        assert (ours.instret, ours.final_ts, ours.exit_code) == \
            (theirs.instret, theirs.final_ts, theirs.exit_code) and ours.exit_code == 0
    data, dst_off = data_of(n), offsets[1]
    digest = (keccak.keccak256 if kind == "keccak" else sha256.sha256)(data)
    word = 0x12345678.to_bytes(4, "little")
    window = word[:dst_off] + digest + word[dst_off:]
    assert python.public_values[:4] == list(window[4:8])
    blocks = n // 136 + 1 if kind == "keccak" else (n + 9 + 63) // 64
    assert len(python.records[CHIPS[kind][0]]["pc"]) == blocks


@pytest.mark.parametrize("name", list(AIRS))
def test_trace_equals_jax(name):
    """The AIR's trace of every case's records at once (each case's rows
    in turn)."""
    kind = "keccak" if name.startswith("keccak") else "sha256"
    cases = [preflights(k, n, off) for k, n, off in CASES if k == kind]
    recs = [{c: np.concatenate([np.asarray(case[i].records[name][c]) for case in cases])
             for c in cases[0][i].records[name]} for i in (0, 1)]
    air, jair = AIRS[name]
    ours, want = air().trace(recs[1]), jair().trace(recs[0])
    assert ours.dtype == want.dtype and np.array_equal(ours, want)
    assert ours.shape[1] == air().width


@pytest.mark.parametrize("kind", ["keccak", "sha256"])
def test_padding_permutations_equal_jax(kind):
    """The round tables' padding rows: one block pads keccakf's 24 rows to
    32 and sha256's 64 rows stay 64; three blocks pad to 128 and 256 rows,
    with real permutations of the zero state at multiplicity 0."""
    sponge, table = CHIPS[kind]
    n = 300 if kind == "keccak" else 130
    exe, jexe = both_exes(hash_words(kind, n, 0, 0))
    inputs = hint_inputs(data_of(n))
    rec = PreflightInterpreter(exe).execute(inputs).records[table]
    jrec = JaxPreflight(jexe).execute(inputs).records[table]
    mod, jmod = (keccak, jkeccak) if kind == "keccak" else (sha256, jsha)
    air = (mod.KeccakfAir if kind == "keccak" else mod.Sha256Air)()
    jair = (jmod.KeccakfAir if kind == "keccak" else jmod.Sha256Air)()
    for k in (1, 3):
        part = {c: np.asarray(v)[:k] for c, v in rec.items()}
        jpart = {c: np.asarray(v)[:k] for c, v in jrec.items()}
        ours, want = air.trace(part), jair.trace(jpart)
        assert np.array_equal(ours, want)
        rows = 24 if kind == "keccak" else 64
        assert len(ours) == 1 << (k * rows - 1).bit_length()
        if k == 3:
            assert ours[k * rows:].any()  # real permutations, not zeros


# ---------------------------------------------------------------------------
# the plain quotient interpreter on sha256's programs
# ---------------------------------------------------------------------------

def _dags(name):
    """The port's DAG of the AIR as its keygen builds it, and the JAX
    package's (AirBuilder + append_logup_constraints at degree 3)."""
    air = sha256.SHA256_AIRS[name]()
    builder = AirBuilder(air)
    air.eval(builder)
    append_logup_constraints(builder, 3)
    jair = jsha.SHA256_AIRS[name]()
    jbuilder = JaxAirBuilder(jair)
    jair.eval(jbuilder)
    jax_append_logup(jbuilder, 3)
    return air, SymbolicDag.from_builder(builder), jair, JaxDag.from_builder(jbuilder)


@pytest.mark.parametrize("name", ["sha256", "sha256_sponge"])
def test_sha256_quotient_plain_equals_host_ops(name):
    air, dag, jair, jdag = _dags(name)
    assert dag.nodes == jdag.nodes and dag.constraint_roots == jdag.constraint_roots
    assert [tuple(map(str, i)) for i in dag.interactions] == \
        [tuple(map(str, i)) for i in jdag.interactions]
    prog = quotient.compile_dag_code(dag, n_main=1, has_preprocessed=False,
                                     has_perm=bool(dag.interactions))
    rng = np.random.default_rng(11)
    log_n, lqd = 1, 1
    nq = 1 << (log_n + lqd)
    n_perm = 4 * (1 + max(n[4] for n in dag.nodes
                          if n[0] == "var" and n[1] == "permutation"))
    n_pub = 1 + max((n[4] for n in dag.nodes if n[0] == "var" and n[1] == "public"),
                    default=-1)
    canon = {"main": [rng.integers(0, P, size=(nq, air.width), dtype=np.uint64)],
             "perm": rng.integers(0, P, size=(nq, n_perm), dtype=np.uint64),
             "publics": rng.integers(0, P, size=n_pub, dtype=np.uint64),
             "challenges": rng.integers(0, P, size=(2, 4), dtype=np.uint64),
             "exposed": rng.integers(0, P, size=(1, 4), dtype=np.uint64),
             "alpha": rng.integers(0, P, size=4, dtype=np.uint64)}
    bound = quotient.bind(prog, publics=bb.to_monty_np(canon["publics"]),
                          challenges=bb.to_monty_np(canon["challenges"]),
                          exposed=bb.to_monty_np(canon["exposed"]),
                          alpha=bb.to_monty_np(canon["alpha"]))
    got = quotient.evaluate_plain(
        bound, [_lde(bb.to_monty_np(m)) for m in canon["main"] + [canon["perm"]]],
        log_n, lqd)
    want = _host_ops_quotient(jair, jdag, canon, log_n, lqd)
    np.testing.assert_array_equal(bb.to_numpy(bb.from_monty_plain(got)).astype(np.uint64),
                                  want)
