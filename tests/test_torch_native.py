"""The port's native (recursion) VM against openvm_tpu's, without a prove:
the Builder's instructions, the path-10 guest carried into the JAX
package's instructions, the preflight's records, touched words and public
values, every native AIR's trace and constraints, the tamper cases of
tests/test_native_fri_verify_batch.py and the execution errors.

The programs are build_native_program (tests/test_native_vm.py:35), the
FRI_REDUCED_OPENING and VERIFY_BATCH programs of
tests/test_native_fri_verify_batch.py (built by each package's Builder)
and small path-10 guests, build_native_query_program(2, 4, 3, seed) and
(3, 5, 4, seed).  JAX runs only its preflight, its numpy tracegen and its
symbolic builder here; the CPU proof is in tests/test_torch_native_proof.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from openvm_tpu.native_compiler.builder import Builder as JaxBuilder
from openvm_tpu.stark.logup import append_logup_constraints as jax_append_logup
from openvm_tpu.stark.symbolic import AirBuilder as JaxAirBuilder
from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu.vm.circuit import native as jnative
from openvm_tpu.vm.instructions import Instruction as JaxInstruction
from openvm_tpu.vm.instructions import Program as JaxProgram
from openvm_tpu.vm.instructions import VmExe as JaxVmExe
from openvm_tpu.vm.interpreter import ExecutionError as JaxExecutionError
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch.native_compiler import Builder
from openvm_tpu_torch.stark.logup import append_logup_constraints
from openvm_tpu_torch.stark.symbolic import AirBuilder, SymbolicDag
from openvm_tpu_torch.vm import guest
from openvm_tpu_torch.vm.circuit import native
from openvm_tpu_torch.vm.instructions import (FieldArithmeticOpcode as FA,
                                              FieldExtensionOpcode as FE,
                                              Instruction, Poseidon2Opcode, Program,
                                              SystemOpcode, VmExe)
from openvm_tpu_torch.vm.interpreter import ExecutionError
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

import test_native_fri_verify_batch as jfv
from test_native_vm import build_native_program as jax_build_native_program
from test_torch_keccak_sha import assert_records_equal, fields

torch.set_num_threads(1)

P = 2013265921
NUM_PVS = 16


def jax_exe(exe):
    """The port's executable as the JAX package's, field by field."""
    return JaxVmExe(program=JaxProgram(
        instructions=[JaxInstruction(*dataclasses.astuple(i))
                      for i in exe.program.instructions],
        pc_base=exe.program.pc_base), pc_start=exe.pc_start)


# ---------------------------------------------------------------------------
# the programs of tests/test_native_fri_verify_batch.py, built by either
# package's Builder
# ---------------------------------------------------------------------------

def fri_program(builder):
    """test_fri_reduced_opening_debug_checks: a reduced opening of length 5
    and one of length 1, each asserted."""
    b = builder()
    L = 5
    alpha = (3, 1, 0, 2)
    a_vals = [10 + t for t in range(L)]
    b_exts = [[(100 + 7 * t + k) % P for k in range(4)] for t in range(L)]
    a_arr, b_arr = b.array(L), b.array(4 * L)
    for t in range(L):
        b.mov(a_vals[t], a_arr.felt(t))
        for k in range(4):
            b.mov(b_exts[t][k], b_arr.felt(4 * t + k))
    res = b.fri_reduced_opening(a_arr, b_arr, L, b.econst(alpha))
    want = jfv._fri_expected(a_vals, b_exts, alpha)
    for k in range(4):
        b.assert_eq(res.felt(k), int(want[k]))
    res1 = b.fri_reduced_opening(a_arr, b_arr, 1, b.econst(alpha))
    w1 = jfv._fri_expected(a_vals[:1], b_exts[:1], alpha)
    for k in range(4):
        b.assert_eq(res1.felt(k), int(w1[k]))
    b.halt(0)
    return b.compile()


def fri_wrong_program(builder):
    """test_fri_reduced_opening_wrong_result_rejected: asserts a wrong
    reduced opening, so it ends in the fail block (exit code 1)."""
    b = builder()
    a_arr, b_arr = b.array(2), b.array(8)
    for t in range(2):
        b.mov(5 + t, a_arr.felt(t))
        for k in range(4):
            b.mov(50 + 4 * t + k, b_arr.felt(4 * t + k))
    res = b.fri_reduced_opening(a_arr, b_arr, 2, b.econst((2, 0, 0, 0)))
    want = jfv._fri_expected([5, 6], [[50, 51, 52, 53], [54, 55, 56, 57]], (2, 0, 0, 0))
    b.assert_eq(res.felt(0), (int(want[0]) + 1) % P)
    b.halt(0)
    return b.compile()


def vb_program(builder, tamper=None):
    """test_verify_batch_debug_checks (a depth-3 batch with segments at
    levels 0 and 2, and a depth-0 one) or, with ``tamper``, the depth-3
    batch of test_verify_batch_tampered_commit_rejected ("commit") or
    test_verify_batch_tampered_sibling_rejected ("sibling")."""
    seg0, seg2, sibs, bits, commit = jfv._build_vb_scenario()
    if tamper == "commit":
        commit = list(commit)
        commit[3] = (commit[3] + 1) % P
    if tamper == "sibling":
        sibs = [list(s) for s in sibs]
        sibs[1][0] = (sibs[1][0] + 1) % P
    b = builder()
    jfv._emit_vb(b, seg0, seg2, sibs, bits, commit)
    if tamper is None:
        a2 = b.array(3)
        for i, v in enumerate(seg2):
            b.mov(v, a2.felt(i))
        c0 = jfv._hash_seg(seg2)
        c0_arr = b.array(8)
        for k in range(8):
            b.mov(c0[k], c0_arr.felt(k))
        b.verify_batch(b.write_batch_descriptor({0: (a2.addr, 3)}, 0),
                       b.array(8), 0, c0_arr.addr, 0, inside_rows=1)
    b.halt(0)
    return b.compile()


BUILDER_PROGRAMS = {
    "fri": fri_program,
    "fri_wrong": fri_wrong_program,
    "verify_batch": vb_program,
    "verify_batch_bad_commit": functools.partial(vb_program, tamper="commit"),
    "verify_batch_bad_sibling": functools.partial(vb_program, tamper="sibling"),
}

QUERY_GUESTS = {f"query_guest_{'_'.join(map(str, args))}": args
                for args in ((2, 4, 3, 0), (3, 5, 4, 1))}

# (the port's executable, the JAX package's, the inputs)
PROGRAMS = {
    "native_program": lambda: (guest.build_native_program(), jax_build_native_program(),
                               guest.NATIVE_INPUTS),
    "fri": lambda: (fri_program(Builder), fri_program(JaxBuilder), None),
    "fri_wrong": lambda: (fri_wrong_program(Builder), fri_wrong_program(JaxBuilder), None),
    "verify_batch": lambda: (vb_program(Builder), vb_program(JaxBuilder), None),
    **{name: (lambda args=args: (
        guest.build_native_query_program(*args),
        jax_exe(guest.build_native_query_program(*args)),
        guest.native_query_stream(*args))) for name, args in QUERY_GUESTS.items()},
}


@functools.lru_cache(maxsize=None)
def preflights(name):
    """(the port's preflight result, the JAX package's) of a program."""
    ours, theirs, inputs = PROGRAMS[name]()
    return (PreflightInterpreter(ours, NUM_PVS).execute(inputs=inputs),
            JaxPreflight(theirs, NUM_PVS).execute(inputs=inputs))


@pytest.mark.parametrize("name", list(BUILDER_PROGRAMS))
def test_builder_emits_jax_instructions(name):
    """The port's Builder emits the JAX Builder's instructions, field by
    field, and the same entry point."""
    ours, theirs = BUILDER_PROGRAMS[name](Builder), BUILDER_PROGRAMS[name](JaxBuilder)
    assert fields(ours.program.instructions) == fields(theirs.program.instructions)
    assert (ours.pc_start, ours.program.pc_base) == (theirs.pc_start, theirs.program.pc_base)


def test_builder_permute_and_compress_name_address_space_4():
    """``permute`` and ``compress`` emit e = 4, the address space that
    NativePoseidon2Air's fetch names; the JAX Builder's emit e = 0 and
    differ in that field only."""
    out = []
    for builder in (Builder, JaxBuilder):
        b = builder()
        src = b.array(16)
        b.permute(src)
        b.compress(src.slice(0, 8), src.slice(8, 8))
        out.append(fields(b.insns))
    ours, theirs = out
    assert [i[0] for i in ours] == [Poseidon2Opcode.PERM_POS2, Poseidon2Opcode.COMP_POS2]
    assert [i[5] for i in ours] == [4, 4] and [i[5] for i in theirs] == [0, 0]
    assert [i[:5] + i[6:] for i in ours] == [i[:5] + i[6:] for i in theirs]


def test_query_guest_carries_into_jax_instructions():
    """The small path-10 guest's instructions carried into the JAX
    package's Instruction field by field; the loop is a runtime loop (the
    program's length does not grow with the queries) and the inputs follow
    the seed."""
    exe = guest.build_native_query_program(2, 4, 3, 0)
    jexe = jax_exe(exe)
    assert fields(jexe.program.instructions) == fields(exe.program.instructions)
    assert all(isinstance(i, JaxInstruction) for i in jexe.program.instructions)
    assert len(guest.build_native_query_program(5, 4, 3, 0).program.instructions) == \
        len(exe.program.instructions)
    assert guest.native_query_stream(2, 4, 3, 0) != guest.native_query_stream(2, 4, 3, 1)
    with pytest.raises(ValueError):
        guest.build_native_query_program(2, 4, 4, 0)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_preflight_equals_jax(name):
    """Records, touched words, initial words, public values, counts and
    the exit code through both preflights; the path-10 guests' public
    values, instructions, chip rows and Poseidon2 permutations equal their
    host reference."""
    ours, theirs = preflights(name)
    assert_records_equal(ours.records, theirs.records)
    assert ours.touched == theirs.touched and ours.init_words == theirs.init_words
    assert ours.public_values == theirs.public_values
    assert ours.exec_counts == theirs.exec_counts
    assert (ours.instret, ours.final_pc, ours.final_ts, ours.exit_code) == \
        (theirs.instret, theirs.final_pc, theirs.final_ts, theirs.exit_code)
    assert ours.exit_code == (1 if name == "fri_wrong" else 0)
    if name in QUERY_GUESTS:
        args = QUERY_GUESTS[name]
        pvs = [ours.touched[(3, k)][0] for k in range(8)]
        assert pvs == guest.native_query_reference(*args)
        rows = {k: len(next(iter(v.values()))) for k, v in ours.records.items()}
        counts = guest.native_query_counts(*args)
        assert {"insns": ours.instret, **rows} == {k: v for k, v in counts.items()
                                                  if k != "poseidon2"}
        assert set(rows) == set(native.NATIVE_EXECUTORS) | {"phantom"}
        vb, inside = native.VerifyBatchAir(), native.VerifyBatchInsideAir()
        perms = rows["native_poseidon2"] + sum(
            len(air.p2_requests(air.trace(ours.records[air.name]))) for air in (vb, inside))
        assert perms == counts["poseidon2"]
    if name == "native_program":
        assert ours.touched[(3, 0)][0] == 3


NATIVE_AIR_NAMES = list(native.NATIVE_AIRS)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_native_traces_equal_jax(name):
    """Every native AIR's trace (and NativePublicValuesAir's from the
    touched words) of a program's records equals the JAX package's: dtype,
    shape, words; an AIR the program leaves unused gets no records in
    either."""
    ours, theirs = preflights(name)
    for air_name in NATIVE_AIR_NAMES:
        rec, jrec = ours.records.get(air_name), theirs.records.get(air_name)
        assert (rec is None) == (jrec is None), air_name
        if rec is None:
            continue
        air, jair = native.NATIVE_AIRS[air_name](), jnative.NATIVE_AIRS[air_name]()
        got, want = air.trace(rec), jair.trace(jrec)
        assert got.dtype == want.dtype and np.array_equal(got, want), air_name
        assert got.shape[1] == air.width
    pv, jpv = native.NativePublicValuesAir(NUM_PVS), jnative.NativePublicValuesAir(NUM_PVS)
    assert np.array_equal(pv.trace(ours.touched), jpv.trace(theirs.touched))
    assert np.array_equal(pv.preprocessed_trace(), jpv.preprocessed_trace())


@pytest.mark.parametrize("name", NATIVE_AIR_NAMES + ["native_public_values"])
def test_native_constraints_equal_jax(name):
    """The AIR's DAG as the port's keygen builds it (AirBuilder, LogUp at
    degree 3) equals the JAX package's: nodes, roots and interactions; and
    its width is the JAX AIR's."""
    if name == "native_public_values":
        air, jair = native.NativePublicValuesAir(NUM_PVS), jnative.NativePublicValuesAir(NUM_PVS)
    else:
        air, jair = native.NATIVE_AIRS[name](), jnative.NATIVE_AIRS[name]()
    assert air.width == jair.width
    builder, jbuilder = AirBuilder(air), JaxAirBuilder(jair)
    air.eval(builder)
    jair.eval(jbuilder)
    append_logup_constraints(builder, 3)
    jax_append_logup(jbuilder, 3)
    dag, jdag = SymbolicDag.from_builder(builder), JaxDag.from_builder(jbuilder)
    assert dag.nodes == jdag.nodes and dag.constraint_roots == jdag.constraint_roots
    assert [tuple(map(str, i)) for i in dag.interactions] == \
        [tuple(map(str, i)) for i in jdag.interactions]


def _errors(ours, theirs, inputs=None):
    with pytest.raises(JaxExecutionError) as jerr:
        JaxPreflight(theirs, NUM_PVS).execute(inputs=inputs)
    with pytest.raises(ExecutionError) as err:
        PreflightInterpreter(ours, NUM_PVS).execute(inputs=inputs)
    assert str(err.value) == str(jerr.value)
    return str(err.value)


def _both(insns):
    exe = VmExe(program=Program(instructions=insns + [Instruction(SystemOpcode.TERMINATE)]),
                pc_start=0)
    return exe, jax_exe(exe)


ERRORS = {
    "verify_batch_bad_commit": (lambda: (vb_program(Builder, "commit"),
                                         vb_program(JaxBuilder, "commit")),
                                "VERIFY_BATCH commitment mismatch at pc"),
    "verify_batch_bad_sibling": (lambda: (vb_program(Builder, "sibling"),
                                          vb_program(JaxBuilder, "sibling")),
                                 "VERIFY_BATCH commitment mismatch at pc"),
    "felt_div_by_zero": (lambda: _both([Instruction(FA.DIV, a=1, b=3, c=0, d=4, e=0, f=0)]),
                         "felt div by zero at 0x0"),
    "felt_div_by_zero_cell": (lambda: _both([
        Instruction(FA.DIV, a=1, b=3, c=7, d=4, e=0, f=4)]), "felt div by zero at 0x0"),
    "ext_div_by_zero": (lambda: _both([
        Instruction(FA.ADD, a=20, b=5, c=0, d=4, e=0, f=0),
        Instruction(FE.BBE4DIV, a=28, b=20, c=24, d=4, e=4)]), "ext div by zero at 0x4"),
    "query_guest_bad_index": (lambda: _query_with_bad_index(), "RANGE_CHECK failed"),
}


def _query_with_bad_index():
    args = (2, 4, 3, 0)
    exe = guest.build_native_query_program(*args)
    stream = [list(v) for v in guest.native_query_stream(*args)]
    stream[1] = [1 << 4]  # the first query's index past 2^depth
    return exe, jax_exe(exe), stream


@pytest.mark.parametrize("case", list(ERRORS))
def test_rejections_equal_jax(case):
    """A wrong sibling or commitment in a VERIFY_BATCH, a felt division by
    zero (immediate and cell), an extension division by zero and a query
    index past the range check end in the JAX package's ExecutionError,
    word for word; a wrong reduced opening ends in the fail block in both
    (test_preflight_equals_jax's fri_wrong)."""
    make, start = ERRORS[case]
    assert _errors(*make()).startswith(start)
