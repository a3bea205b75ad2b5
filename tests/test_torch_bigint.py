"""The port's int256 and modular-arithmetic extensions against openvm_tpu's,
without a prove: the transpiled words, the preflight records, each new
AIR's constraints and trace, and the host helpers (``ExprBuilder``,
``modhints``, ``Encoder``).

The guests are tests/test_vm_bigint.py's (every int256 op over its
operands), tests/test_vm_modular.py's (add, sub, mul, div and is_eq over
secp256k1's prime) and a short ``build_u256_iter_program`` (sha256, every
int256 op, the six 256-bit branches and the modular ops over both of
secp256k1's moduli).  Each is transpiled by both packages and run through
the JAX package's ``PreflightInterpreter`` and the port's (its Python loop
and its C++ core, which yields the extension opcodes to the loop): the
records, and the traces the AIRs make of them, must be equal word for word;
under a metered cap of trace cells both cores suspend the u256 guest at
the same instruction.  No JAX keygen and no XLA compile.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from openvm_tpu.stark.logup import append_logup_constraints as jax_append_logup
from openvm_tpu.stark.symbolic import AirBuilder as JaxAirBuilder
from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu.vm import modhints as jmodhints
from openvm_tpu.vm import transpiler as jtranspiler
from openvm_tpu.vm.circuit import bigint as jbigint
from openvm_tpu.vm.circuit import encoder as jencoder
from openvm_tpu.vm.circuit import mod_builder as jmod_builder
from openvm_tpu.vm.circuit import modular as jmodular
from openvm_tpu.vm.instructions import Instruction as JaxInstruction
from openvm_tpu.vm.instructions import Program as JaxProgram
from openvm_tpu.vm.instructions import VmExe as JaxVmExe
from openvm_tpu.vm.interpreter import ExecutionError as JaxExecutionError
from openvm_tpu.vm.native import NativeVmHandle as JaxNativeVmHandle
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu.vm.preflight import SegmentCtx as JaxSegmentCtx
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark.logup import append_logup_constraints
from openvm_tpu_torch.stark.symbolic import AirBuilder, SymbolicDag
from openvm_tpu_torch.vm import guest, modhints
from openvm_tpu_torch.vm.circuit import bigint, encoder, mod_builder, modular
from openvm_tpu_torch.vm.guest import (A_VAL, B_VAL, MOD_A_VAL, MOD_B_VAL, TERMINATE,
                                       U256_MODULI, asm_i, hint_input_for, hint_storew,
                                       int256_r, modular_r, reveal)
from openvm_tpu_torch.vm.interpreter import ExecutionError
from openvm_tpu_torch.vm.native import NativeVmHandle
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine
from openvm_tpu_torch.vm.preflight import PreflightInterpreter, SegmentCtx
from openvm_tpu_torch.vm.transpiler import Transpiler

from test_torch_keccak_sha import assert_records_equal, fields
from test_vm_bigint import ALL_OPS
from test_vm_bigint import build_bigint_program as jax_build_bigint_program
from test_vm_modular import build_modular_program as jax_build_modular_program

torch.set_num_threads(1)

P = bb.P
U256_N = 2
BN254_P = int("21888242871839275222246405745257275088696311157297823662689037894645226208583")


def jax_u256_exe(items):
    """The JAX package's VmExe of ``guest.u256_iter_items``: its words
    through the JAX package's transpiler, each branch set as its
    instruction, as guest.u256_iter_program sets it."""
    words = [it if isinstance(it, int) else TERMINATE for it in items]
    insns = jtranspiler.Transpiler().transpile(words)
    for i, it in enumerate(items):
        if not isinstance(it, int):
            insns[i] = JaxInstruction(*dataclasses.astuple(it))
    return JaxVmExe(program=JaxProgram(instructions=insns, pc_base=0), pc_start=0)


# (the port's exe, the JAX package's, the input stream, the moduli)
GUESTS = {
    "bigint": lambda: (guest.build_bigint_program(ALL_OPS), jax_build_bigint_program(ALL_OPS),
                       hint_input_for(A_VAL, B_VAL), ()),
    "modular": lambda: (guest.build_modular_program(), jax_build_modular_program(),
                        hint_input_for(MOD_A_VAL, MOD_B_VAL), U256_MODULI[:1]),
    "u256": lambda: (guest.build_u256_iter_program(U256_N),
                     jax_u256_exe(guest.u256_iter_items(U256_N)[0]), None, U256_MODULI),
}


@functools.lru_cache(maxsize=None)
def preflights(name):
    """The guest through the JAX package's preflight and the port's Python
    loop and C++ core."""
    exe, jexe, inputs, moduli = GUESTS[name]()
    return (JaxPreflight(jexe, moduli=moduli).execute(inputs),
            PreflightInterpreter(exe, moduli=moduli).execute(inputs),
            PreflightInterpreter(exe, moduli=moduli).execute(inputs, nvm=NativeVmHandle(exe)))


# ---------------------------------------------------------------------------
# transpiler
# ---------------------------------------------------------------------------

def test_guests_transpile_as_jax():
    """The port's copies of the tests' guests, and the u256 guest's words
    (its branches set as instructions in both), through both transpilers;
    every int256 funct7, BEQ256 and every modular base funct7 over two
    modulus indices and rd = 0 (SETUP and rd = 0 to nop but DIV, the two
    hints to phantoms) as the JAX package transpiles them."""
    for name in GUESTS:
        exe, jexe, _, _ = GUESTS[name]()
        assert fields(exe.program.instructions) == fields(jexe.program.instructions), name
    words = [int256_r(f7, rd, 1, 2) for f7 in range(12) for rd in (0, 3)]
    words += [guest.beq256(1, 2, imm) for imm in (8, -8, 4094)]
    words += [modular_r(f7, rd, 1, 2, k) for f7 in range(8) for rd in (0, 28) for k in (0, 1)]
    ours = Transpiler().transpile(words)
    assert fields(ours) == fields(jtranspiler.Transpiler().transpile(words))
    assert {i.opcode for i in ours} >= {0x400, 0x405, 0x408, 0x420, 0x450, 0x500, 0x506, 0x50c}


# ---------------------------------------------------------------------------
# preflight records and traces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(GUESTS))
def test_preflight_records_equal_jax(name):
    theirs, python, native = preflights(name)
    for ours in (python, native):
        assert_records_equal(ours.records, theirs.records)
        assert ours.touched == theirs.touched
        assert ours.public_values == theirs.public_values
        assert (ours.instret, ours.final_ts, ours.exit_code) == \
            (theirs.instret, theirs.final_ts, theirs.exit_code) and ours.exit_code == 0
    if name == "u256":
        counts = guest.u256_iter_counts(U256_N)
        assert python.public_values == guest.u256_iter_reference(U256_N)
        assert python.instret == counts["insns"]
        rows = {k: len(next(iter(v.values()))) for k, v in python.records.items()}
        assert sum(rows[k] for k in rows if k.startswith("int256_")) == counts["int256_ops"]
        assert sum(rows[k] for k in rows if k.startswith("modular_")) == counts["modular_ops"]
        assert rows["sha256_sponge"] == counts["sha256_blocks"]


def test_branch_targets_equal_jax():
    """The u256 guest's six 256-bit branches over enough iterations that
    each is taken and not taken: the same next pc in both packages."""
    n = 24
    exe = guest.build_u256_iter_program(n)
    jexe = jax_u256_exe(guest.u256_iter_items(n)[0])
    ours = PreflightInterpreter(exe, moduli=U256_MODULI).execute().records
    theirs = JaxPreflight(jexe, moduli=U256_MODULI).execute().records
    for chip, air in (("int256_beq", bigint.BranchEq256Air()),
                      ("int256_blt", bigint.BranchLt256Air())):
        assert_records_equal({chip: ours[chip]}, {chip: theirs[chip]})
        taken = air.trace(ours[chip])[:len(ours[chip]["pc"]), air.c.index["taken"]]
        for op in range(len(air.OPS)):
            seen = set(taken[ours[chip]["op_idx"] == op].tolist())
            assert seen == {0, 1}, (chip, op)


def test_modular_opcode_without_moduli_ends_as_jax():
    """A modular opcode in a config with no moduli, or past its moduli,
    falls through the handler's guard in both packages to the same
    ExecutionError."""
    exe, jexe, inputs, _ = GUESTS["modular"]()
    with pytest.raises(JaxExecutionError) as theirs:
        JaxPreflight(jexe).execute(inputs)
    with pytest.raises(ExecutionError) as ours:
        PreflightInterpreter(exe).execute(inputs)
    assert str(ours.value) == str(theirs.value) == "opcode 0x500 has no circuit support yet"
    words = [modular_r(guest.ADD_F7, 3, 1, 2, 1), TERMINATE]
    prog = guest._program(words)
    jprog = JaxVmExe(program=JaxProgram(instructions=jtranspiler.Transpiler().transpile(words),
                                        pc_base=0), pc_start=0)
    with pytest.raises(JaxExecutionError) as theirs:
        JaxPreflight(jprog, moduli=U256_MODULI[:1]).execute()
    with pytest.raises(ExecutionError) as ours:
        PreflightInterpreter(prog, moduli=U256_MODULI[:1]).execute()
    assert str(ours.value) == str(theirs.value) == "opcode 0x508 has no circuit support yet"


@pytest.mark.parametrize("k", [0, 1])
def test_modular_hint_phantoms_equal_jax(k):
    """HintSqrt of a square and of a non-square and HintNonQr fill the hint
    stream as the JAX package's do; the guest stores what it got."""
    m = U256_MODULI[k]
    x_sq = pow(MOD_A_VAL, 2, m)
    words = guest._operand_words()                           # x1 = &x_sq, x2 = &7
    for reg, dst in ((1, 0x200), (2, 0x240)):
        words += [modular_r(7, 0, reg, 0, k)]                # HintSqrt [reg]
        for w in range(9):
            words += [asm_i(0x13, 5, 0, dst + 4 * w, 0), hint_storew(5)]
    words += [modular_r(6, 0, 0, 0, k)]                      # HintNonQr
    for w in range(8):
        words += [asm_i(0x13, 5, 0, 0x300 + 4 * w, 0), hint_storew(5)]
    words += [asm_i(0x03, 6, 0, 0x204, 2), reveal(6, 0, 0), TERMINATE]
    exe = guest._program(words)
    jexe = JaxVmExe(program=JaxProgram(instructions=jtranspiler.Transpiler().transpile(words),
                                       pc_base=0), pc_start=0)
    inputs = hint_input_for(x_sq, 7)
    theirs = JaxPreflight(jexe, moduli=U256_MODULI).execute(inputs)
    runs = (PreflightInterpreter(exe, moduli=U256_MODULI).execute(inputs),
            PreflightInterpreter(exe, moduli=U256_MODULI).execute(
                inputs, nvm=NativeVmHandle(exe)))
    for ours in runs:
        assert_records_equal(ours.records, theirs.records)
        assert ours.touched == theirs.touched and ours.exit_code == 0

    def block(addr, words_):
        return int.from_bytes(bytes(b for w in range(words_)
                                    for b in runs[0].touched[(2, addr // 4 + w)][:4]), "little")

    for x, dst in ((x_sq, 0x200), (7, 0x240)):
        ok, root = modhints.sqrt_hint(x, m)
        assert block(dst, 1) == int(ok) and block(dst + 4, 8) == root
        assert pow(root, 2, m) == (x if ok else x * modhints.find_non_qr(m) % m)
    assert block(0x200, 1) == 1 and block(0x300, 8) == modhints.find_non_qr(m)


@pytest.mark.parametrize("max_cells", [60_000, 150_000])
def test_metered_boundary_equals_jax(max_cells):
    """Metered segmentation counts the int256, modular and sha256 chips'
    rows on the Python side (``py_stats`` over ``SegmentCtx``) as the JAX
    package's does: with the same widths and interaction counts and a cap
    of trace cells, both packages' C++ cores suspend the u256 guest at the
    same instruction with the same records."""
    n = 12
    exe = guest.build_u256_iter_program(n)
    jexe = jax_u256_exe(guest.u256_iter_items(n)[0])
    vm = VirtualMachine(Rv32Config(executors=guest.FIB_EXECUTORS, sha256=True, bigint=True,
                                   moduli=U256_MODULI), device="cpu")
    widths = {a.name: a.width for a in vm.airs}
    inters = {}
    for air in vm.airs:
        builder = AirBuilder(air)
        air.eval(builder)
        inters[air.name] = len(builder.interactions)
    runs = []
    for handle, interp, ctx in ((NativeVmHandle, PreflightInterpreter, SegmentCtx),
                                (JaxNativeVmHandle, JaxPreflight, JaxSegmentCtx)):
        nvm = handle(exe if handle is NativeVmHandle else jexe)
        nvm.set_mode(False)
        nvm.set_limits(max_height=1 << 20, max_cells=max_cells, max_interactions=P,
                       ts_delta=-1, check_insns=50, widths=widths, inters=inters)
        runs.append(interp(exe if handle is NativeVmHandle else jexe,
                           moduli=U256_MODULI).execute(
            nvm=nvm, seg_ctx=ctx(widths=widths, inters=inters)))
    ours, theirs = runs
    assert ours.segment_full and theirs.segment_full
    assert (ours.instret, ours.final_pc, ours.final_ts) == \
        (theirs.instret, theirs.final_pc, theirs.final_ts)
    assert 0 < ours.instret < guest.u256_iter_counts(n)["insns"]
    assert_records_equal(ours.records, theirs.records)


def _airs(name):
    """The port's AIR of that name and the JAX package's."""
    if name.startswith("int256_"):
        return bigint.INT256_AIRS[name](), jbigint.INT256_AIRS[name]()
    return modular.modular_airs(U256_MODULI)[name], jmodular.modular_airs(U256_MODULI)[name]


NEW_AIRS = list(bigint.INT256_AIRS) + [f"modular_{kind}_{k}" for k in (0, 1)
                                       for kind in ("addsub", "muldiv", "iseq")]


@pytest.mark.parametrize("name", NEW_AIRS)
def test_trace_equals_jax(name):
    """The AIR's trace of the records of every guest that uses it, each
    guest's rows in turn, and its width and padded height."""
    runs = [preflights(g) for g in GUESTS if name in preflights(g)[0].records]
    assert runs
    recs = [{c: np.concatenate([np.asarray(run[i].records[name][c]) for run in runs])
             for c in runs[0][i].records[name]} for i in (0, 1)]
    air, jair = _airs(name)
    ours, want = air.trace(recs[1]), jair.trace(recs[0])
    assert ours.dtype == want.dtype and np.array_equal(ours, want)
    assert ours.shape == (1 << (len(recs[1]["pc"]) - 1).bit_length(), air.width)
    assert ours[:len(recs[1]["pc"]), 0].all()  # is_valid on every real row


@pytest.mark.parametrize("name", NEW_AIRS)
def test_constraints_equal_jax(name):
    """The AIR's DAG as the port's keygen builds it (AirBuilder, LogUp at
    degree 3) equals the JAX package's: nodes (the modulus' limbs and the
    mod-builder's offsets among the constants), roots and interactions."""
    air, jair = _airs(name)
    builder, jbuilder = AirBuilder(air), JaxAirBuilder(jair)
    air.eval(builder)
    jair.eval(jbuilder)
    append_logup_constraints(builder, 3)
    jax_append_logup(jbuilder, 3)
    dag, jdag = SymbolicDag.from_builder(builder), JaxDag.from_builder(jbuilder)
    assert dag.nodes == jdag.nodes and dag.constraint_roots == jdag.constraint_roots
    assert [tuple(map(str, i)) for i in dag.interactions] == \
        [tuple(map(str, i)) for i in jdag.interactions]


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

def _builders(modulus, which):
    """A ModularMulDivAir- or ModularAddSubAir-shaped ExprBuilder in both
    packages."""
    out = []
    for mb in (mod_builder, jmod_builder):
        eb = mb.ExprBuilder(modulus, 32)
        x, y = eb.input(), eb.input()
        f0, f1 = eb.flag(), eb.flag()
        if which == "muldiv":
            z = eb.new_var()
            eb.constrain_zero((x * y - z).flag_mul(f0) + (z * y - x).flag_mul(f1))
        else:
            eb.save((x + y).flag_mul(f0) + (x - y).flag_mul(f1))
        out.append(eb)
    return out


@pytest.mark.parametrize("modulus", [U256_MODULI[0], U256_MODULI[1], BN254_P])
def test_expr_builder_fill_equals_jax(modulus):
    """Seeded operands below the modulus (and a zero), both flags: the
    compiled equations' layout and ``fill``'s witness columns are equal."""
    rng = np.random.default_rng(modulus % 1000)
    n = 16
    xs = [int.from_bytes(rng.bytes(32), "little") % modulus for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(32), "little") % modulus or 1 for _ in range(n)]
    xs[0] = 0
    f0 = (np.arange(n) % 2).astype(np.uint64)
    flags = [f0, 1 - f0]
    limbs = [np.asarray([mod_builder.int_to_limbs(v, 32) for v in vals], dtype=np.uint64)
             for vals in (xs, ys)]
    for which in ("muldiv", "addsub"):
        ours, theirs = _builders(modulus, which)
        assert [dataclasses.astuple(e)[1:] for e in ours.eqs] == \
            [dataclasses.astuple(e)[1:] for e in theirs.eqs]
        assert ours.aux_width() == theirs.aux_width()
        if which == "muldiv":
            z = [x * y % modulus if f else x * pow(y, -1, modulus) % modulus
                 for x, y, f in zip(xs, ys, f0)]
        else:
            z = [(x + y) % modulus if f else (x - y) % modulus for x, y, f in zip(xs, ys, f0)]
        zl = [np.asarray([mod_builder.int_to_limbs(v, 32) for v in z], dtype=np.uint64)]
        got = ours.fill(limbs, flags, var_results=zl)
        want = theirs.fill(limbs, flags, var_results=zl)
        assert np.array_equal(got[1], want[1]) and got[1].dtype == want[1].dtype
        assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))


def test_modhints_equal_jax():
    """Non-residues and square roots (a residue and a non-residue, through
    the p = 3 mod 4 shortcut and Tonelli-Shanks) and the hint payloads."""
    rng = np.random.default_rng(5)
    for m in (*U256_MODULI, BN254_P, P, 17, 97, 65537):
        assert modhints.find_non_qr(m) == jmodhints.find_non_qr(m)
        assert modhints.num_limbs(m) == jmodhints.num_limbs(m)
        assert modhints.non_qr_hint_bytes(m) == jmodhints.non_qr_hint_bytes(m)
        for x in [0, 1, 2, 3] + [int.from_bytes(rng.bytes(32), "little") % m for _ in range(4)]:
            assert modhints.mod_sqrt(x, m) == jmodhints.mod_sqrt(x, m)
            assert modhints.sqrt_hint(x, m) == jmodhints.sqrt_hint(x, m)
            assert modhints.sqrt_hint_bytes(x, m) == jmodhints.sqrt_hint_bytes(x, m)


class _Collect:
    """An AIR builder that keeps each asserted value (plain ints)."""

    def __init__(self):
        self.values = []

    def assert_zero(self, v):
        self.values.append(v % P)


@pytest.mark.parametrize("flag_cnt,max_degree", [(5, 2), (9, 2), (20, 3), (4, 1)])
def test_encoder_equals_jax(flag_cnt, max_degree):
    """The points, each flag's coordinates and, at seeded integer points,
    every flag expression, is_valid, the unused points' sum and the
    well-formedness constraints."""
    ours = encoder.Encoder(flag_cnt, max_degree)
    theirs = jencoder.Encoder(flag_cnt, max_degree)
    assert (ours.width, ours.pts) == (theirs.width, theirs.pts)
    assert [ours.flag_pt(i) for i in range(flag_cnt)] == \
        [theirs.flag_pt(i) for i in range(flag_cnt)]
    rng = np.random.default_rng(flag_cnt)
    points = ours.pts + [[int(v) for v in rng.integers(0, P, ours.width)] for _ in range(4)]
    for pt in points:
        assert [f % P for f in ours.flags(pt)] == [f % P for f in theirs.flags(pt)]
        assert ours.is_valid(pt) % P == theirs.is_valid(pt) % P
        assert ours.sum_of_unused(pt) % P == theirs.sum_of_unused(pt) % P
        a, b = _Collect(), _Collect()
        ours.eval(a, pt)
        theirs.eval(b, pt)
        assert a.values == b.values
