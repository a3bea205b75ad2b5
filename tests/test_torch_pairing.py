"""The port's Fp2 chips, Fp12 builders and pairing library against
openvm_tpu's, without a prove and without a final-exponentiation hint:
the tower's ops, the loop encodings and Frobenius constants, the Miller
loop's steps and lines, the Fp12 mod-builder blocks, the transpiled Fp2
and pairing words, the Fp2 preflight records, errors, traces and
constraints, and the pairing guest's recorded check.

Every value is made from a seed with numpy.  The slow host checks (the
Miller loop, the hints, the pairing checks, the HintFinalExp guests'
records) are in tests/test_torch_pairing_host.py, the CPU proofs in
tests/test_torch_pairing_vm.py.  No JAX keygen and no XLA compile.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from openvm_tpu.pairing import curve as jcurve
from openvm_tpu.pairing import final_exp as jfinal_exp
from openvm_tpu.pairing import miller as jmiller
from openvm_tpu.pairing import tower as jtower
from openvm_tpu.stark.logup import append_logup_constraints as jax_append_logup
from openvm_tpu.stark.symbolic import AirBuilder as JaxAirBuilder
from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu.vm import transpiler as jtranspiler
from openvm_tpu.vm.circuit import fp2 as jfp2
from openvm_tpu.vm.circuit import fp12 as jfp12
from openvm_tpu.vm.circuit import mod_builder as jmod_builder
from openvm_tpu.vm.instructions import Instruction as JaxInstruction
from openvm_tpu.vm.interpreter import ExecutionError as JaxExecutionError
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch.pairing import curve, final_exp, miller, tower
from openvm_tpu_torch.stark.logup import append_logup_constraints
from openvm_tpu_torch.stark.symbolic import AirBuilder, SymbolicDag
from openvm_tpu_torch.vm import guest
from openvm_tpu_torch.vm.circuit import fp2, fp12, mod_builder
from openvm_tpu_torch.vm.guest import BN254_P, TERMINATE, asm_i, fp2_r
from openvm_tpu_torch.vm.instructions import Instruction
from openvm_tpu_torch.vm.interpreter import ExecutionError
from openvm_tpu_torch.vm.native import NativeVmHandle
from openvm_tpu_torch.vm.preflight import PreflightInterpreter
from openvm_tpu_torch.vm.transpiler import Transpiler

from test_torch_ecc import jax_exe
from test_torch_keccak_sha import assert_records_equal, fields
from test_pairing import build_pairing_hint_program as jax_build_pairing_hint_program
from test_vm_fp2 import build_fp2_program as jax_build_fp2_program
from test_vm_fp2 import hint_input as jax_fp2_hint_input

torch.set_num_threads(1)

FP2 = (BN254_P,)
CURVES = {"bn254": (curve.BN254, jcurve.BN254), "bls12_381": (curve.BLS12_381, jcurve.BLS12_381)}


def _rng_fp2(rng, p):
    return tuple(int.from_bytes(rng.bytes(48), "little") % p for _ in range(2))


def _rng_fp12(rng, p):
    return tuple(_rng_fp2(rng, p) for _ in range(6))


# ---------------------------------------------------------------------------
# the host library
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CURVES))
def test_tower_ops_equal_jax(name):
    """Every Fp2 and Fp12 op of ``Tower`` on seeded elements, the inverse
    and Frobenius powers included, and the byte layout both ways."""
    cv, jcv = CURVES[name]
    t, jt = tower.Tower(cv.p, cv.xi), jtower.Tower(jcv.p, jcv.xi)
    rng = np.random.default_rng(1)
    a, b = _rng_fp2(rng, cv.p), _rng_fp2(rng, cv.p)
    x, y = _rng_fp12(rng, cv.p), _rng_fp12(rng, cv.p)
    for op in ("f2_add", "f2_sub", "f2_mul"):
        assert getattr(t, op)(a, b) == getattr(jt, op)(a, b), op
    for op in ("f2_neg", "f2_sq", "f2_conj", "f2_inv"):
        assert getattr(t, op)(a) == getattr(jt, op)(a), op
    assert t.f2_smul(a, 3) == jt.f2_smul(a, 3) and t.f2_pow(a, 1000) == jt.f2_pow(a, 1000)
    assert t.f2_embed(cv.p + 5) == jt.f2_embed(cv.p + 5) == (5, 0)
    for op in ("f12_add", "f12_mul"):
        assert getattr(t, op)(x, y) == getattr(jt, op)(x, y), op
    for op in ("f12_conj", "f12_sq", "f12_inv"):
        assert getattr(t, op)(x) == getattr(jt, op)(x), op
    assert t.f12_mul(x, t.f12_inv(x)) == tower.F12_ONE
    assert t.f12_pow(x, 77) == jt.f12_pow(x, 77) and t.f12_pow(x, -5) == jt.f12_pow(x, -5)
    for k in (1, 2, 3):
        assert t.f12_frobenius(x, k) == jt.f12_frobenius(x, k), k
    data = t.f12_to_bytes(x, cv.num_limbs)
    assert data == jt.f12_to_bytes(x, cv.num_limbs) and len(data) == 12 * cv.num_limbs
    assert t.f12_from_bytes(data, cv.num_limbs) == jt.f12_from_bytes(data, cv.num_limbs) == x


def test_naf_and_pseudo_binary_encodings_equal_jax():
    """``naf`` of seeded values (and of 0), each digit string summing back
    to its value, and both curves' loop encodings."""
    rng = np.random.default_rng(2)
    for v in [0, 1, 2, 3, 7, *(int.from_bytes(rng.bytes(16), "little") for _ in range(20))]:
        digits = curve.naf(v)
        assert digits == jcurve.naf(v) and sum(d << i for i, d in enumerate(digits)) == v
        assert all(not (digits[i] and digits[i + 1]) for i in range(len(digits) - 1))
    for cv, jcv in CURVES.values():
        assert cv.pseudo_binary_encoding == jcv.pseudo_binary_encoding
    enc = curve.BN254.pseudo_binary_encoding
    assert sum(d << i for i, d in enumerate(enc)) == 6 * curve.BN254.seed + 2


@pytest.mark.parametrize("name", list(CURVES))
def test_frobenius_constants_equal_jax(name):
    """The twist Frobenius constants and the Fp12 Frobenius gammas of the
    p, p^2 and p^3 powers."""
    cv, jcv = CURVES[name]
    for k in ("frob_g2_x", "frob_g2_y", "frob_g2_x_sq"):
        assert getattr(cv, k) == getattr(jcv, k), k
    assert cv.frob_g2_x_sq[1] == 0
    for k in (1, 2, 3):
        assert cv.tower._frob_gammas(k) == jcv.tower._frob_gammas(k), k
    assert (cv.name, cv.p, cv.r, cv.seed, cv.xi, cv.b, cv.g1, cv.g2, cv.num_limbs,
            cv.line_type) == (jcv.name, jcv.p, jcv.r, jcv.seed, jcv.xi, jcv.b, jcv.g1,
                              jcv.g2, jcv.num_limbs, jcv.line_type)


@pytest.mark.parametrize("name", list(CURVES))
def test_miller_steps_and_lines_equal_jax(name):
    """The double, add and double-and-add steps, the evaluated lines,
    their Fp12 embedding and products, the folding of lines into f and the
    twist Frobenius, on G2's generator and its double."""
    cv, jcv = CURVES[name]
    q = cv.g2
    q2, line = miller.miller_double_step(cv, q)
    assert (q2, line) == jmiller.miller_double_step(jcv, q)
    assert miller.miller_add_step(cv, q2, q) == jmiller.miller_add_step(jcv, q2, q)
    q5 = miller.miller_double_and_add_step(cv, q2, q)
    assert q5 == jmiller.miller_double_and_add_step(jcv, q2, q)
    xy = miller.g1_fracs(cv, [cv.g1])[0]
    lines = [miller.evaluate_line(cv, ln, xy) for ln in (line, q5[1], q5[2])]
    assert lines == [jmiller.evaluate_line(jcv, ln, xy) for ln in (line, q5[1], q5[2])]
    assert miller.line_to_f12(cv, lines[0]) == jmiller.line_to_f12(jcv, lines[0])
    assert miller.mul_lines(cv, *lines[:2]) == jmiller.mul_lines(jcv, *lines[:2])
    f = _rng_fp12(np.random.default_rng(3), cv.p)
    assert miller.evaluate_lines_vec(cv, f, lines) == jmiller.evaluate_lines_vec(jcv, f, lines)
    for k in (1, 2):
        assert miller.g2_frobenius(cv, q, k) == jmiller.g2_frobenius(jcv, q, k)


def test_hint_final_exp_bytes_rejects_mismatched_lengths():
    """A P descriptor of one point and a Q descriptor of two: both
    packages' ValueError, word for word."""
    def rd(ptr, ln):
        vals = {0: 64, 4: 1, 8: 0x100, 12: 2}
        return vals[ptr].to_bytes(ln, "little") if ptr in vals else bytes(ln)

    with pytest.raises(ValueError) as ours:
        final_exp.hint_final_exp_bytes(0, rd, 0, 8)
    with pytest.raises(ValueError) as theirs:
        jfinal_exp.hint_final_exp_bytes(0, rd, 0, 8)
    assert str(ours.value) == str(theirs.value) == "hint_pairing: p_len=1 != q_len=2"


# ---------------------------------------------------------------------------
# the Fp12 mod-builder blocks
# ---------------------------------------------------------------------------

def _fp12_block(pkg, mb, kind):
    """(builder, output var indices, the op on the tower) of one block."""
    cv = curve.BN254
    if kind == "mul":
        eb, out = pkg.fp12_mul_builder(cv.p, cv.xi, num_limbs=32)
        return eb, out, lambda t, f, xs: t.f12_mul(f, xs)
    eb = mb.ExprBuilder(cv.p, num_limbs=32)
    f = pkg.Fp12Expr(eb)
    xs = [pkg.Fp2Expr(eb) for _ in range(5)]
    z = getattr(f, kind)(xs, cv.xi)
    out = [v.kw["idx"] for c in z.c for v in (c.c0, c.c1)]
    zero = tower.F2_ZERO

    def sparse(t, f, x):
        full = tuple(x) + (zero,) if kind == "mul_by_01234" else (x[0], zero, *x[1:])
        return t.f12_mul(f, full)
    return eb, out, sparse


@pytest.mark.parametrize("kind", ["mul", "mul_by_01234", "mul_by_02345"])
def test_fp12_builders_equal_jax(kind):
    """Each block's saved variables, witness columns and equations' layout
    equal the JAX package's on two seeded rows, and its outputs are the
    tower's product (tests/test_pairing.py:253-314)."""
    cv = curve.BN254
    eb, out, op = _fp12_block(fp12, mod_builder, kind)
    jeb, jout, _ = _fp12_block(jfp12, jmod_builder, kind)
    assert out == jout and eb.aux_width() == jeb.aux_width()
    rng = np.random.default_rng(4)
    n_x = 6 if kind == "mul" else 5
    rows = [(_rng_fp12(rng, cv.p), tuple(_rng_fp2(rng, cv.p) for _ in range(n_x)))
            for _ in range(2)]
    limbs = [np.asarray([mod_builder.int_to_limbs(v, 32) for v in col], dtype=np.uint64)
             for col in zip(*[[v for el in r for c in el for v in c] for r in rows])]
    var_vals, aux = eb.fill(limbs, [])
    jvar_vals, jaux = jeb.fill(limbs, [])
    assert np.array_equal(aux, jaux)
    assert all(np.array_equal(var_vals[i], jvar_vals[i]) for i in out)
    t = cv.tower
    for r, (f, xs) in enumerate(rows):
        got = [sum(int(v) << (8 * i) for i, v in enumerate(var_vals[k][r])) for k in out]
        assert tuple(zip(got[::2], got[1::2])) == op(t, f, xs)


# ---------------------------------------------------------------------------
# the Fp2 chips: transpiler, preflight, traces, constraints
# ---------------------------------------------------------------------------

def test_fp2_and_pairing_words_transpile_as_jax():
    """Every Fp2 base funct7 (ADD, SUB, MUL, DIV, SETUP to nop, the unused
    ones) over two Fp2 indices and rd = 0 (nop), the pairing words of two
    pairing indices (HintFinalExp, the unused bases), and the three
    guests, as the JAX package transpiles them."""
    words = [fp2_r(f7, rd, 1, 2, k) for f7 in range(8) for rd in (0, 3) for k in (0, 1)]
    words += [guest.pairing_hint_insn(10, 11, k) for k in (0, 1)]
    words += [((k * 16 + f7) << 25) | (11 << 20) | (10 << 15) | (0b011 << 12) | 0x2B
              for f7 in (1, 15) for k in (0, 1)]
    ours = Transpiler().transpile(words)
    assert fields(ours) == fields(jtranspiler.Transpiler().transpile(words))
    assert {i.opcode for i in ours} >= {0x710, 0x711, 0x713, 0x714, 0x716, 0x717, 0x719, 0x71A}
    for exe, jexe in ((guest.build_fp2_program(), jax_build_fp2_program()),
                      (guest.build_pairing_hint_program(), jax_build_pairing_hint_program())):
        assert fields(exe.program.instructions) == fields(jexe.program.instructions)
    # the pairing guest word by word: its distinct words through the JAX
    # package's transpiler (which copies the rest of the program per word)
    words = guest.pairing_asm(1, 2)[0]
    distinct = sorted(set(words))
    theirs = dict(zip(distinct, fields(jtranspiler.Transpiler().transpile(distinct))))
    assert fields(guest.build_pairing_program(1, 2).program.instructions) == \
        [theirs[w] for w in words]


@functools.lru_cache(maxsize=None)
def fp2_preflights():
    """build_fp2_program through the JAX package's preflight and the
    port's Python loop and C++ core."""
    exe, jexe = guest.build_fp2_program(), jax_build_fp2_program()
    inputs = guest.fp2_hint_input()
    assert inputs == jax_fp2_hint_input()
    return (JaxPreflight(jexe, fp2=FP2).execute(inputs),
            PreflightInterpreter(exe, fp2=FP2).execute(inputs),
            PreflightInterpreter(exe, fp2=FP2).execute(inputs, nvm=NativeVmHandle(exe)))


def test_fp2_preflight_records_equal_jax():
    """The Fp2 guest's records, touched words, public values and counts
    through both preflights and the C++ core; c = a after add, mul, div
    and sub."""
    theirs, python, native = fp2_preflights()
    for ours in (python, native):
        assert_records_equal(ours.records, theirs.records)
        assert ours.touched == theirs.touched
        assert ours.public_values == theirs.public_values
        assert (ours.instret, ours.final_ts, ours.exit_code) == \
            (theirs.instret, theirs.final_ts, theirs.exit_code) and ours.exit_code == 0
    rows = {k: len(next(iter(v.values()))) for k, v in python.records.items()}
    assert rows["fp2_addsub_0"] == rows["fp2_muldiv_0"] == 2
    assert python.public_values[:4] == list(guest.FP2_A0.to_bytes(32, "little")[:4])
    m0, m1 = fp2.fp2_mul(BN254_P, guest.FP2_A0, guest.FP2_A1, guest.FP2_B0, guest.FP2_B1)
    assert fp2.fp2_div(BN254_P, m0, m1, guest.FP2_B0, guest.FP2_B1) == (guest.FP2_A0, guest.FP2_A1)


def _run_both(words, fp2_moduli=FP2, patch=None):
    exe, jexe = guest._program(words), jax_exe(words)
    if patch:
        for at, insn in patch.items():
            exe.program.instructions[at] = insn
            jexe.program.instructions[at] = JaxInstruction(*dataclasses.astuple(insn))
    with pytest.raises(JaxExecutionError) as theirs:
        JaxPreflight(jexe, fp2=fp2_moduli).execute()
    with pytest.raises(ExecutionError) as ours:
        PreflightInterpreter(exe, fp2=fp2_moduli).execute()
    with pytest.raises(ExecutionError) as native:
        PreflightInterpreter(exe, fp2=fp2_moduli).execute(nvm=NativeVmHandle(exe))
    assert str(ours.value) == str(native.value) == str(theirs.value)
    return str(ours.value)


def test_fp2_execution_errors_equal_jax():
    """A division by zero, an unaligned pointer, a SETUP that reaches
    execution and an Fp2 opcode in a config without Fp2: the JAX package's
    ExecutionError, word for word, from the Python loop and the C++
    core."""
    ptrs = [asm_i(0x13, 1, 0, 0x200, 0), asm_i(0x13, 2, 0, 0x280, 0), asm_i(0x13, 3, 0, 0x300, 0)]
    assert _run_both(ptrs + [fp2_r(3, 3, 1, 2), TERMINATE]) == "fp2 division by zero"
    bad = [asm_i(0x13, 1, 0, 0x202, 0)] + ptrs[1:]
    assert _run_both(bad + [fp2_r(0, 3, 1, 2), TERMINATE]).startswith("bad fp2 pointer 0x202 at pc")
    setup = Instruction(0x712, a=12, b=4, c=8, d=1, e=2)
    assert _run_both(ptrs + [TERMINATE, TERMINATE],
                     patch={len(ptrs): setup}) == "fp2 opcode base 2 is setup"
    assert _run_both(ptrs + [fp2_r(2, 3, 1, 2), TERMINATE],
                     fp2_moduli=()) == "opcode 0x713 has no circuit support yet"


FP2_AIRS = ["fp2_addsub_0", "fp2_muldiv_0"]


@pytest.mark.parametrize("name", FP2_AIRS)
def test_fp2_trace_equals_jax(name):
    """The AIR's trace of the Fp2 guest's records, its width and its
    padded height."""
    theirs, ours, _ = fp2_preflights()
    air, jair = fp2.fp2_airs(FP2)[name], jfp2.fp2_airs(FP2)[name]
    got, want = air.trace(ours.records[name]), jair.trace(theirs.records[name])
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert got.shape == (2, air.width) and air.width == {"fp2_addsub_0": 503,
                                                         "fp2_muldiv_0": 767}[name]
    assert got[:, 0].all()


@pytest.mark.parametrize("name", FP2_AIRS)
def test_fp2_constraints_equal_jax(name):
    """The AIR's DAG as the port's keygen builds it (AirBuilder, LogUp at
    degree 3) equals the JAX package's: nodes (BN254's limbs and the
    mod-builder's offsets among the constants), roots and interactions."""
    air, jair = fp2.fp2_airs(FP2)[name], jfp2.fp2_airs(FP2)[name]
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
# the pairing guest's recorded check
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pairs", [1, 2, 4])
def test_pairing_plan_computes_the_residue_check(pairs):
    """The guest's straight-line ops, run over their slots on seeded
    values (not a valid witness: any c, u, P and Q), leave in the output
    slots the product the library's ``final_exp_product`` gives, which is
    the JAX package's assert_final_exp_is_one's product; no op reads a
    slot that an op between its write and the read overwrote, and the heap
    stays within the base registers' reach."""
    cv, p = curve.BN254, BN254_P
    t, jt = cv.tower, jcurve.BN254.tower
    plan = guest._pairing_plan(pairs)
    rng = np.random.default_rng(5)
    c, u = _rng_fp12(rng, p), _rng_fp12(rng, p)
    ps = [_rng_fp2(rng, p) for _ in range(pairs)]
    qs = [(_rng_fp2(rng, p), _rng_fp2(rng, p)) for _ in range(pairs)]
    mem = {}
    for k in range(pairs):
        mem[guest.PG_IN + 64 * pairs + 128 * k] = qs[k][0]
        mem[guest.PG_IN + 64 * pairs + 128 * k + 64] = qs[k][1]
    for k in range(6):
        mem[plan["out"] + 64 * k], mem[plan["out"] + 384 + 64 * k] = c[k], u[k]
    mem.update(plan["consts"])
    for (xy, yi), (x, y) in zip(plan["fracs"], ps):
        mem[xy], mem[yi] = ((x * pow(y, -1, p)) % p, 0), (pow(y, -1, p), 0)
    for name, out, a, b in plan["ops"]:
        if name == "conj":
            mem[out] = t.f2_conj(mem[a])
        else:
            op = {"add": t.f2_add, "sub": t.f2_sub, "mul": t.f2_mul,
                  "div": lambda x, y: t.f2_mul(x, t.f2_inv(y))}[name]
            mem[out] = op(mem[a], mem[b])
    got = tuple(mem[a] for a in plan["outs"])
    assert got == final_exp.final_exp_product(cv, c, u, miller.g1_fracs(cv, ps), qs)
    c_inv = jt.f12_inv(c)
    c_mul = jt.f12_mul(jt.f12_mul(jt.f12_frobenius(c_inv, 3), jt.f12_frobenius(c, 2)),
                       jt.f12_frobenius(c_inv, 1))
    fc = jmiller.multi_miller_loop(jcurve.BN254, ps, qs, c=c_inv)
    assert got == jt.f12_mul(jt.f12_mul(fc, c_mul), u)
    assert plan["end"] - guest.PG_REGION <= 4096 * len(guest.PG_BASE_REGS)
    counts = plan["counts"]
    assert sum(counts.values()) == len(plan["ops"]) and counts["div"] > 0


def test_pairing_inputs_are_pairs_on_the_curves():
    """Each input's P's lie on y^2 = x^3 + 3, the last is -(sum a_i b_i) G1
    over the Q's G2 (so the check holds, tests/test_torch_pairing_host.py),
    and the stream lays them out as the descriptors read them."""
    n, pairs = 2, 3
    inputs = guest.pairing_inputs(n, pairs, seed=7)
    assert len(inputs) == n and inputs[0] != inputs[1]
    t = curve.BN254.tower
    for ps, qs in inputs:
        assert len(ps) == len(qs) == pairs and qs[-1] == curve.BN254.g2
        for x, y in ps:
            assert (y * y - x ** 3 - 3) % BN254_P == 0
        b_twist = t.f2_mul((3, 0), t.f2_inv(curve.BN254.xi))
        for x, y in qs:
            assert t.f2_sq(y) == t.f2_add(t.f2_mul(t.f2_sq(x), x), b_twist)
    stream = guest.pairing_stream(n, pairs, seed=7)
    ps, qs = inputs[1]
    assert bytes(stream[1]) == guest.pairing_bytes(ps, qs) and len(stream[1]) == 192 * pairs
    assert bytes(stream[1][:32]) == ps[0][0].to_bytes(32, "little")
    assert bytes(stream[1][64 * pairs + 32:64 * pairs + 64]) == qs[0][0][1].to_bytes(32, "little")
