"""The port's short-Weierstrass ECC extension and its full RV32IM executor
set against openvm_tpu's, without a prove: the transpiled words, the
preflight records and errors, the new AIRs' traces and constraints, and
the ecrecover guest's host reference.

The guests are tests/test_vm_ecc.py's (2G by EC_DOUBLE, 3G by EC_ADD_NE),
tests/test_vm_full_ops.py's (every shift, mul, mulh, div and rem, a
division by zero, a hinted word) and ``build_ecrecover_program(2)`` (two
secp256k1 signatures recovered: modular ops over p and n, the HintSqrt
phantom, Shamir's ladder of EC_DOUBLE in place and EC_ADD_NE, keccak256,
HINT_BUFFER and every RV32IM chip).  Each is transpiled by both packages
and run through the JAX package's ``PreflightInterpreter`` and the port's
(its Python loop and its C++ core, which yields the extension opcodes to
the loop): the records, and the traces the AIRs make of them, must be
equal word for word, but for the one repair F4 (ROADMAP.md): the port's
HintStoreAir marks a HINT_BUFFER's start row only, where the JAX
package's trace, which marks every row, fails its own constraint.  No JAX
keygen and no XLA compile.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from openvm_tpu.stark.logup import append_logup_constraints as jax_append_logup
from openvm_tpu.stark.symbolic import AirBuilder as JaxAirBuilder
from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu.vm import transpiler as jtranspiler
from openvm_tpu.vm.circuit import ecc as jecc
from openvm_tpu.vm.circuit import rv32im as jrv32im
from openvm_tpu.vm.circuit import system as jsystem
from openvm_tpu.vm.circuit.keccak import keccak256 as jax_keccak256
from openvm_tpu.vm.instructions import Instruction as JaxInstruction
from openvm_tpu.vm.instructions import Program as JaxProgram
from openvm_tpu.vm.instructions import VmExe as JaxVmExe
from openvm_tpu.vm.interpreter import ExecutionError as JaxExecutionError
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark.logup import append_logup_constraints
from openvm_tpu_torch.stark.symbolic import AirBuilder, SymbolicDag
from openvm_tpu_torch.vm import guest
from openvm_tpu_torch.vm.circuit import ecc, rv32im, system
from openvm_tpu_torch.vm.guest import (ECRECOVER_MODULI, SECP256K1_CURVE, SECP256K1_G,
                                       SECP256K1_N, SECP256K1_P, TERMINATE, asm_i, ec_r)
from openvm_tpu_torch.vm.instructions import Instruction
from openvm_tpu_torch.vm.interpreter import ExecutionError
from openvm_tpu_torch.vm.native import NativeVmHandle
from openvm_tpu_torch.vm.preflight import PreflightInterpreter
from openvm_tpu_torch.vm.transpiler import Transpiler

from test_torch_keccak_sha import assert_records_equal, fields
from test_vm_ecc import build_ecc_program as jax_build_ecc_program
from test_vm_ecc import ec_add as jax_ec_add
from test_vm_ecc import ec_double as jax_ec_double
from test_vm_full_ops import build_full_ops_program as jax_build_full_ops_program

torch.set_num_threads(1)

P = bb.P
CURVES = (SECP256K1_CURVE,)
ER_N = 2


def jax_exe(words):
    return JaxVmExe(program=JaxProgram(instructions=jtranspiler.Transpiler().transpile(words),
                                       pc_base=0), pc_start=0)


# (the port's exe, the JAX package's, the input stream, moduli, curves)
GUESTS = {
    "ecc": lambda: (guest.build_ecc_program(), jax_build_ecc_program(), guest.ecc_inputs(),
                    (), CURVES),
    "full_ops": lambda: (guest.build_full_ops_program(), jax_build_full_ops_program(),
                         guest.FULL_OPS_INPUTS, (), ()),
    "ecrecover": lambda: (guest.build_ecrecover_program(ER_N),
                          jax_exe(guest.ecrecover_asm(ER_N)[0]),
                          guest.ecrecover_stream(ER_N), ECRECOVER_MODULI, CURVES),
}


@functools.lru_cache(maxsize=None)
def preflights(name):
    """The guest through the JAX package's preflight and the port's Python
    loop and C++ core."""
    exe, jexe, inputs, moduli, curves = GUESTS[name]()
    return (JaxPreflight(jexe, moduli=moduli, curves=curves).execute(inputs),
            PreflightInterpreter(exe, moduli=moduli, curves=curves).execute(inputs),
            PreflightInterpreter(exe, moduli=moduli, curves=curves).execute(
                inputs, nvm=NativeVmHandle(exe)))


# ---------------------------------------------------------------------------
# transpiler
# ---------------------------------------------------------------------------

def test_ecc_words_transpile_as_jax():
    """The three guests, and every ECC base funct7 (EC_ADD_NE, EC_DOUBLE,
    SETUP to nop, the unused ones) over two curve indices and rd = 0, as
    the JAX package transpiles them."""
    for name in GUESTS:
        exe, jexe, *_ = GUESTS[name]()
        assert fields(exe.program.instructions) == fields(jexe.program.instructions), name
    words = [ec_r(f7, rd, 1, 2, k) for f7 in range(8) for rd in (0, 3) for k in (0, 1)]
    ours = Transpiler().transpile(words)
    assert fields(ours) == fields(jtranspiler.Transpiler().transpile(words))
    assert {i.opcode for i in ours} >= {0x600, 0x602, 0x604, 0x606}


# ---------------------------------------------------------------------------
# preflight records and errors
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
    rows = {k: len(next(iter(v.values()))) for k, v in python.records.items()}
    if name == "ecc":
        g2 = jax_ec_double(SECP256K1_G)
        assert python.public_values[:4] == list(
            jax_ec_add(SECP256K1_G, g2)[0].to_bytes(32, "little")[:4])
        assert rows["sw_add_ne_0"] == rows["sw_double_0"] == 1
    if name == "full_ops":
        assert {"rv32_shift", "rv32_mul", "rv32_div_rem", "rv32_hint_store"} <= set(rows)
        assert rows["rv32_div_rem"] == 5 and rows["rv32_shift"] == 6
    if name == "ecrecover":
        counts = guest.ecrecover_counts(ER_N)
        assert python.public_values == guest.ecrecover_reference(ER_N)
        assert python.instret == counts["insns"]
        assert rows["sw_add_ne_0"] == counts["ec_add_ne"]
        assert rows["sw_double_0"] == counts["ec_double"]
        assert rows["keccak_sponge"] == counts["keccak_blocks"]
        assert all(rows[k] == v for k, v in counts.items() if k.startswith("modular_"))
        # every chip of the default executor set has a real row
        assert {a.name for a in (cls() for cls in rv32im_airs())} <= set(rows)


def rv32im_airs():
    return (rv32im.BaseAluAir, rv32im.LessThanAir, rv32im.BranchEqAir, rv32im.BranchLtAir,
            rv32im.JalLuiAir, rv32im.JalrAir, rv32im.AuipcAir, rv32im.LoadStoreAir,
            rv32im.ShiftAir, rv32im.MulAir, rv32im.DivRemAir, rv32im.HintStoreAir)


def test_in_place_double_reads_before_it_writes():
    """EC_DOUBLE with rd = rs1 (the ladder's): each row reads the old point
    and writes its double over it, prevz being the point read, as in the
    JAX package's records."""
    theirs, ours, _ = preflights("ecrecover")
    rec = ours.records["sw_double_0"]
    in_place = rec["rs1p"].tolist() == rec["rdp"].tolist()
    assert in_place and np.array_equal(rec["prevz"], rec["x"])
    for r in (0, len(rec["pc"]) - 1):
        x, y = (int.from_bytes(bytes(int(v) for v in rec["x"][r][h:h + 32]), "little")
                for h in (0, 32))
        assert bytes(int(v) for v in rec["z"][r]) == b"".join(
            c.to_bytes(32, "little") for c in guest.ec_add((x, y), (x, y)))
    assert_records_equal({"sw_double_0": rec}, {"sw_double_0": theirs.records["sw_double_0"]})


def _point_words(reg, addr, point):
    """Words that store a 64-byte point at addr through hint-free stores."""
    out = [asm_i(0x13, reg, 0, addr, 0)]
    for k in range(16):
        v = (point[k // 8] >> (32 * (k % 8))) & 0xFFFFFFFF
        out += guest._imm32(5, v) + [guest.asm_s(2, reg, 5, 4 * k)]
    return out


def _run_both(words, moduli=(), curves=CURVES, patch=None):
    exe, jexe = guest._program(words), jax_exe(words)
    if patch:
        for at, insn in patch.items():
            exe.program.instructions[at] = insn
            jexe.program.instructions[at] = JaxInstruction(*dataclasses.astuple(insn))
    with pytest.raises(JaxExecutionError) as theirs:
        JaxPreflight(jexe, moduli=moduli, curves=curves).execute()
    with pytest.raises(ExecutionError) as ours:
        PreflightInterpreter(exe, moduli=moduli, curves=curves).execute()
    with pytest.raises(ExecutionError) as native:
        PreflightInterpreter(exe, moduli=moduli, curves=curves).execute(
            nvm=NativeVmHandle(exe))
    assert str(ours.value) == str(native.value) == str(theirs.value)
    return str(ours.value)


def test_ecc_execution_errors_equal_jax():
    """EC_ADD_NE of two points of equal x, EC_DOUBLE of a point with y = 0,
    an unaligned point pointer, a SETUP that reaches execution and an ECC
    opcode in a config without the curve: the JAX package's
    ExecutionError, word for word, from the Python loop and the C++ core."""
    g, x0 = SECP256K1_G, (SECP256K1_G[0], 0)
    add_eq = _point_words(1, 0x200, g) + _point_words(2, 0x240, (g[0], SECP256K1_P - g[1]))
    assert _run_both(add_eq + [ec_r(0, 3, 1, 2), TERMINATE]) == "EC_ADD_NE with equal x"
    dbl_y0 = _point_words(1, 0x200, x0)
    assert _run_both(dbl_y0 + [ec_r(1, 3, 1, 0), TERMINATE]) == "EC_DOUBLE of 2-torsion point"
    bad = [asm_i(0x13, 1, 0, 0x202, 0), ec_r(1, 3, 1, 0), TERMINATE]
    assert _run_both(bad).startswith("bad ec pointer 0x202 at pc")
    setup = Instruction(0x601, a=12, b=4, c=8, d=1, e=2)
    assert _run_both(dbl_y0 + [TERMINATE, TERMINATE],
                     patch={len(dbl_y0): setup}) == "ec opcode base 1 is setup"
    assert _run_both(_point_words(1, 0x200, g) + [ec_r(1, 3, 1, 0), TERMINATE],
                     curves=()) == "opcode 0x602 has no circuit support yet"


# ---------------------------------------------------------------------------
# traces and constraints
# ---------------------------------------------------------------------------

def _airs(name):
    """The port's AIR of that name and the JAX package's."""
    if name.startswith("sw_"):
        return ecc.ecc_airs(CURVES)[name], jecc.ecc_airs(CURVES)[name]
    if name == "range_tuple":
        return system.RangeTupleCheckerAir(), jsystem.RangeTupleCheckerAir()
    cls = {"rv32_shift": "ShiftAir", "rv32_mul": "MulAir", "rv32_div_rem": "DivRemAir",
           "rv32_hint_store": "HintStoreAir"}[name]
    return getattr(rv32im, cls)(), getattr(jrv32im, cls)()


NEW_AIRS = ["sw_add_ne_0", "sw_double_0", "rv32_shift", "rv32_mul", "rv32_div_rem",
            "rv32_hint_store"]


def f4_repaired(air, trace, rec):
    """The JAX package's HintStoreAir trace with the port's repair: its
    is_buffer flag, and the length read's timestamp limbs, kept on a
    HINT_BUFFER's start row only."""
    out = trace.copy()
    n = len(rec["pc"])
    keep = (rec["is_buffer"] * rec["is_start"]).astype(np.uint64)
    for col in ("is_buffer", "dlo2", "dhi2"):
        out[:n, air.c.index[col]] *= keep
    return out


@pytest.mark.parametrize("name", NEW_AIRS)
def test_trace_equals_jax(name):
    """The AIR's trace of the records of every guest that uses it, each
    guest's rows in turn, and its width and padded height.  Only
    HintStoreAir's differ: on the ecrecover guest's HINT_BUFFER rows but
    the first, where the JAX package's trace breaks its own constraint
    is_buffer * (1 - is_start) = 0 (F4) and the port's keeps it."""
    runs = [preflights(g) for g in GUESTS if name in preflights(g)[0].records]
    assert runs
    recs = [{c: np.concatenate([np.asarray(run[i].records[name][c]) for run in runs])
             for c in runs[0][i].records[name]} for i in (0, 1)]
    air, jair = _airs(name)
    ours, want = air.trace(recs[1]), jair.trace(recs[0])
    n = len(recs[1]["pc"])
    assert ours.dtype == want.dtype and ours.shape == want.shape == (
        1 << (n - 1).bit_length(), air.width)
    assert ours[:n, 0].all()  # is_valid on every real row
    if name != "rv32_hint_store":
        assert np.array_equal(ours, want)
        return
    ix = air.c.index
    broken = want[:n, ix["is_buffer"]] * (1 - want[:n, ix["is_start"]])
    # a signature's two HINT_BUFFERs: its 37 input words and the 8 of R.y
    assert broken.sum() == ER_N * (36 + 7) and not (ours[:n, ix["is_buffer"]]
                                           * (1 - ours[:n, ix["is_start"]])).any()
    assert np.array_equal(ours, f4_repaired(air, want, recs[0]))


def test_range_tuple_table_equals_jax():
    """The tuple table the mul and divrem chips send to: its sizes and its
    preprocessed (x, y) rows; its multiplicities are the histogram of
    those sends (the contexts of tests/test_torch_ecc_vm.py)."""
    air, jair = _airs("range_tuple")
    assert air.sizes == jair.sizes == (256, 2048) and air.width == jair.width == 1
    assert np.array_equal(air.preprocessed_trace(), jair.preprocessed_trace())


@pytest.mark.parametrize("name", NEW_AIRS + ["range_tuple"])
def test_constraints_equal_jax(name):
    """The AIR's DAG as the port's keygen builds it (AirBuilder, LogUp at
    degree 3) equals the JAX package's: nodes (the curve's modulus limbs
    and the mod-builder's offsets among the constants), roots and
    interactions."""
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
# the ecrecover guest's host side
# ---------------------------------------------------------------------------

def test_ecrecover_reference_from_keys():
    """Each expected address is keccak256 of its signer's public key d G
    (the seeded keys drawn again here); each input recovers that key by
    the textbook formula Q = r^-1 (s R - z G); the reference's public
    values are the count and the XOR of the addresses' words."""
    n = 3
    rng = np.random.default_rng(0)
    inputs = guest.ecrecover_inputs(n)
    for inp, addr in inputs:
        z, v, r, s = (int.from_bytes(inp[32 * k:32 * k + 32], "big") for k in range(4))
        assert 27 <= v <= 28 and 0 < r < SECP256K1_N and 0 < s <= SECP256K1_N // 2
        y = pow(r ** 3 + 7, (SECP256K1_P + 1) // 4, SECP256K1_P)
        R = (r, y if y & 1 == v - 27 else SECP256K1_P - y)
        rinv = pow(r, -1, SECP256K1_N)
        q = guest.ec_add(guest.ec_mul(s * rinv % SECP256K1_N, R),
                         guest.ec_mul(-z * rinv % SECP256K1_N, SECP256K1_G))
        pub = q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big")
        assert addr == jax_keccak256(pub)[12:]
    # the first signer's key, drawn as _ecrecover_signatures draws it
    d = int.from_bytes(rng.bytes(32), "big") % SECP256K1_N
    q = guest.ec_mul(d, SECP256K1_G)
    assert inputs[0][1] == jax_keccak256(q[0].to_bytes(32, "big") + q[1].to_bytes(32, "big"))[12:]
    xor = [0] * 5
    for _, addr in inputs:
        for k in range(5):
            xor[k] ^= int.from_bytes(addr[4 * k:4 * k + 4], "little")
    want = n.to_bytes(4, "little") + b"".join(w.to_bytes(4, "little") for w in xor)
    assert guest.ecrecover_reference(n) == list(want + bytes(32 - len(want)))
