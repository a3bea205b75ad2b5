"""The port's pairing host library and its HintFinalExp guests against
openvm_tpu's: the slow host checks, each a residue-witness hint or more.

The Miller loop with and without an embedded c, ``final_exp_hint``'s
(c, u) and ``assert_final_exp_is_one`` on a valid input of each curve,
``pairing_check`` on tests/test_pairing.py:95-115's cases (valid,
bilinear, invalid), and the records of two guests through the JAX
package's ``PreflightInterpreter`` and the port's (its Python loop and its
C++ core, which yields the Fp2 opcodes and the phantoms to the loop):
tests/test_pairing.py's pairing-hint guest and ``build_pairing_program(1,
pairs=2)``, whose public values must be ``pairing_reference`` and whose
instructions and chip rows must be ``pairing_counts``.  About a minute of
Python-int Fp12 exponentiations in one process; like
tests/test_torch_ecc_vm.py, this file keeps to a few test functions, so
that ``--dist loadfile`` queues it after tests/test_aggregation.py.
"""

import torch

from openvm_tpu.pairing import curve as jcurve
from openvm_tpu.pairing import final_exp as jfinal_exp
from openvm_tpu.pairing import miller as jmiller
from openvm_tpu.vm.preflight import PreflightInterpreter as JaxPreflight
from openvm_tpu_torch.pairing import curve, final_exp, miller
from openvm_tpu_torch.pairing.tower import F12_ONE
from openvm_tpu_torch.vm import guest
from openvm_tpu_torch.vm.guest import BN254_P
from openvm_tpu_torch.vm.native import NativeVmHandle
from openvm_tpu_torch.vm.preflight import PreflightInterpreter

from test_pairing import _point_bytes, g1_scalar_mul, g2_scalar_mul
from test_pairing import build_pairing_hint_program as jax_build_pairing_hint_program
from test_torch_ecc import jax_exe
from test_torch_keccak_sha import assert_records_equal

torch.set_num_threads(1)

CURVES = ((curve.BN254, jcurve.BN254), (curve.BLS12_381, jcurve.BLS12_381))


def _trivial_pairs(cv):
    """(G1, -G1) over (G2, G2): the product of pairings is one."""
    return [cv.g1, (cv.g1[0], (-cv.g1[1]) % cv.p)], [cv.g2, cv.g2]


def test_miller_loop_and_hint_equal_jax():
    """On a valid input of each curve: the Miller loop without and with an
    embedded c, the hint's (c, u), the residue check's product (one), and
    c^lambda = f u (BN254) or c^(p - x) = f s (BLS12-381)."""
    for cv, jcv in CURVES:
        ps, qs = _trivial_pairs(cv)
        f = miller.multi_miller_loop(cv, ps, qs)
        assert f == jmiller.multi_miller_loop(jcv, ps, qs), cv.name
        c, u = final_exp.final_exp_hint(cv, f)
        assert (c, u) == jfinal_exp.final_exp_hint(jcv, f), cv.name
        c_inv = cv.tower.f12_inv(c)
        assert miller.multi_miller_loop(cv, ps, qs, c=c_inv) == \
            jmiller.multi_miller_loop(jcv, ps, qs, c=c_inv), cv.name
        product = final_exp.final_exp_product(cv, c, u, miller.g1_fracs(cv, ps), qs)
        assert product == F12_ONE, cv.name
        t = cv.tower
        if cv.line_type == "D":
            lam = 6 * cv.seed + 2 + cv.p - cv.p ** 2 + cv.p ** 3
            assert t.f12_pow(c, lam) == t.f12_mul(f, u)
        else:
            assert t.f12_pow(c, cv.p - cv.seed) == t.f12_mul(f, u)


def test_pairing_checks_equal_jax():
    """tests/test_pairing.py's cases on both curves: e(P, Q) e(-P, Q) = 1,
    e(7P, Q) e(P, -7Q) = 1 and e(P, Q)^2 != 1, the port's answers equal to
    the JAX package's and to the expected ones."""
    for cv, jcv in CURVES:
        t = cv.tower
        p, q = cv.g1, cv.g2
        neg_q = (q[0], t.f2_neg(q[1]))
        cases = [(*_trivial_pairs(cv), True),
                 ([g1_scalar_mul(jcv, p, 7), p], [q, g2_scalar_mul(jcv, neg_q, 7)], True),
                 ([p, p], [q, q], False)]
        for ps, qs, want in cases:
            assert final_exp.pairing_check(cv, ps, qs) is want, cv.name
            assert jfinal_exp.pairing_check(jcv, ps, qs) is want, cv.name


def _preflights(exe, jexe, inputs, **config):
    return (JaxPreflight(jexe, **config).execute(inputs),
            PreflightInterpreter(exe, **config).execute(inputs),
            PreflightInterpreter(exe, **config).execute(inputs, nvm=NativeVmHandle(exe)))


def _assert_equal_runs(theirs, *ours_runs):
    for ours in ours_runs:
        assert_records_equal(ours.records, theirs.records)
        assert ours.touched == theirs.touched
        assert ours.public_values == theirs.public_values
        assert (ours.instret, ours.final_ts, ours.exit_code) == \
            (theirs.instret, theirs.final_ts, theirs.exit_code) and ours.exit_code == 0


def test_pairing_hint_guest_records_equal_jax():
    """tests/test_pairing.py's HintFinalExp guest: records, touched words
    and public values through both preflights and the C++ core, the
    phantom's reads being peeks (no bus access), its host seconds in
    ``hint_s``, and c's first word revealed."""
    data, ps, qs = _point_bytes(jcurve.BN254)
    assert [list(data)] == guest.pairing_hint_stream()
    theirs, python, native = _preflights(guest.build_pairing_hint_program(),
                                         jax_build_pairing_hint_program(), [list(data)])
    _assert_equal_runs(theirs, python, native)
    assert len(python.hint_s) == len(native.hint_s) == 1 and native.hint_s[0] > 0
    cv = curve.BN254
    c, _ = final_exp.final_exp_hint(cv, miller.multi_miller_loop(cv, ps, qs))
    assert python.public_values[:4] == list(cv.tower.f12_to_bytes(c, 32)[:4])
    # the length header and the pairs' 96 words, then c and u's 192
    assert len(python.records["rv32_hint_store"]["pc"]) == 1 + 96 + 192


def test_pairing_guest_records_equal_jax():
    """build_pairing_program(1, pairs=2): the JAX package's preflight (over
    the JAX package's transpilation of the same words) and the port's
    Python loop and C++ core give the same records; its instructions and
    Fp2 and modular rows are ``pairing_counts``, and its public values
    ``pairing_reference``: the check held, and c's words."""
    n, pairs = 1, 2
    stream = guest.pairing_stream(n, pairs)
    theirs, python, native = _preflights(
        guest.build_pairing_program(n, pairs), jax_exe(guest.pairing_asm(n, pairs)[0]),
        stream, moduli=(BN254_P,), fp2=(BN254_P,))
    _assert_equal_runs(theirs, python, native)
    counts = guest.pairing_counts(n, pairs)
    rows = {k: len(next(iter(v.values()))) for k, v in native.records.items()}
    assert native.instret == counts["insns"]
    assert {k: rows.get(k, 0) for k in counts if k != "insns"} == \
        {k: v for k, v in counts.items() if k != "insns"}
    assert native.public_values == guest.pairing_reference(n, pairs)
    assert native.public_values[:4] == [1, 0, 0, 0]
    ps, qs = guest.pairing_inputs(n, pairs)[0]
    # the hint's (c, u) as the guest read it back
    c, u = final_exp.final_exp_hint(curve.BN254, miller.multi_miller_loop(curve.BN254, ps, qs))
    plan = guest._pairing_plan(pairs)
    got = bytes(b for k in range(192) for b in native.touched[(2, plan["out"] // 4 + k)][:4])
    t = curve.BN254.tower
    assert got == t.f12_to_bytes(c, 32) + t.f12_to_bytes(u, 32)
