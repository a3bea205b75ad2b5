"""The port's persistent memory against openvm_tpu's: the persistent fib(8)
proof and the constraint checker.

The JAX package runs only up to its STARK prove (its ``stark_prove``
monkeypatched to capture the proving contexts), so no JAX prove runs here.
The port proves persistent ``build_fib_program(8)`` on the CPU with its
plain versions: its contexts equal the JAX package's, its proof's SHA-256
equals the pinned hash of the JAX package's proof
(``PERSISTENT_FIB8_PROOF_SHA256``, recomputed live by the OPENVM_SLOW test)
and the JAX package's verifier accepts it.  ``check_constraints`` passes on
the contexts, and with one Poseidon2Air cell changed it gives the JAX
package's failure strings.  tests/test_torch_memory_tree.py holds the
memory tree and the Poseidon2 AIR's trace, tests/test_torch_continuations.py
the continuations.  Each of these files holds few test functions: pytest-
xdist's ``--dist loadfile`` queues files by their number of tests, most
first, and a heavy file queued ahead of tests/test_aggregation.py (six
tests, the longest file) delays its start and the whole run.
"""

import copy
import hashlib
import os

import numpy as np
import pytest
import torch

from openvm_tpu.stark import codec as jcodec
from openvm_tpu.stark import debug as jdebug
from openvm_tpu.vm import machine as jmachine
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig, codec
from openvm_tpu_torch.stark.debug import check_constraints
from openvm_tpu_torch.stark.verifier import VerificationError
from openvm_tpu_torch.vm import machine, memory_tree
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program, fib
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

from test_vm_prove import TEST_STARK as JAX_TEST_STARK
from test_vm_prove import build_fib_program as jax_build_fib_program

torch.set_num_threads(1)

P = bb.P
# tests/test_vm_persistent.py:19
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))
# sha256 of openvm_tpu's encode_proof bytes for
# VirtualMachine(Rv32Config(stark=TEST_STARK, persistent=True,
# executors=FIB_EXECUTORS)).prove(build_fib_program(8))
PERSISTENT_FIB8_PROOF_SHA256 = \
    "95d550a8ed454127eb07accb755ab8a5e271e84418e29dd28a271bae0d2b0a6d"
AIR_NAMES = ["program", "connector", "persistent_boundary", "memory_merkle",
             "poseidon2", "range_checker", "bitwise_lookup", "phantom",
             "rv32_base_alu", "rv32_less_than", "rv32_branch_eq",
             "rv32_branch_lt", "rv32_jal_lui", "rv32_jalr", "rv32_auipc",
             "rv32_load_store"]
# a cell of the Poseidon2Air trace that the tamper tests change: row 3's
# first full round's x3 of lane 5
TAMPER_ROW, TAMPER_COL = 3, 1 + 16 + 5


class _StopBeforeProve(Exception):
    pass


def canonical(m) -> np.ndarray:
    if isinstance(m, torch.Tensor):
        return bb.canonical_np(m)
    return np.asarray(m, dtype=np.uint64) % P


@pytest.fixture(scope="module")
def jax_vm():
    """openvm_tpu's persistent VM and its proving contexts of fib(8)."""
    vm = jmachine.VirtualMachine(jmachine.Rv32Config(
        stark=JAX_TEST_STARK, persistent=True, executors=FIB_EXECUTORS))
    vm.keygen(cache=False)
    captured = {}

    def capture(pk, ctxs):
        captured["ctxs"] = ctxs
        raise _StopBeforeProve

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmachine, "stark_prove", capture)
        with pytest.raises(_StopBeforeProve):
            vm.prove(jax_build_fib_program(8))
    return vm, captured["ctxs"]


@pytest.fixture(scope="module")
def port_vm():
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, persistent=True,
                                   executors=FIB_EXECUTORS), device="cpu")
    vm.keygen()
    record = {}
    exe = build_fib_program(8)
    proof, pre = vm.prove(exe, record=record)
    return {"vm": vm, "exe": exe, "proof": proof, "pre": pre,
            "ctxs": record["ctxs"], "blob": codec.encode_proof(proof)}


# -- persistent fib(8) ---------------------------------------------------------

def test_contexts_equal_jax(jax_vm, port_vm):
    """The AIRs, and every row of every trace (padding rows included:
    Poseidon2Air's are zero-state permutations) and every public value of
    each AIR; the merkle root row binds the initial memory's root."""
    vm, exe = port_vm["vm"], port_vm["exe"]
    assert [a.name for a in vm.airs] == AIR_NAMES
    assert [a.name for a in jax_vm[0].airs] == AIR_NAMES
    for air_id, name in enumerate(AIR_NAMES):
        jc = next(c for c in jax_vm[1] if c.air_id == air_id)
        tc = next(c for c in port_vm["ctxs"] if c.air_id == air_id)
        assert np.array_equal(canonical(tc.common_main), canonical(jc.common_main)), name
        assert len(tc.cached_mains) == len(jc.cached_mains), name
        for a, b in zip(tc.cached_mains, jc.cached_mains):
            assert np.array_equal(canonical(a), canonical(b)), name
        assert [int(v) % P for v in tc.public_values] == \
            [int(v) % P for v in jc.public_values], name
    mk = port_vm["ctxs"][vm.air_index["memory_merkle"]]
    init_root = [int(x) for x in vm.commit_init_memory(exe)]
    assert len(mk.public_values) == 16 and mk.public_values[:8] == init_root
    assert init_root == [int(x) for x in jax_vm[0].commit_init_memory(
        jax_build_fib_program(8))]


def test_proof_equals_jax_and_verifies(jax_vm, port_vm):
    """The proof's SHA-256 is the JAX package's; the JAX package's verifier
    and the port's accept it, with the public values opened against the
    final root; a changed merkle public value fails."""
    vm, exe, pre = port_vm["vm"], port_vm["exe"], port_vm["pre"]
    assert hashlib.sha256(port_vm["blob"]).hexdigest() == PERSISTENT_FIB8_PROOF_SHA256
    jexe = jax_build_fib_program(8)
    jresult = jax_vm[0].verify(jcodec.decode_proof(port_vm["blob"]),
                               expected_exe_commit=jax_vm[0].commit_exe(jexe),
                               exe=jexe)
    result = vm.verify(port_vm["proof"], expected_exe_commit=vm.commit_exe(exe),
                       exe=exe)
    assert list(jresult["final_root"]) == list(result["final_root"])
    proof_pv = memory_tree.pv_proof(pre.final_memory_tree)
    assert proof_pv["root"].tolist() == list(result["final_root"])
    assert memory_tree.verify_pv_proof(proof_pv)
    assert int.from_bytes(bytes(proof_pv["public_values"][:4]), "little") == fib(9)
    proof = copy.deepcopy(port_vm["proof"])
    mk = proof.per_air[vm.air_index["memory_merkle"]]
    mk.public_values[0] = (mk.public_values[0] + 1) % P
    with pytest.raises(VerificationError):
        vm.verify(proof)


def _tampered(ctxs, vm, to_tensor: bool, air="poseidon2",
              row=TAMPER_ROW, col=TAMPER_COL):
    """``ctxs`` with one cell of ``air``'s trace changed (row -1: the last)."""
    out = copy.copy(ctxs)
    k = next(i for i, c in enumerate(ctxs) if vm.airs[c.air_id].name == air)
    ctx = copy.copy(ctxs[k])
    m = canonical(ctx.common_main).copy()
    m[row, col] = (m[row, col] + 1) % P
    ctx.common_main = bb.monty(m, device="cpu") if to_tensor else m
    out[k] = ctx
    return out


# (AIR, row, column): the merkle root row's is_root (read through
# is_first_row) and the boundary's last has_next_valid (is_last_row)
SELECTOR_TAMPERS = [("memory_merkle", 0, 1), ("persistent_boundary", -1, 1)]


def test_check_constraints_matches_jax(jax_vm, port_vm):
    """No failure on the good contexts.  With one Poseidon2Air cell
    changed, the JAX package's failure strings over every context; with a
    cell read through a natural selector changed, its strings over that
    AIR's context alone (its bus messages then unbalanced too)."""
    vm, jvm = port_vm["vm"], jax_vm[0]
    assert check_constraints(vm.pk, port_vm["ctxs"]) == []
    ours = check_constraints(vm.pk, _tampered(port_vm["ctxs"], vm, True),
                             raise_on_error=False)
    theirs = jdebug.check_constraints(jvm.pk, _tampered(jax_vm[1], jvm, False),
                                      raise_on_error=False)
    assert ours and ours == theirs
    assert ours[0].startswith("air poseidon2: constraint #")
    with pytest.raises(AssertionError, match="constraint debug failures"):
        check_constraints(vm.pk, _tampered(port_vm["ctxs"], vm, True))
    for air, row, col in SELECTOR_TAMPERS:
        ours = [c for c in _tampered(port_vm["ctxs"], vm, True, air, row, col)
                if vm.airs[c.air_id].name == air]
        theirs = [c for c in _tampered(jax_vm[1], jvm, False, air, row, col)
                  if jvm.airs[c.air_id].name == air]
        got = check_constraints(vm.pk, ours, raise_on_error=False)
        assert got[0].startswith(f"air {air}: constraint #"), air
        assert got == jdebug.check_constraints(jvm.pk, theirs, raise_on_error=False), air


def test_debug_prove_refuses_a_bad_trace(port_vm, monkeypatch):
    """``prove(debug=True)`` runs the checker before the STARK prove."""
    vm = port_vm["vm"]
    real = vm._persistent_traces

    def bad(traces, pre, exe, initial_tree=None):
        pvs = real(traces, pre, exe, initial_tree)
        traces["poseidon2"] = traces["poseidon2"].copy()
        traces["poseidon2"][TAMPER_ROW, TAMPER_COL] += 1
        return pvs

    monkeypatch.setattr(vm, "_persistent_traces", bad)
    monkeypatch.setattr(machine, "stark_prove", None)  # never reached
    with pytest.raises(AssertionError, match="air poseidon2: constraint"):
        vm.prove(port_vm["exe"], debug=True)


def test_jax_prove_reproduces_pinned_hash():
    """The JAX package's full persistent VM prove of fib(8) (minutes of
    XLA:CPU compiles; run with OPENVM_SLOW=1)."""
    if not os.environ.get("OPENVM_SLOW"):
        pytest.skip("set OPENVM_SLOW=1 to rerun the JAX package's VM prove")
    vm = jmachine.VirtualMachine(jmachine.Rv32Config(
        stark=JAX_TEST_STARK, persistent=True, executors=FIB_EXECUTORS))
    vm.keygen(cache=False)
    proof, _ = vm.prove(jax_build_fib_program(8))
    assert hashlib.sha256(jcodec.encode_proof(proof)).hexdigest() == \
        PERSISTENT_FIB8_PROOF_SHA256
