"""The port's persistent-memory host pieces against openvm_tpu's: the
sparse Poseidon2 memory tree, the Poseidon2 AIR's trace and padding, and
the continuation entry points' refusal of a preflight core that does not
build."""

import numpy as np
import pytest
import torch

from openvm_tpu.vm import memory_tree as jtree
from openvm_tpu.vm.circuit import poseidon2_chip as jp2chip
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import FriParameters, StarkConfig
from openvm_tpu_torch.vm import memory_tree, native
from openvm_tpu_torch.vm.circuit import poseidon2_chip
from openvm_tpu_torch.vm.guest import FIB_EXECUTORS, build_fib_program
from openvm_tpu_torch.vm.machine import Rv32Config, VirtualMachine

torch.set_num_threads(1)

P = bb.P
TEST_STARK = StarkConfig(fri=FriParameters(log_blowup=1, num_queries=2,
                                           proof_of_work_bits=1))


# -- the memory tree -----------------------------------------------------

def _random_words(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    words = {}
    for _ in range(n):
        a_s = int(rng.integers(1, 4))
        wa = int(rng.integers(0, 64 if a_s == 3 else 1 << 20))
        words[(a_s, wa)] = [int(x) for x in rng.integers(0, 256, size=4)]
    for i in range(8):  # the public-values block
        words[(3, i)] = [int(x) for x in rng.integers(0, 256, size=4)]
    return words


@pytest.mark.parametrize("seed", [0, 1])
def test_memory_tree_matches_jax(seed):
    words = _random_words(seed, 8)
    ours, theirs = memory_tree.SparseMemoryTree(words), jtree.SparseMemoryTree(words)
    root = ours.root()
    assert root.tolist() == theirs.root().tolist()
    for (a_s, wa) in list(words)[:3]:
        cells, proof = ours.open_leaf(a_s, wa)
        j_cells, j_proof = theirs.open_leaf(a_s, wa)
        assert cells.tolist() == j_cells.tolist()
        assert [p.tolist() for p in proof] == [p.tolist() for p in j_proof]
        assert memory_tree.verify_leaf(root, a_s, wa, cells, proof)
        bad = cells.copy()
        bad[0] = (bad[0] + 1) % 256
        assert not memory_tree.verify_leaf(root, a_s, wa, bad, proof)
    pv, j_pv = memory_tree.pv_proof(ours), jtree.pv_proof(theirs)
    assert pv["public_values"] == j_pv["public_values"]
    assert [[p.tolist() for p in o] for o in pv["proofs"]] == \
        [[p.tolist() for p in o] for o in j_pv["proofs"]]
    assert pv["root"].tolist() == j_pv["root"].tolist()
    assert memory_tree.verify_pv_proof(pv) and jtree.verify_pv_proof(pv)
    assert memory_tree.zero_digest(28) == jtree.zero_digest(28)


# -- the Poseidon2 AIR -----------------------------------------------------

def test_poseidon2_trace_and_padding_match_jax():
    """Eight seeded requests: the trace, and the trace padded to 16 rows,
    whose padding rows are zero-state permutations with mult 0."""
    rng = np.random.default_rng(7)
    inputs = rng.integers(0, P, size=(8, 16), dtype=np.uint64)
    mults = rng.integers(0, 4, size=8, dtype=np.uint64)
    ours, theirs = poseidon2_chip.Poseidon2Air(), jp2chip.Poseidon2Air()
    assert ours.width == theirs.width == 494
    t = ours.trace(inputs, mults=mults)
    assert np.array_equal(t, theirs.trace(inputs, mults=mults))
    padded = ours.pad_to(t, 16)
    assert np.array_equal(padded, theirs.pad_to(t, 16))
    zero_row = ours.trace(np.zeros((1, 16), dtype=np.uint64),
                          mults=np.zeros(1, dtype=np.uint64))[0]
    assert padded.shape == (16, 494) and padded[8:].any()
    assert all(np.array_equal(row, zero_row) for row in padded[8:])
    out = ours.output_cols()
    assert np.array_equal(padded[8:, out], np.repeat(
        memory_tree._host().permute(np.zeros(16, dtype=np.uint64))[None], 8, 0))



def test_core_build_failure_raises(tmp_path, monkeypatch):
    """A preflight core that does not build raises in the continuation
    entry points: nothing falls back to the Python loop."""
    bad = tmp_path / "preflight.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "PF_CPP", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(native, "_pf_lib", None)
    vm = VirtualMachine(Rv32Config(stark=TEST_STARK, persistent=True,
                                   executors=FIB_EXECUTORS), device="cpu")
    vm.pk = object()  # no prove is reached: the core is built first
    exe = build_fib_program(4)
    for call in (lambda: vm.prove_continuations(exe),
                 lambda: vm.segment_height_profile(exe),
                 lambda: vm.execute_metered(exe)):
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            call()
