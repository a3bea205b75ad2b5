"""The quotient interpreter (stark.quotient) against the JAX package's
DeviceOps evaluation and group_closure fold: tests/test_torch_quotient.py's
seeded random SymbolicDag of about 200 nodes, with every op, every var
entry, offsets 0 and 1 and next_step 2, evaluated on an 8-row quotient
domain by the JAX package's DeviceOps (eagerly, about 6 s) and by the
port's bytecode interpreter (plain version); the alpha-folded, 1/Z_H-scaled
results are equal word for word.  keccakf's and sw_double_0's quotient
values on a 4-row domain (tests/test_torch_quotient.py's extension cases),
and int256_shift's (the largest int256 AIR, path 7), through their
programs compiled at the budget, equal the JAX package's HostOps (about
4 s).  A file of its own, queued by
``--dist loadfile`` after tests/test_aggregation.py."""

import numpy as np
import pytest
import torch

from openvm_tpu.stark.symbolic import SymbolicDag as JaxDag
from openvm_tpu_torch.field import babybear as bb
from openvm_tpu_torch.stark import quotient
from openvm_tpu_torch.stark.symbolic import SymbolicDag

from test_torch_quotient import (LOG_N, LQD, _extension, _extension_case, _host_ops_quotient,
                                 _jax_fold, _lde, random_dag, random_env)

torch.set_num_threads(1)


def test_bytecode_interpreter_equals_jax():
    nodes, roots = random_dag(0)
    env = random_env(1)
    jfold = _jax_fold(JaxDag(nodes=nodes, constraint_roots=roots), env)
    dag = SymbolicDag(nodes=nodes, constraint_roots=roots)
    prog = quotient.compile_dag(
        dag, n_main=2, has_preprocessed=True, has_perm=True,
        publics=env["publics"], challenges=env["challenges"],
        exposed=env["exposed"], alpha=env["alpha"])
    assert prog.sel_mask == 0b111 and prog.n_sources == 4
    ops = set(prog.code[:, 0].tolist())
    want = set(range(25)) - {quotient.STORE_B}
    assert ops == want, sorted(want ^ ops)
    sources = [_lde(m) for m in env["main"]] + [_lde(env["preprocessed"]),
                                                _lde(env["perm"])]
    got = quotient.evaluate(prog, sources, LOG_N, LQD)
    np.testing.assert_array_equal(jfold, bb.to_numpy(got))


@pytest.mark.parametrize("name", ["keccakf", "sw_double_0", "int256_shift"])
def test_extension_air_quotient_equals_host_ops(name):
    prog = _extension(name)[3]
    assert prog.budget == quotient.BUDGET and prog.reloads
    air, jdag, canon, log_n, lqd, got = _extension_case(name, 31)
    want = _host_ops_quotient(air, jdag, canon, log_n, lqd)
    np.testing.assert_array_equal(got.astype(np.uint64), want)
