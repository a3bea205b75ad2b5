"""The JAX package's power series (``_ext_pows_jit``) against the port's:
at n = 1, 5 and 16 the port's ``ef.powers`` equals it, and at n = 1000
for tests/test_torch_ext.py's three elements its words have the SHA-256
that test_torch_ext.py pins (``POW_SHA256``) and holds K2's model to.
Each n is an XLA compile of seconds (about 15 s at n = 1000), so these
tests have a file of their own, queued by ``--dist loadfile`` after
tests/test_aggregation.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvm_tpu.stark.prover import _ext_pows_jit

from openvm_tpu_torch.field import ext as ef

from test_torch_ext import POW_N, POW_SHA256, POW_U, _elems, _port, _same, words_sha256

torch.set_num_threads(1)


@pytest.mark.parametrize("which", list(POW_U))
def test_jax_ext_pows_equal_pins(which):
    got = np.asarray(_ext_pows_jit(jnp.asarray(POW_U[which]), POW_N))
    assert got.shape == (POW_N, 4)
    assert words_sha256(got) == POW_SHA256[which]


@pytest.mark.parametrize("n", [1, 5, 16])
def test_powers_equal_jax_ext_pows(n):
    u = _elems(8, n=1)[-1]
    _same(_ext_pows_jit(jnp.asarray(u), n), ef.powers(_port(u), n))
