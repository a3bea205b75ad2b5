"""DAG evaluation at one point, for the verifier.

Port of openvm_tpu/stark/evaluator.py:156-190 (``HostOps``): a SymbolicDag
evaluated pointwise at the out-of-domain point zeta.  Values are (4,)
canonical uint64 extension elements and the arithmetic is ``npext``'s, the
verifier's one host extension arithmetic.

The JAX package's ``DeviceOps`` (evaluator.py:29) evaluates the DAG over
trace rows; in the port that is the quotient interpreter
(``stark.quotient``), whose plain version the tests hold against the JAX
``DeviceOps``.  ``jit_dag_columns`` (no callers) and ``jit_dag_lookup_hist``
(the VM's lookup histograms) are not here.
"""

from __future__ import annotations

from . import npext as nx

_ZERO = nx.from_base(0)


class HostOps:
    """env keys (everything already at zeta, (4,) canonical uint64):
      main: list of (local_row, next_row) pairs of lists of ext values
      preprocessed: (local, next) or None
      perm: (local, next) lists of ext values (unflattened) or None
      publics: list of ints
      challenges: list of ext values
      exposed: list of ext values
      sels: {'is_first_row', 'is_last_row', 'is_transition'}: ext values
    """

    @staticmethod
    def const(v: int):
        return nx.from_base(v % nx.P)

    @staticmethod
    def var(env, entry, part, offset, index):
        if entry == "main":
            return env["main"][part][offset][index]
        if entry == "preprocessed":
            return env["preprocessed"][offset][index]
        if entry == "permutation":
            return env["perm"][offset][index]
        if entry == "public":
            return nx.from_base(env["publics"][index] % nx.P)
        if entry == "challenge":
            return env["challenges"][index]
        if entry == "exposed":
            return env["exposed"][index]
        raise KeyError(entry)

    @staticmethod
    def sel(env, which):
        return env["sels"][which]

    add = staticmethod(nx.nadd)
    sub = staticmethod(nx.nsub)
    mul = staticmethod(nx.nmul)

    @staticmethod
    def neg(a):
        return nx.nsub(_ZERO, a)
