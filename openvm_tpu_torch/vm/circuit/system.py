"""System AIRs: program ROM, connector, memory boundary, public values,

Copy of openvm_tpu/vm/circuit/system.py (the whole module).

range checker, bitwise lookup, phantom.

Re-designs of the reference system chips (SURVEY.md section 2.1):
  ProgramAir    reference crates/vm/src/system/program/air.rs:37 (cached
                main trace committed once per program)
  ConnectorAir  reference crates/vm/src/system/connector/mod.rs:35-60
  VolatileBoundaryAir  reference crates/vm/src/system/memory/volatile
  PublicValuesAir      reference crates/vm/src/system/public_values
  RangeChecker / BitwiseLookup  reference crates/circuits/primitives
  PhantomAir    reference crates/vm/src/system/phantom/mod.rs:49
"""

from __future__ import annotations

import numpy as np

from ...stark.symbolic import Air
from ..instructions import SystemOpcode
from . import buses as B
from .buses import Cols

P = 2013265921


class ProgramAir(Air):
    """Program ROM: cached main [pc, opcode, a..g] (width 9), common main
    [multiplicity].  Receives one fetch per executed instruction."""

    name = "program"
    cached_main_widths = (9,)
    width = 1

    def eval(self, b):
        cached = [b.main(i, part=0) for i in range(9)]
        mult = b.main(0)
        b.push_receive(B.PROGRAM_BUS, cached, mult)


def program_cached_trace(program, height: int | None = None) -> np.ndarray:
    """(H, 9) canonical rows [pc, opcode, a,b,c,d,e,f,g], pow2-padded
    (or padded to a fixed `height` for aggregation-VM shape pinning)."""
    n = len(program.instructions)
    h = max(1, 1 << (n - 1).bit_length()) if n else 1
    if height is not None:
        assert height >= h, f"program {n} insns exceeds fixed {height}"
        h = height
    rows = np.zeros((h, 9), dtype=np.uint64)
    for i, insn in enumerate(program.instructions):
        if insn is None:
            continue
        rows[i, 0] = program.pc_base + i * program.step
        rows[i, 1] = insn.opcode
        rows[i, 2:9] = [x % P for x in insn.operands()]
    return rows


class ConnectorAir(Air):
    """2-row begin/end chip.

    Row 0: sends (initial_pc, INITIAL_TIMESTAMP) on the execution bus.
    Row 1: receives (final_pc, final_ts); exposes exit code.
    PVs: [initial_pc, final_pc, exit_code, is_terminate].

    When is_terminate=1 the end row additionally looks up
    (final_pc, TERMINATE, [0, 0, exit_code]) on the program bus so a prover
    cannot stop at an arbitrary pc and claim termination (reference
    crates/vm/src/system/connector/mod.rs lookup_instruction).  The end
    timestamp is range-checked to TIMESTAMP_BITS so the total timestamp
    cannot wrap the field (reference range-checks both boundary
    timestamps).

    Interaction counts must be polynomial, so 0/1 indicator *columns*
    is_begin/is_end are pinned to rows 0/1 with selector-gated constraints
    (selectors themselves are rational and only legal inside constraints).
    """

    name = "connector"
    width = 8  # pc, ts, exit_code, is_terminate, is_begin, is_end,
    #            ts_lo, ts_hi
    num_public_values = 4

    def eval(self, b):
        pc, ts, exit_code, is_term, is_begin, is_end, ts_lo, ts_hi = (
            b.main(i) for i in range(8))
        first = b.is_first_row()
        last = b.is_last_row()
        trans = b.is_transition()
        b.assert_bool(is_begin)
        b.assert_bool(is_end)
        b.assert_zero(first * (is_begin - 1))
        b.assert_zero(trans * b.main(4, offset=1))  # is_begin next rows = 0
        b.assert_zero(last * (is_end - 1))
        b.assert_zero(trans * is_end)  # is_end zero except last row

        B.exec_send(b, pc, ts, is_begin)
        B.exec_receive(b, pc, ts, is_end)
        b.assert_zero(first * (ts - B.INITIAL_TIMESTAMP))
        b.assert_zero(first * (pc - b.public_value(0)))
        b.assert_zero(last * (pc - b.public_value(1)))
        b.assert_zero(last * (exit_code - b.public_value(2)))
        b.assert_zero(last * (is_term - b.public_value(3)))
        b.assert_bool(is_term)
        # terminating end state must fetch a TERMINATE instruction with
        # this exit code from the program ROM
        B.fetch(b, pc, SystemOpcode.TERMINATE,
                [0, 0, exit_code, 0, 0, 0, 0], is_end * is_term)
        # end timestamp fits TIMESTAMP_BITS (no field wrap-around)
        b.assert_zero(is_end * (ts - ts_lo
                                - ts_hi * (1 << B.RANGE_LO_BITS)))
        B.range_check(b, ts_lo, B.RANGE_LO_BITS, is_end)
        B.range_check(b, ts_hi, B.TIMESTAMP_BITS - B.RANGE_LO_BITS, is_end)


def connector_trace(initial_pc, final_pc, final_ts, exit_code, is_terminate):
    rows = np.zeros((2, 8), dtype=np.uint64)
    rows[0] = [initial_pc, B.INITIAL_TIMESTAMP, 0, 0, 1, 0, 0, 0]
    rows[1] = [final_pc, final_ts, exit_code, is_terminate, 0, 1,
               final_ts & ((1 << B.RANGE_LO_BITS) - 1),
               final_ts >> B.RANGE_LO_BITS]
    return rows


class VolatileBoundaryAir(Air):
    """Initial/final word states for address spaces 1 (registers) and 2.

    Each valid row: one (as, word_addr): sends the initial state at t=0,
    receives the final state at final_ts.  Rows sorted strictly by the
    composite key as*2^27 + word_addr (uniqueness; reference
    system/memory/volatile/mod.rs:62 sorted-address argument).
    """

    name = "memory_boundary"
    # is_valid, as, addr, init[4], final[4], final_ts, key_diff_lo,
    # key_diff_hi, has_next_valid
    width = 15

    def eval(self, b):
        c = Cols()
        is_valid = b.main(c.alloc("is_valid"))
        aspace = b.main(c.alloc("as"))
        addr = b.main(c.alloc("addr"))
        init = [b.main(i) for i in c.alloc("init", 4)]
        final = [b.main(i) for i in c.alloc("final", 4)]
        final_ts = b.main(c.alloc("final_ts"))
        dlo = b.main(c.alloc("key_diff_lo"))
        dhi = b.main(c.alloc("key_diff_hi"))
        hnv = b.main(c.alloc("has_next_valid"))

        b.assert_bool(is_valid)
        # valid rows come first
        nv = b.main(c.index["is_valid"], offset=1)
        b.assert_zero(b.is_transition() * nv * (1 - is_valid))
        # hnv = next row's is_valid (0 on the last row) — polynomial gate
        # usable as an interaction count
        b.assert_bool(hnv)
        b.assert_zero(b.is_transition() * (hnv - nv))
        b.assert_zero(b.is_last_row() * hnv)

        b.push_send(B.MEMORY_BUS, [aspace, addr] + init + [0], is_valid)
        b.push_receive(B.MEMORY_BUS, [aspace, addr] + final + [final_ts],
                       is_valid)
        # initial data limbs are bytes
        B.byte_pair_check(b, init[0], init[1], is_valid)
        B.byte_pair_check(b, init[2], init[3], is_valid)

        # strict key ordering between consecutive valid rows
        key = aspace * (1 << 27) + addr
        next_as = b.main(c.index["as"], offset=1)
        next_addr = b.main(c.index["addr"], offset=1)
        next_key = next_as * (1 << 27) + next_addr
        b.assert_zero(b.is_transition() * hnv
                      * (next_key - key - 1 - dlo - dhi * (1 << 15)))
        B.range_check(b, dlo, 15, hnv)
        B.range_check(b, dhi, 15, hnv)


class PublicValuesAir(Air):
    """Boundary for address space 3 (user public values; REVEAL target).

    Height = num_pv_words; preprocessed trace = [row_index | one-hot I].
    Row i: sends (3, i, zeros, t=0), receives (3, i, data, final_ts); the
    one-hot columns bind data limbs to the AIR public values.
    """

    name = "public_values"

    def __init__(self, num_words: int = 8):
        self.num_words = num_words
        self.width = 8  # data[4], final_ts, dlo, dhi, unused
        self.num_public_values = 4 * num_words

    def preprocessed_trace(self):
        n = self.num_words
        t = np.zeros((n, 1 + n), dtype=np.uint64)
        t[:, 0] = np.arange(n)
        t[:, 1:] = np.eye(n, dtype=np.uint64)
        return t

    def eval(self, b):
        idx = b.preprocessed(0)
        onehot = [b.preprocessed(1 + i) for i in range(self.num_words)]
        data = [b.main(i) for i in range(4)]
        final_ts = b.main(4)

        b.push_send(B.MEMORY_BUS, [B.AS_PUBLIC, idx, 0, 0, 0, 0, 0], 1)
        b.push_receive(B.MEMORY_BUS, [B.AS_PUBLIC, idx] + data + [final_ts],
                       1)
        for i, flag in enumerate(onehot):
            for j in range(4):
                b.assert_zero(flag * (data[j] - b.public_value(4 * i + j)))


class RangeCheckerAir(Air):
    """Variable range lookup table: preprocessed (value, bits) pairs for all
    bits <= MAX_BITS; receives (value, bits) with multiplicity."""

    name = "range_checker"
    MAX_BITS = 15
    width = 1  # multiplicity

    def preprocessed_trace(self):
        rows = [(0, 0)]
        for bits in range(1, self.MAX_BITS + 1):
            vals = np.arange(1 << bits, dtype=np.uint64)
            rows.append(np.stack(
                [vals, np.full(1 << bits, bits, dtype=np.uint64)], axis=1))
        first = np.array([[0, 0]], dtype=np.uint64)
        t = np.concatenate([first] + rows[1:], axis=0)
        h = 1 << (len(t) - 1).bit_length()
        pad = np.zeros((h - len(t), 2), dtype=np.uint64)  # (0, 0) rows
        return np.concatenate([t, pad], axis=0)

    def eval(self, b):
        value = b.preprocessed(0)
        bits = b.preprocessed(1)
        mult = b.main(0)
        b.push_receive(B.RANGE_BUS, [value, bits], mult)


class RangeTupleCheckerAir(Air):
    """Tuple range lookup table (reference crates/circuits/primitives/src/
    range_tuple/mod.rs): preprocessed rows enumerate every (x, y) with
    x < sizes[0], y < sizes[1] (row-major); receives (x, y) with
    multiplicity on RANGE_TUPLE_BUS.  One interaction checks both bounds —
    used by the mul chips for (product limb, carry) pairs
    (reference extensions/rv32im/circuit/src/mulh/core.rs:117-140)."""

    name = "range_tuple"
    width = 1  # multiplicity

    def __init__(self, sizes=(256, 2048)):
        self.sizes = tuple(int(s) for s in sizes)
        assert all(s & (s - 1) == 0 for s in self.sizes)

    def preprocessed_trace(self):
        sx, sy = self.sizes
        x = np.repeat(np.arange(sx, dtype=np.uint64), sy)
        y = np.tile(np.arange(sy, dtype=np.uint64), sx)
        return np.stack([x, y], axis=1)

    def eval(self, b):
        x, y = b.preprocessed(0), b.preprocessed(1)
        mult = b.main(0)
        b.push_receive(B.RANGE_TUPLE_BUS, [x, y], mult)


class BitwiseLookupAir(Air):
    """Byte pair table: preprocessed (x, y, x^y); receives range pairs
    (count mult_range) and xor triples (count mult_xor)."""

    name = "bitwise_lookup"
    width = 2  # mult_range, mult_xor

    def preprocessed_trace(self):
        x = np.repeat(np.arange(256, dtype=np.uint64), 256)
        y = np.tile(np.arange(256, dtype=np.uint64), 256)
        return np.stack([x, y, x ^ y], axis=1)

    def eval(self, b):
        x, y, z = b.preprocessed(0), b.preprocessed(1), b.preprocessed(2)
        mult_range, mult_xor = b.main(0), b.main(1)
        b.push_receive(B.BITWISE_BUS, [x, y, 0, 0], mult_range)
        b.push_receive(B.BITWISE_BUS, [x, y, z, 1], mult_xor)


class PhantomAir(Air):
    """No-op instructions: advance pc by 4 and timestamp by 1."""

    name = "phantom"
    width = 10  # is_valid, pc, ts, a, b, c, (operands d..g fixed 0)

    def eval(self, b):
        c = Cols()
        is_valid = b.main(c.alloc("is_valid"))
        pc = b.main(c.alloc("pc"))
        ts = b.main(c.alloc("ts"))
        oa = b.main(c.alloc("a"))
        ob = b.main(c.alloc("b"))
        oc = b.main(c.alloc("c"))
        b.main(c.alloc("pad", 4)[0])
        b.assert_bool(is_valid)
        B.exec_receive(b, pc, ts, is_valid)
        B.exec_send(b, pc + 4, ts + 1, is_valid)
        B.fetch(b, pc, 1, [oa, ob, oc, 0, 0, 0, 0], is_valid)
