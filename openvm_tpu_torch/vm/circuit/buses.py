"""VM bus layout + shared adapter constraint helpers.

Copy of openvm_tpu/vm/circuit/buses.py (the whole module).

Bus architecture mirrors the reference (SURVEY.md section 0: "the execution
bus carries (pc, timestamp) state transitions between chips"; memory bus =
offline checking with timestamps, reference
crates/vm/src/system/memory/offline_checker/bus.rs):

  EXECUTION_BUS: (pc, timestamp).  Each executed instruction row receives its
    pre-state and sends its post-state; the connector sends the initial state
    and receives the final one.
  PROGRAM_BUS: (pc, opcode, a..g).  Executors send a fetch per executed row;
    the program chip receives with its execution-count column.
  MEMORY_BUS: (addr_space, word_addr, d0..d3, timestamp).  Word-granular
    (4 byte limbs).  An access receives the previous word state and sends the
    new one; the boundary chip sends initial states (t=0) and receives finals.
    Strict timestamp increase per access is range-checked.
  RANGE_BUS: (value, bits) variable range lookups (bits <= 16).
  BITWISE_BUS: (x, y, z, is_xor): is_xor=1 -> z = x^y; is_xor=0 -> byte range
    pair (z=0).  AND/OR derive linearly from XOR.

All executor chips use the helpers below so timestamp bookkeeping and aux
column layouts stay uniform between the AIRs and the preflight recorder.
"""

from __future__ import annotations

EXECUTION_BUS = 0
PROGRAM_BUS = 1
MEMORY_BUS = 2
RANGE_BUS = 3
BITWISE_BUS = 4
RANGE_TUPLE_BUS = 10  # (x, y) pair range lookups (reference range_tuple)

INITIAL_TIMESTAMP = 1  # boundary initial states carry timestamp 0

AS_REGISTER = 1
AS_MEMORY = 2
AS_PUBLIC = 3

TIMESTAMP_BITS = 29


class Cols:
    """Sequential named column allocator for a chip's common main trace."""

    def __init__(self):
        self.names: list[str] = []
        self.index: dict[str, int] = {}

    def alloc(self, name: str, n: int = 1):
        start = len(self.names)
        for i in range(n):
            self.names.append(f"{name}[{i}]" if n > 1 else name)
        self.index[name] = start
        return start if n == 1 else list(range(start, start + n))

    @property
    def width(self) -> int:
        return len(self.names)


def exec_receive(b, pc, ts, count):
    b.push_receive(EXECUTION_BUS, [pc, ts], count)


def exec_send(b, to_pc, to_ts, count):
    b.push_send(EXECUTION_BUS, [to_pc, to_ts], count)


def fetch(b, pc, opcode, operands, count):
    b.push_send(PROGRAM_BUS, [pc, opcode] + list(operands), count)


def range_check(b, value, bits, count):
    b.push_send(RANGE_BUS, [value, bits], count)


def byte_pair_check(b, x, y, count):
    b.push_send(BITWISE_BUS, [x, y, 0, 0], count)


def range_tuple_check(b, x, y, count):
    """(x, y) < RangeTupleCheckerAir.sizes in ONE interaction (reference
    crates/circuits/primitives/src/range_tuple: one lookup instead of two
    VariableRangeChecker interactions when the product of sizes is small)."""
    b.push_send(RANGE_TUPLE_BUS, [x, y], count)


def xor_lookup(b, x, y, z, count):
    b.push_send(BITWISE_BUS, [x, y, z, 1], count)


# Wide values decompose as lo (RANGE_LO_BITS) + hi so the range table stays
# at 2^(MAX_RANGE_BITS+1) rows (= FRI max height driver).
RANGE_LO_BITS = 15


def ts_diff_check(b, prev_ts, now_ts, diff_lo, diff_hi, count):
    """prev_ts < now_ts via (now - prev - 1) = lo + hi*2^15, 15+14 bits."""
    b.assert_zero(count * (now_ts - prev_ts - 1 - diff_lo
                           - diff_hi * (1 << RANGE_LO_BITS)))
    range_check(b, diff_lo, RANGE_LO_BITS, count)
    range_check(b, diff_hi, TIMESTAMP_BITS - RANGE_LO_BITS, count)


def mem_read(b, addr_space, word_addr, data, prev_ts, now_ts,
             diff_lo, diff_hi, count):
    """Read a word: receive prev state, send same data at now_ts."""
    b.push_receive(MEMORY_BUS, [addr_space, word_addr] + list(data)
                   + [prev_ts], count)
    b.push_send(MEMORY_BUS, [addr_space, word_addr] + list(data) + [now_ts],
                count)
    ts_diff_check(b, prev_ts, now_ts, diff_lo, diff_hi, count)


def mem_write(b, addr_space, word_addr, new_data, prev_data, prev_ts, now_ts,
              diff_lo, diff_hi, count, check_bytes=True):
    """Write a word: receive prev state, send new data at now_ts."""
    b.push_receive(MEMORY_BUS, [addr_space, word_addr] + list(prev_data)
                   + [prev_ts], count)
    b.push_send(MEMORY_BUS, [addr_space, word_addr] + list(new_data)
                + [now_ts], count)
    ts_diff_check(b, prev_ts, now_ts, diff_lo, diff_hi, count)
    if check_bytes:
        byte_pair_check(b, new_data[0], new_data[1], count)
        byte_pair_check(b, new_data[2], new_data[3], count)


def limbs_to_u32(limbs):
    return (limbs[0] + limbs[1] * (1 << 8) + limbs[2] * (1 << 16)
            + limbs[3] * (1 << 24))
