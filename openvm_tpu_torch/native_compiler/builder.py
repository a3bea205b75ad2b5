"""Program builder for the native (recursion) VM.

Copy of openvm_tpu/native_compiler/builder.py:1-416 (``Felt``, ``Ext``,
``FeltArray``, ``Label``, ``Builder`` with its labels, felt and extension
arithmetic, loads and stores, hints, ``fri_reduced_opening``,
``verify_batch``, ``write_batch_descriptor``, ``permute``, ``compress``,
assertions and ``compile``) on the port's ``vm.instructions``, with one
repair: ``permute`` and ``compress`` emit e = 4, the address space that
NativePoseidon2Air's fetch names (vm/circuit/native.py); the JAX package's
emit e = 0 (builder.py:320-329), and a program that uses them fails the
program bus's balance.  One addition, not in the JAX Builder: ``jal``, a
JAL to a label that leaves pc + 4 in a felt (``jump`` is a BEQ and
links nothing).

Emits `openvm_tpu_torch.vm.instructions.Instruction`s over the native ISA
(FieldArithmetic / FieldExtension / NativeBranchEq / NativeLoadStore /
JalRangeCheck / Poseidon2 / phantoms — see vm/circuit/native.py).  Memory
is the felt-granular AS-4 space; values are handles to cells.

Design notes (vs reference extensions/native/compiler):
  * No Var/Felt distinction: everything is a felt cell; Ext is a 4-cell
    block (the FieldExtension chip's layout).
  * Scoped bump allocation (`with b.scope()`) reuses temp addresses, which
    keeps the volatile-boundary trace (one row per touched cell) small —
    the TPU-side cost model rewards a small working set, unlike the
    reference's monotone stack frames.
  * Asserts branch to a shared fail block that TERMINATEs with exit code
    1; the host `machine.verify` only accepts exit code 0.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..vm.instructions import (FieldArithmeticOpcode as FA,
                               FieldExtensionOpcode as FE, Instruction,
                               NativeBranchEqOpcode as NB,
                               NativeJalOpcode, NativeLoadStore4Opcode as L4,
                               NativeLoadStoreOpcode as L1, NativePhantom,
                               NativeRangeCheckOpcode, P, Poseidon2Opcode,
                               Program, SystemOpcode, VmExe, phantom)

AS_NATIVE = 4


@dataclass(frozen=True)
class Felt:
    addr: int


@dataclass(frozen=True)
class Ext:
    addr: int  # 4 consecutive cells [addr .. addr+4)

    def felt(self, i: int) -> Felt:
        return Felt(self.addr + i)


@dataclass(frozen=True)
class FeltArray:
    addr: int
    n: int

    def felt(self, i: int) -> Felt:
        assert 0 <= i < self.n
        return Felt(self.addr + i)

    def slice(self, start: int, n: int) -> "FeltArray":
        assert start + n <= self.n
        return FeltArray(self.addr + start, n)


class Label:
    __slots__ = ("pos",)

    def __init__(self):
        self.pos = None


class Builder:
    def __init__(self, mem_base: int = 1 << 20):
        self.insns: list = []
        # (insn_index, operand_name, label): patch c/b with pc-relative off
        self._fixups: list = []
        self._hwm = mem_base  # bump allocator high-water mark
        self._scopes: list = []
        self._fail = Label()
        self._const_cache: dict = {}

    # -- allocation ------------------------------------------------------
    def alloc(self, n: int = 1) -> int:
        a = self._hwm
        self._hwm += n
        return a

    def felt(self) -> Felt:
        return Felt(self.alloc(1))

    def ext(self) -> Ext:
        return Ext(self.alloc(4))

    def array(self, n: int) -> FeltArray:
        return FeltArray(self.alloc(n), n)

    def scope(self):
        b = self

        class _Scope:
            def __enter__(self):
                b._scopes.append((b._hwm, dict(b._const_cache)))
                return self

            def __exit__(self, *exc):
                b._hwm, b._const_cache = b._scopes.pop()
                return False

        return _Scope()

    # -- emission --------------------------------------------------------
    def emit(self, insn: Instruction):
        self.insns.append(insn)

    def label(self) -> Label:
        return Label()

    def place(self, lbl: Label):
        assert lbl.pos is None, "label placed twice"
        lbl.pos = len(self.insns)

    def _branch(self, op: int, x, y, lbl: Label):
        """Branch if felt comparison holds.  x/y: Felt or int imm."""
        a, d = (x.addr, 4) if isinstance(x, Felt) else (int(x) % P, 0)
        bb_, e = (y.addr, 4) if isinstance(y, Felt) else (int(y) % P, 0)
        self._fixups.append((len(self.insns), "c", lbl))
        self.emit(Instruction(op, a=a, b=bb_, c=0, d=d, e=e))

    def branch_eq(self, x, y, lbl: Label):
        self._branch(NB.BEQ, x, y, lbl)

    def branch_ne(self, x, y, lbl: Label):
        self._branch(NB.BNE, x, y, lbl)

    def jump(self, lbl: Label):
        """Unconditional jump (BEQ 0 == 0)."""
        self._branch(NB.BEQ, 0, 0, lbl)

    def jal(self, lbl: Label, link: Felt):
        """JAL to ``lbl``, pc + 4 into ``link`` (port-only; see the module
        docstring)."""
        self._fixups.append((len(self.insns), "b", lbl))
        self.emit(Instruction(NativeJalOpcode.JAL, a=link.addr, b=0, d=4))

    # -- felt arithmetic -------------------------------------------------
    def _arith(self, op: int, x, y, dst: Felt | None, dst_as: int = 4):
        bb_, e = (x.addr, 4) if isinstance(x, Felt) else (int(x) % P, 0)
        cc, f = (y.addr, 4) if isinstance(y, Felt) else (int(y) % P, 0)
        d = dst or self.felt()
        self.emit(Instruction(op, a=d.addr, b=bb_, c=cc, d=dst_as, e=e, f=f))
        return d

    def add(self, x, y, dst: Felt | None = None) -> Felt:
        return self._arith(FA.ADD, x, y, dst)

    def sub(self, x, y, dst: Felt | None = None) -> Felt:
        return self._arith(FA.SUB, x, y, dst)

    def mul(self, x, y, dst: Felt | None = None) -> Felt:
        return self._arith(FA.MUL, x, y, dst)

    def div(self, x, y, dst: Felt | None = None) -> Felt:
        return self._arith(FA.DIV, x, y, dst)

    def mov(self, x, dst: Felt | None = None) -> Felt:
        return self._arith(FA.ADD, x, 0, dst)

    def const(self, v: int) -> Felt:
        """Materialized constant, cached per scope."""
        v = int(v) % P
        if v not in self._const_cache:
            self._const_cache[v] = self.add(v, 0)
        return self._const_cache[v]

    # -- ext arithmetic (4-cell blocks) ----------------------------------
    def _earith(self, op: int, x: Ext, y: Ext, dst: Ext | None) -> Ext:
        d = dst or self.ext()
        self.emit(Instruction(op, a=d.addr, b=x.addr, c=y.addr, d=4, e=4))
        return d

    def eadd(self, x: Ext, y: Ext, dst: Ext | None = None) -> Ext:
        return self._earith(FE.FE4ADD, x, y, dst)

    def esub(self, x: Ext, y: Ext, dst: Ext | None = None) -> Ext:
        return self._earith(FE.FE4SUB, x, y, dst)

    def emul(self, x: Ext, y: Ext, dst: Ext | None = None) -> Ext:
        return self._earith(FE.BBE4MUL, x, y, dst)

    def ediv(self, x: Ext, y: Ext, dst: Ext | None = None) -> Ext:
        return self._earith(FE.BBE4DIV, x, y, dst)

    def ext_from(self, felts, dst: Ext | None = None) -> Ext:
        """Build an ext from 4 Felt|int coefficients."""
        d = dst or self.ext()
        for i, v in enumerate(felts):
            self.mov(v, Felt(d.addr + i))
        return d

    def econst(self, coeffs) -> Ext:
        return self.ext_from([int(v) % P for v in coeffs])

    def emul_felt(self, x: Ext, s, dst: Ext | None = None) -> Ext:
        """Scale ext by felt (4 base muls)."""
        d = dst or self.ext()
        for i in range(4):
            self.mul(x.felt(i), s, Felt(d.addr + i))
        return d

    # -- memory ----------------------------------------------------------
    def loadw(self, ptr: Felt, off: int = 0, dst: Felt | None = None) -> Felt:
        """dst = mem[[ptr] + off] (dynamic indexing)."""
        d = dst or self.felt()
        self.emit(Instruction(L1.LOADW, a=d.addr, b=off % P, c=ptr.addr,
                              d=4, e=4, f=4))
        return d

    def storew(self, val: Felt, ptr: Felt, off: int = 0):
        """mem[[ptr] + off] = val."""
        self.emit(Instruction(L1.STOREW, a=val.addr, b=off % P, c=ptr.addr,
                              d=4, e=4, f=4))

    def loadw4(self, ptr: Felt, off: int = 0, dst: Ext | None = None) -> Ext:
        d = dst or self.ext()
        self.emit(Instruction(L4.LOADW4, a=d.addr, b=off % P, c=ptr.addr,
                              d=4, e=4, f=4))
        return d

    def storew4(self, val: Ext, ptr: Felt, off: int = 0):
        self.emit(Instruction(L4.STOREW4, a=val.addr, b=off % P, c=ptr.addr,
                              d=4, e=4, f=4))

    # -- hints -----------------------------------------------------------
    def hint_input(self):
        self.emit(phantom(NativePhantom.HINT_INPUT))

    def hint_storew(self, dst: Felt):
        self.emit(Instruction(L1.HINT_STOREW, a=0, b=0, c=dst.addr, d=4,
                              e=4, f=0))

    def hint_storew4(self, dst_addr: int):
        self.emit(Instruction(L4.HINT_STOREW4, a=0, b=0, c=dst_addr, d=4,
                              e=4, f=0))

    def read_hints(self, n: int) -> FeltArray:
        """Read n felts from the current hint stream into a fresh array
        (block-4 stores for the bulk, single stores for the tail)."""
        return self.read_hints_into(self.array(n))

    def read_hints_into(self, arr: FeltArray) -> FeltArray:
        i = 0
        while i + 4 <= arr.n:
            self.hint_storew4(arr.addr + i)
            i += 4
        while i < arr.n:
            self.hint_storew(Felt(arr.addr + i))
            i += 1
        return arr

    def read_vec(self, n: int) -> FeltArray:
        """Pop the next input vector (must have exactly n felts) into the
        hint stream and read it.  One serializer group <-> one read_vec.
        Uses the header-less HINT_FELT load so interleaved HINT_BITS
        decompositions never clobber pending proof data."""
        self.emit(phantom(NativePhantom.HINT_FELT))
        return self.read_hints(n)

    def read_vec_into(self, arr: FeltArray) -> FeltArray:
        """read_vec into a pre-allocated buffer (lets loop bodies reuse
        one address range, e.g. per-query FRI openings)."""
        self.emit(phantom(NativePhantom.HINT_FELT))
        return self.read_hints_into(arr)

    # -- fri -------------------------------------------------------------
    def fri_reduced_opening(self, a_arr: FeltArray, b_arr: FeltArray,
                            length: int, alpha: Ext,
                            dst: Ext | None = None) -> Ext:
        """dst = sum_{t<length} alpha^t * (b_ext[t] - a_felt[t]) as ONE
        instruction (vm/circuit/native.py FriReducedOpeningAir; reference
        opcode FRI_REDUCED_OPENING, extensions/native/compiler/src/
        lib.rs:196-199).  b_arr is 4*length felts (ext element t at
        4t..4t+4); a/b/alpha/dst regions must not alias."""
        assert a_arr.n >= length and b_arr.n >= 4 * length
        d = dst or self.ext()
        from ..vm.instructions import FriOpcode
        self.emit(Instruction(FriOpcode.FRI_REDUCED_OPENING, a=a_arr.addr,
                              b=b_arr.addr, c=length, d=alpha.addr,
                              e=d.addr))
        return d

    def verify_batch(self, desc: FeltArray, sibs: FeltArray,
                     bits_addr: int, commit_addr: int, depth: int,
                     inside_rows: int = 0):
        """Whole Merkle batch opening as ONE instruction (vm/circuit/
        native.py VerifyBatchAir; reference VERIFY_BATCH,
        extensions/native/circuit/src/extension/mod.rs:89-99).

        desc: 3*(depth+1) felts — (has_seg, seg_ptr, seg_len) per level;
        sibs: 8*depth hinted sibling digests; bits_addr: depth index bits
        (low first); commit_addr: 8 felts; inside_rows: total sponge rows
        (metadata for static height profiling, operand f)."""
        assert desc.n >= 3 * (depth + 1) and sibs.n >= 8 * depth
        from ..vm.instructions import VerifyBatchOpcode
        self.emit(Instruction(VerifyBatchOpcode.VERIFY_BATCH, a=desc.addr,
                              b=sibs.addr, c=bits_addr, d=commit_addr,
                              e=depth, f=inside_rows))

    def write_batch_descriptor(self, segs: dict, depth: int) -> FeltArray:
        """Materialize a VERIFY_BATCH descriptor: segs maps level ->
        (seg_addr, seg_len) for levels 0..depth (level 0 mandatory).
        Returns the descriptor array (3*(depth+1) felts)."""
        assert 0 in segs and max(segs) <= depth
        desc = self.array(3 * (depth + 1))
        for s in range(depth + 1):
            if s in segs:
                addr, ln = segs[s]
                self.mov(1, desc.felt(3 * s))
                self.mov(addr, desc.felt(3 * s + 1))
                self.mov(ln, desc.felt(3 * s + 2))
            else:
                for k in range(3):
                    self.mov(0, desc.felt(3 * s + k))
        return desc

    # -- poseidon2 -------------------------------------------------------
    def permute(self, src: FeltArray, dst: FeltArray | None = None
                ) -> FeltArray:
        assert src.n == 16
        d = dst or self.array(16)
        self.emit(Instruction(Poseidon2Opcode.PERM_POS2, a=d.addr,
                              b=src.addr, c=0, d=4, e=4))
        return d

    def compress(self, left: FeltArray, right: FeltArray,
                 dst: FeltArray | None = None) -> FeltArray:
        assert left.n == 8 and right.n == 8
        d = dst or self.array(8)
        self.emit(Instruction(Poseidon2Opcode.COMP_POS2, a=d.addr,
                              b=left.addr, c=right.addr, d=4, e=4))
        return d

    # -- assertions ------------------------------------------------------
    def assert_eq(self, x, y):
        self.branch_ne(x, y, self._fail)

    def assert_ne(self, x, y):
        self.branch_eq(x, y, self._fail)

    def assert_eq_ext(self, x: Ext, y: Ext):
        for i in range(4):
            self.assert_eq(x.felt(i), y.felt(i))

    def assert_eq_arr(self, x: FeltArray, y: FeltArray):
        assert x.n == y.n
        for i in range(x.n):
            self.assert_eq(x.felt(i), y.felt(i))

    def range_check(self, x: Felt, lo_bits: int, hi_bits: int):
        """Assert x < 2^(15+hi_bits) via lo_bits/hi_bits split
        (lo_bits <= 15, hi_bits <= 15; JalRangeCheck chip)."""
        self.emit(Instruction(NativeRangeCheckOpcode.RANGE_CHECK, a=x.addr,
                              b=lo_bits, c=hi_bits, d=4))

    def bits_le(self, x: Felt, n: int = 32) -> FeltArray:
        """Constrained little-endian bit decomposition (n bits).

        Bits come in as hints (NativePhantom.HINT_BITS), then each is
        constrained boolean and the recomposition is asserted equal to x.
        For n = 32 this proves the bits are THE canonical decomposition
        only together with a bound on x; callers that need canonicity
        must range-check or rely on x < P (sampled felts).
        """
        self.emit(phantom(NativePhantom.HINT_BITS, a=x.addr, b=n))
        bits = self.read_hints(n)
        with self.scope():
            for i in range(n):
                t = self.mul(bits.felt(i), bits.felt(i))
                self.assert_eq(t, bits.felt(i))
            acc = self.mov(0)
            for i in reversed(range(n)):
                acc = self.add(self.mul(acc, 2), bits.felt(i))
            self.assert_eq(acc, x)
        return bits

    # -- misc ------------------------------------------------------------
    def select(self, bit: Felt, a, b_, dst: Felt | None = None) -> Felt:
        """dst = bit ? a : b  (bit must already be boolean-constrained)."""
        with self.scope():
            d = self.sub(a, b_)
            t = self.mul(bit, d)
        return self.add(t, b_, dst)

    def public_value(self, x, idx: int):
        """pv[idx] = x (felt write into AS 3)."""
        bb_, e = (x.addr, 4) if isinstance(x, Felt) else (int(x) % P, 0)
        self.emit(Instruction(FA.ADD, a=idx, b=bb_, c=0, d=3, e=e, f=0))

    def halt(self, code: int = 0):
        self.emit(Instruction(SystemOpcode.TERMINATE, c=code))

    def print_felt(self, x: Felt):
        self.emit(phantom(NativePhantom.PRINT, a=x.addr, c_upper=4))

    def ct_start(self, span_id: int = 0):
        """Cycle-tracker span start (reference SysPhantom::CtStart,
        crates/vm/src/metrics/cycle_tracker): instret-cost attribution for
        program regions, surfaced as `cycles{cycle_tracker_span=...}`."""
        from ..vm.instructions import SysPhantom
        self.emit(phantom(SysPhantom.CT_START, c_upper=span_id))

    def ct_end(self):
        from ..vm.instructions import SysPhantom
        self.emit(phantom(SysPhantom.CT_END))

    # -- finalize --------------------------------------------------------
    def compile(self, pc_base: int = 0) -> VmExe:
        """Patch label fix-ups, append the fail block, return a VmExe."""
        if self._fail.pos is None:
            self.place(self._fail)
            self.halt(1)
        for (idx, operand, lbl) in self._fixups:
            assert lbl.pos is not None, "branch to unplaced label"
            off = (lbl.pos - idx) * 4
            setattr(self.insns[idx], operand, off % P)
        prog = Program(instructions=list(self.insns), pc_base=pc_base)
        return VmExe(program=prog, pc_start=pc_base)
