// K7+K11: the constraint-DAG interpreter over the quotient domain, and its
// columns mode over the natural trace domain.
//
// Replaces openvm_tpu/stark/evaluator.py DeviceOps (:29) as
// SymbolicDag.eval (symbolic.py:398) drives it, fused with the prover's
// alpha fold (stark/prover.py:550-568 group_closure), the Lagrange selectors
// (_selectors_on_domain, prover.py:272) and the 1/Z_H scale (prover.py:648).
// The JAX package compiles each AIR's DAG into its own XLA program; this
// kernel is compiled once and runs any AIR's bytecode (stark/quotient.py
// compiles it), so a new AIR costs no device compile.
//
// Bound: the function needs each node's products and adds per row, the
// selectors (a batch inverse, here a table built once per domain), and the
// fold with precomputed powers of alpha (a base root one scale and one add,
// an extension root one product and one add); each row reads its local and
// next cells and writes 16 bytes.  That is bytes for narrow AIRs such as
// FibonacciAir, operations for constraint-heavy ones such as the VM's.
//
// Design:
//  * One launch for every AIR of a prove.  A job table holds, per AIR, its
//    code, pool and source-table offsets, domain, selector tables and output
//    (stark/quotient.py J_*); blocks map to (AIR, row range) by the jobs'
//    first blocks, largest AIR first, and each block finds its job by a scan.
//  * Each thread evaluates one row (a second row a thread halves the
//    decode per row but, with the rows in flight capped by shared memory,
//    halves the warps, and measured slower on the VM's AIRs).  Each mode
//    has its own __global__ around one body, so a profile tells them
//    apart.  The block stages its job's code in shared memory and reads
//    two instructions ahead; after an instruction runs, the one after
//    next, when it is a load, has its cells copied into its slot
//    asynchronously (cp.async), overlapping the next.
//    The opcode is decoded by a balanced tree of uniform compares: a
//    switch's jump table and indirect branch cost this card more cycles.
//  * Value slots live in shared memory, typed: a base slot is one word, an
//    extension slot one uint4.  A block of T threads holds L = T rows; slot
//    s of row l is word s L + l of the base file (or uint4 s L + l of the
//    extension file behind it), so a warp's 32 accesses to one slot fall in
//    32 banks (an extension slot's 16 bytes in four conflict-free phases).
//    The wrapper sizes T from the largest program's words per row and code
//    and the SM's 227 KB (stark/quotient.py block_threads).
//  * Streamed mode, for the programs whose slots and code would shrink the
//    shared launch's blocks (Poseidon2Air, sha256's, keccakf with 56,186
//    instructions, the ECC and Fp2 chips with 1,600-1,700 slot words a row
//    held): the compiler fits each in a budget of slot words a row by
//    loading a cell, constant or selector again rather than holding it
//    (stark/quotient.py _WordFile), its code (up to 899 KB) is staged
//    through a ring of two 64-instruction chunks in shared memory, each
//    chunk read into registers a chunk ahead and published by a barrier,
//    so an instruction is read from shared memory as in shared mode
//    (read from L2 each time it cost about twice the cycles), and its
//    slots stay in shared memory, so no value slot goes to device memory.  Both types share one file there:
//    base slot w of row l is word w L + l, extension slot g words 4g L + l
//    to (4g + 3) L + l, four conflict-free accesses.  A load there issues
//    its cp.async and goes on: the compiler moves each load up to eight
//    instructions ahead of its slot's first read and marks that read
//    WAIT (stark/quotient.py _schedule_loads).  Its sources are
//    column-major copies of the LDEs' quotient rows (transpose_kernel,
//    about 7 ms for keccakf's 11 GB), so a warp's load of one cell of its
//    32 neighbouring rows is one 128-byte access; row-major, it touched 32
//    sectors for 128 useful bytes, and at keccakf's 2,633 columns those
//    rows leave the 50 MB L2 between reloads.  Where even the
//    budget's computed values do not fit, the compiler stores the one read
//    again farthest ahead to a spill file in device memory, slot-major over
//    the launch's rows as a warp's 32 rows make one 128-byte access (SPILL
//    once, FILL before each later read).
//  * is_first_row and is_last_row come from tables of the quotient domain in
//    LDE order (built once per domain by batch inversion); is_transition is
//    x - w_n^-1 from the LDE points; 1/Z_H from its 2^lqd values in the pool.
//  * Threads walk rows in the LDE's bit-reversed order: lane l is LDE row
//    r, so neighbouring threads read neighbouring rows; its natural row
//    j = rev(r) selects the output row and the next row.
//
// Columns mode (ovt_quotient_columns): the same interpreter over the natural
// trace domain for a list of base-valued roots, the counterpart of
// dag.eval(DeviceOps, ...) in logup.stack_interactions (logup.py:155) and
// evaluator.jit_dag_lookup_hist (evaluator.py:283-289), and of the
// constraint checker's natural-domain evaluation (stark/debug.py:60-138).
// Lane l is trace row j, its next row is j + 1 mod N, selectors read as
// zero (or, for a program compiled with them, as the natural domain's 0/1
// is_first_row, is_last_row and is_transition), and STORE_B
// writes root k's value to out[k * N + j] (coalesced across threads).  Its
// bound is bytes: interaction fields are columns and small expressions, so
// each row reads its cells and writes 4 bytes per root.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

// stark/quotient.py's opcodes; MADD_EB, MSUB_EB and MRSUB_EB are an
// extension add or sub fused with the product (extension a, base b) that
// only it uses: d = d + a*b, d - a*b, a*b - d; MULFOLD_BB and SUBFOLD_EE
// fold a root computed only for its fold, alpha^e at pool word d; SPILL
// stores slot a (extension when b) at spill word d of the row, FILL loads
// spill word a back into slot d.
enum Op : int {
  CONST_B, CONST_E, LOAD_B, LOAD_E, SEL, ADD_BB, SUB_BB, MUL_BB, NEG_B,
  ADD_EE, SUB_EE, MUL_EE, NEG_E, ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B,
  FOLD_E, STORE_B, MADD_EB, MSUB_EB, MRSUB_EB, MULFOLD_BB, SUBFOLD_EE, SPILL, FILL, N_OPS
};

// Streamed mode's code ring (stark/quotient.py CODE_RING): two chunks.
constexpr int CHUNK = 64;
constexpr int RING = 2 * CHUNK;

// stark/quotient.py J_* and JOB_WORDS
enum Job : int {
  J_CODE, J_NINSTR, J_POOL, J_SRC, J_NBASE, J_LOGQ, J_LQD, J_SEL, J_OUT,
  J_FIRST, J_LAST, J_ZH, J_BLOCK0, J_GINV, JOB_WORDS = 16
};

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

using ext::to_e;
using ext::to_u4;

// Slot files of one block, a thread's lane its thread index.  Typed files
// (shared mode): base slot s of lane l at bf[s L + l], extension slot s at
// ef[s L + l].  One word file (WORDS, streamed mode): base slot w at
// bf[w L + l], extension slot g in words 4g to 4g + 3.
template <bool WORDS>
struct Slots {
  uint32_t* bf;
  uint4* ef;
  uint32_t L, tid;
  __device__ __forceinline__ uint32_t& b(int s) const { return bf[s * L + tid]; }
  // word w of extension slot s
  __device__ __forceinline__ uint32_t* ew(int s, int w) const {
    if constexpr (WORDS)
      return &bf[(4 * s + w) * L + tid];
    else
      return reinterpret_cast<uint32_t*>(&ef[s * L + tid]) + w;
  }
  __device__ __forceinline__ ext::E e(int s) const {
    if constexpr (WORDS)
      return ext::E{{*ew(s, 0), *ew(s, 1), *ew(s, 2), *ew(s, 3)}};
    else
      return to_e(ef[s * L + tid]);
  }
  __device__ __forceinline__ void set_e(int s, const ext::E& x) const {
    if constexpr (WORDS) {
#pragma unroll
      for (int w = 0; w < 4; ++w) *ew(s, w) = x.c[w];
    } else {
      ef[s * L + tid] = to_u4(x);
    }
  }
};

// One block's state, shared by the opcodes' bodies (all inlined, so the
// lane's values stay in registers).
template <bool WORDS>
struct Ctx {
  // streamed mode: column-major sources (pointer, column stride), loads
  // issued without a wait (WAIT on a later instruction)
  static constexpr bool STREAMED = WORDS;
  Slots<WORDS> S;
  const uint32_t* pool;
  const long long* src;
  const long long* job;
  uint32_t* spill;  // spill word w of the launch's row g at spill[w R + g]
  size_t R, g;
  uint32_t nq;
  uint32_t rows[2], orow, sel[3];
  bool valid;
  ext::E acc;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
               "r"((uint32_t)__cvta_generic_to_shared(smem)), "l"(gmem));
}

// Wait for every copy group but the last N.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A load instruction's cells copied straight into its slot, asynchronously:
// issued while the instruction before it runs, so that its memory latency
// overlaps that one.
// Cell (row, column) of source k: a row-major matrix (pointer, row stride),
// or in streamed mode a column-major copy (pointer, column stride); the
// next three columns are ``step`` words on.
template <class C>
__device__ __forceinline__ const uint32_t* cell(const C& c, int k, uint32_t row, int col,
                                                long long& step) {
  const uint32_t* m = (const uint32_t*)c.src[2 * k];
  const long long stride = c.src[2 * k + 1];
  if constexpr (C::STREAMED) {
    step = stride;
    return m + col * stride + row;
  } else {
    step = 1;
    return m + col + (long long)row * stride;
  }
}

template <class C>
__device__ __forceinline__ void load_async(const C& c, const int4& ins) {
  long long step;
  const uint32_t* p = cell(c, ins.z >> 1, (ins.z & 1) ? c.rows[1] : c.rows[0], ins.w, step);
  if (ins.x == LOAD_B) {
    cp_async4(&c.S.b(ins.y), p);
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) cp_async4(c.S.ew(ins.y, w), p + w * step);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int OP, bool QUOTIENT, class C>
__device__ __forceinline__ void exec(C& c, int d, int a, int b, int issued) {
  const auto& S = c.S;
  if constexpr (OP == CONST_B) {
    S.b(d) = c.pool[a];
  } else if constexpr (OP == CONST_E) {
    S.set_e(d, ext::E{{c.pool[a], c.pool[a + 1], c.pool[a + 2], c.pool[a + 3]}});
  } else if constexpr (OP == LOAD_B || OP == LOAD_E) {
    if constexpr (C::STREAMED) {  // waited for by the WAIT the compiler set
      load_async(c, make_int4(OP, d, a, b));
      return;
    }
    if (issued) {  // load_async put the cells in the slot (2: a later copy is out)
      if (issued == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      return;
    }
    long long step;
    const uint32_t* p = cell(c, a >> 1, (a & 1) ? c.rows[1] : c.rows[0], b, step);
    if constexpr (OP == LOAD_B)
      S.b(d) = __ldg(p);
    else
      S.set_e(d, ext::E{{__ldg(p), __ldg(p + step), __ldg(p + 2 * step), __ldg(p + 3 * step)}});
  } else if constexpr (OP == SEL) {
    S.b(d) = a == 0 ? c.sel[0] : (a == 1 ? c.sel[1] : c.sel[2]);
  } else if constexpr (OP == ADD_BB) {
    S.b(d) = bb::add(S.b(a), S.b(b));
  } else if constexpr (OP == SUB_BB) {
    S.b(d) = bb::sub(S.b(a), S.b(b));
  } else if constexpr (OP == MUL_BB) {
    S.b(d) = bb::mul(S.b(a), S.b(b));
  } else if constexpr (OP == NEG_B) {
    S.b(d) = bb::sub(0u, S.b(a));
  } else if constexpr (OP == ADD_EE) {
    S.set_e(d, ext::add(S.e(a), S.e(b)));
  } else if constexpr (OP == SUB_EE) {
    S.set_e(d, ext::sub(S.e(a), S.e(b)));
  } else if constexpr (OP == MUL_EE) {
    S.set_e(d, ext::mul(S.e(a), S.e(b)));
  } else if constexpr (OP == NEG_E) {
    S.set_e(d, ext::neg(S.e(a)));
  } else if constexpr (OP == ADD_EB) {
    ext::E x = S.e(a);
    x.c[0] = bb::add(x.c[0], S.b(b));
    S.set_e(d, x);
  } else if constexpr (OP == SUB_EB) {
    ext::E x = S.e(a);
    x.c[0] = bb::sub(x.c[0], S.b(b));
    S.set_e(d, x);
  } else if constexpr (OP == SUB_BE) {  // base a minus extension b
    ext::E x = ext::neg(S.e(b));
    x.c[0] = bb::add(x.c[0], S.b(a));
    S.set_e(d, x);
  } else if constexpr (OP == MUL_EB) {
    S.set_e(d, ext::scale(S.e(a), S.b(b)));
  } else if constexpr (OP == MADD_EB) {
    S.set_e(d, ext::add(S.e(d), ext::scale(S.e(a), S.b(b))));
  } else if constexpr (OP == MSUB_EB) {
    S.set_e(d, ext::sub(S.e(d), ext::scale(S.e(a), S.b(b))));
  } else if constexpr (OP == MRSUB_EB) {
    S.set_e(d, ext::sub(ext::scale(S.e(a), S.b(b)), S.e(d)));
  } else if constexpr (OP == MULFOLD_BB) {
    if constexpr (QUOTIENT)
      c.acc = ext::add(c.acc, ext::scale(ext::load(c.pool + d), bb::mul(S.b(a), S.b(b))));
  } else if constexpr (OP == SUBFOLD_EE) {
    if constexpr (QUOTIENT)
      c.acc = ext::add(c.acc, ext::mul(ext::sub(S.e(a), S.e(b)),
                                       ext::load(c.pool + d)));
  } else if constexpr (OP == FOLD_B) {
    if constexpr (QUOTIENT) c.acc = ext::add(c.acc, ext::scale(ext::load(c.pool + b), S.b(a)));
  } else if constexpr (OP == FOLD_E) {
    if constexpr (QUOTIENT)
      c.acc = ext::add(c.acc, ext::mul(S.e(a), ext::load(c.pool + b)));
  } else if constexpr (OP == STORE_B) {
    if constexpr (!QUOTIENT)
      if (c.valid) ((uint32_t*)c.job[J_OUT])[(long long)b * c.nq + c.orow] = S.b(a);
  } else if constexpr (!C::STREAMED) {
    return;  // SPILL and FILL: budgeted programs only
  } else if constexpr (OP == SPILL) {
    uint32_t* p = c.spill + (size_t)d * c.R + c.g;
    if (b) {
      const ext::E x = S.e(a);
#pragma unroll
      for (int w = 0; w < 4; ++w) p[w * c.R] = x.c[w];
    } else {
      *p = S.b(a);
    }
  } else if constexpr (OP == FILL) {
    const uint32_t* p = c.spill + (size_t)a * c.R + c.g;
    if (b)
      S.set_e(d, ext::E{{p[0], p[c.R], p[2 * c.R], p[3 * c.R]}});
    else
      S.b(d) = *p;
  }
}

// The dispatch: a balanced tree of range compares on the opcode, four or
// five uniform branches deep.  A switch compiles to a jump table and an
// indirect branch, which costs this card more than twice as many cycles an
// instruction.
template <int LO, int HI, bool QUOTIENT, class C>
__device__ __forceinline__ void dispatch(int op, C& c, int d, int a, int b, int issued) {
  if constexpr (HI - LO == 1) {
    exec<LO, QUOTIENT>(c, d, a, b, issued);
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (op < MID)
      dispatch<LO, MID, QUOTIENT>(op, c, d, a, b, issued);
    else
      dispatch<MID, HI, QUOTIENT>(op, c, d, a, b, issued);
  }
}

// stark/quotient.py WAIT: the instruction waits for its thread's loads in
// flight first (streamed mode); OPCODE masks it off.
constexpr int WAIT = 256;
constexpr int OPCODE = 255;

// The body of every kernel: block blockIdx.x of its job, one lane (row) a
// thread.  STREAM: the code streamed through a ring, the slots in one word
// file, column-major sources, loads without a wait, SPILL and FILL; else
// the job's code staged whole in shared memory ahead of typed files.
template <bool QUOTIENT, bool STREAM>
__device__ __forceinline__ void interpret(const long long* __restrict__ jobs, int n_jobs,
                                          const int4* __restrict__ code_all,
                                          const uint32_t* __restrict__ pool_all,
                                          const long long* __restrict__ src_all,
                                          const uint32_t* __restrict__ xs, int code_cap,
                                          uint32_t* __restrict__ spill) {
  extern __shared__ uint4 smem[];
  const long long vb = blockIdx.x;
  int jk = 0;
  while (jk + 1 < n_jobs && vb >= jobs[(jk + 1) * JOB_WORDS + J_BLOCK0]) ++jk;
  const long long* job = jobs + jk * JOB_WORDS;
  const int n_instr = (int)job[J_NINSTR];
  const int log_q = (int)job[J_LOGQ];
  const uint32_t qd = 1u << (int)job[J_LQD];
  const int sel_mask = (int)job[J_SEL];

  // Shared mode stages the job's code whole ahead of the slot files.
  // Streamed mode stages it through a ring of two chunks of CHUNK
  // instructions: chunk 0 now, and each next chunk, held in registers since
  // the start of the chunk before it, stored and published by a barrier
  // just before the first read-ahead into it (``stage``).
  const int4* code = code_all + job[J_CODE];
  int4* staged = reinterpret_cast<int4*>(smem);
  int4 held[CHUNK / 32];  // this thread's share of the next chunk (streamed)
  if constexpr (!STREAM) {
    for (int i = threadIdx.x; i < n_instr; i += blockDim.x) staged[i] = code[i];
  } else {
    for (int i = threadIdx.x; i < CHUNK && i < n_instr; i += blockDim.x) staged[i] = code[i];
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      const int i = CHUNK + threadIdx.x + k * (int)blockDim.x;
      if (threadIdx.x + k * blockDim.x < CHUNK && i < n_instr) held[k] = __ldg(code + i);
    }
  }
  Ctx<STREAM> c;
  c.pool = pool_all + job[J_POOL];
  c.src = src_all + 2 * job[J_SRC];
  c.job = job;
  c.nq = 1u << log_q;
  c.S.L = blockDim.x;
  c.S.tid = threadIdx.x;
  c.S.bf = reinterpret_cast<uint32_t*>(smem + code_cap);  // streamed: code_cap = RING
  c.S.ef = reinterpret_cast<uint4*>(c.S.bf + (uint32_t)job[J_NBASE] * c.S.L);
  if constexpr (STREAM) {
    c.spill = spill;
    c.R = (size_t)gridDim.x * blockDim.x;
    c.g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  }

  // The lane's rows (local, next), its output row, whether it lies below
  // the height (a job shorter than a block repeats rows and stores nothing
  // for the repeats), its selectors and its accumulator.
  const uint32_t l = (uint32_t)(vb - job[J_BLOCK0]) * blockDim.x + threadIdx.x;
  c.valid = l < c.nq;
  const uint32_t r = l & (c.nq - 1);
  if (QUOTIENT) {
    const uint32_t j = rev_bits(r, log_q);
    c.rows[0] = r;
    c.rows[1] = rev_bits((j + qd) & (c.nq - 1), log_q);
    c.orow = j;
    const uint32_t* first = (const uint32_t*)job[J_FIRST];
    const uint32_t* last = (const uint32_t*)job[J_LAST];
    c.sel[0] = (sel_mask & 1) ? first[r] : 0u;
    c.sel[1] = (sel_mask & 2) ? last[r] : 0u;
    c.sel[2] = (sel_mask & 4) ? bb::sub(xs[r], (uint32_t)job[J_GINV]) : 0u;
  } else {
    c.rows[0] = r;
    c.rows[1] = (r + 1) & (c.nq - 1);
    c.orow = r;
    // a program compiled with selectors (the constraint checker) reads the
    // natural domain's 0/1 selectors; the others read zero
    const bool last_row = r == c.nq - 1;
    c.sel[0] = (sel_mask & 1) && r == 0 ? bb::ONE : 0u;
    c.sel[1] = (sel_mask & 2) && last_row ? bb::ONE : 0u;
    c.sel[2] = (sel_mask & 4) && !last_row ? bb::ONE : 0u;
  }
  c.acc = ext::zero();
  __syncthreads();

  auto fetch = [&](int pc) -> int4 {
    if constexpr (STREAM)
      return staged[pc & (RING - 1)];
    else
      return staged[pc];
  };
  // Streamed: chunk k = first / CHUNK goes into its ring half, which held
  // chunk k - 2, read by no thread since the barrier before chunk k - 1;
  // the barrier publishes it; then chunk k + 1 is read into registers.
  auto stage = [&](int first) {
    int4* half = staged + (first & (RING - 1));
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      const int i = threadIdx.x + k * (int)blockDim.x;
      if (i < CHUNK && first + i < n_instr) half[i] = held[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < CHUNK / 32; ++k) {
      const int i = first + CHUNK + threadIdx.x + k * (int)blockDim.x;
      if (threadIdx.x + k * blockDim.x < CHUNK && i < n_instr) held[k] = __ldg(code + i);
    }
  };
  // Two instructions are read ahead.  Shared mode: after an instruction
  // runs, the one after next, when it is a load whose slot the next one
  // neither reads nor writes, has its copy issued, so that it overlaps the
  // next one.  Streamed mode: a load issues its copy and goes on; the
  // compiler moved it up to LOAD_AHEAD instructions ahead of its slot's
  // first read, which waits (WAIT) for every copy in flight.
  const int4 none = make_int4(-1, -1, -1, -1);
  int4 nxt = n_instr > 0 ? fetch(0) : none;
  int4 nxt2 = n_instr > 1 ? fetch(1) : none;
  bool out1 = false, out2 = false;  // nxt's and nxt2's copies are issued
  for (int pc = 0; pc < n_instr; ++pc) {
    const int4 ins = nxt;
    const bool out = out1;
    nxt = nxt2;
    out1 = out2;
    if constexpr (STREAM)
      if (((pc + 2) & (CHUNK - 1)) == 0 && pc + 2 < n_instr) stage(pc + 2);
    nxt2 = pc + 2 < n_instr ? fetch(pc + 2) : none;
    out2 = false;
    if constexpr (STREAM) {
      if (ins.x & WAIT) cp_async_wait<0>();
      dispatch<0, N_OPS, QUOTIENT>(ins.x & OPCODE, c, ins.y, ins.z, ins.w, 0);
    } else {
      // a copy issued for ins is waited for, leaving a later one (nxt's)
      // out; no SPILL or FILL here
      dispatch<0, SPILL, QUOTIENT>(ins.x, c, ins.y, ins.z, ins.w, out ? (out1 ? 2 : 1) : 0);
      if ((nxt2.x == LOAD_B || nxt2.x == LOAD_E) && nxt2.y != nxt.y && nxt2.y != nxt.z &&
          nxt2.y != nxt.w) {
        load_async(c, nxt2);
        out2 = true;
      }
    }
  }
  if constexpr (STREAM) cp_async_wait<0>();
  if (QUOTIENT && c.valid)
    ext::store((uint32_t*)job[J_OUT] + 4ull * c.orow,
               ext::scale(c.acc, pool_all[job[J_ZH] + (c.orow & (qd - 1))]));
}

// Each mode has its own __global__, so that a profile tells them apart.
#define OVT_INTERP_ARGS                                                              \
  const long long* __restrict__ jobs, int n_jobs, const int4* __restrict__ code_all, \
      const uint32_t* __restrict__ pool_all, const long long* __restrict__ src_all,  \
      const uint32_t* __restrict__ xs, int code_cap, uint32_t* __restrict__ spill
#define OVT_INTERP_CALL jobs, n_jobs, code_all, pool_all, src_all, xs, code_cap, spill

__global__ void __launch_bounds__(128) quotient_kernel(OVT_INTERP_ARGS) {
  interpret<true, false>(OVT_INTERP_CALL);
}

__global__ void __launch_bounds__(128) columns_kernel(OVT_INTERP_ARGS) {
  interpret<false, false>(OVT_INTERP_CALL);
}

__global__ void __launch_bounds__(128) quotient_stream_kernel(OVT_INTERP_ARGS) {
  interpret<true, true>(OVT_INTERP_CALL);
}

__global__ void __launch_bounds__(128) columns_stream_kernel(OVT_INTERP_ARGS) {
  interpret<false, true>(OVT_INTERP_CALL);
}

// ``blocks`` plan blocks of ``threads`` threads and smem_bytes of dynamic
// shared memory, in the streamed kernel when ``streamed`` (``spill``: its
// spill file, n_spill words for each of its blocks x threads rows).
template <class K>
int launch(K shared_kernel, K stream_kernel, bool (&configured)[2], const void* jobs,
           int n_jobs, const void* code, const void* pool, const void* src, const void* xs,
           int threads, int blocks, int smem_bytes, int code_cap, int streamed, void* spill,
           void* stream) {
  const K kernel = streamed ? stream_kernel : shared_kernel;
  if (!configured[streamed != 0]) {  // shared memory above 48 KB is opt-in
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    configured[streamed != 0] = true;
  }
  if (blocks == 0) return (int)cudaGetLastError();
  kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const long long*)jobs, n_jobs, (const int4*)code, (const uint32_t*)pool,
      (const long long*)src, (const uint32_t*)xs, code_cap, (uint32_t*)spill);
  return (int)cudaGetLastError();
}

// out[c n + r] = in[r stride + c] for r < n, c < w: 32 x 32 tiles through
// shared memory, a warp reading 32 columns of a row and writing 32 rows of
// a column (128 bytes each).
__global__ void __launch_bounds__(256) transpose_kernel(const uint32_t* __restrict__ in,
                                                        long long stride,
                                                        uint32_t* __restrict__ out,
                                                        long long n, int w) {
  __shared__ uint32_t tile[32][33];
  const long long r0 = (long long)blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  for (int k = threadIdx.y; k < 32; k += 8) {
    const long long r = r0 + k;
    const int c = c0 + threadIdx.x;
    if (r < n && c < w) tile[k][threadIdx.x] = in[r * stride + c];
  }
  __syncthreads();
  for (int k = threadIdx.y; k < 32; k += 8) {
    const int c = c0 + k;
    const long long r = r0 + threadIdx.x;
    if (r < n && c < w) out[(long long)c * n + r] = tile[threadIdx.x][k];
  }
}

}  // namespace

extern "C" int ovt_transpose(const void* in, long long stride, void* out, long long n, int w,
                             void* stream) {
  if (n == 0 || w == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + 31) / 32), (unsigned)((w + 31) / 32));
  transpose_kernel<<<grid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, stride, (uint32_t*)out, n, w);
  return (int)cudaGetLastError();
}

extern "C" int ovt_quotient(const void* jobs, int n_jobs, const void* code,
                            const void* pool, const void* src, const void* xs,
                            int threads, int blocks, int smem_bytes, int code_cap,
                            int streamed, void* spill, void* stream) {
  static bool configured[2] = {false, false};
  return launch(quotient_kernel, quotient_stream_kernel, configured, jobs, n_jobs, code,
                pool, src, xs, threads, blocks, smem_bytes, code_cap, streamed, spill, stream);
}

extern "C" int ovt_quotient_columns(const void* jobs, int n_jobs, const void* code,
                                    const void* pool, const void* src, const void* xs,
                                    int threads, int blocks, int smem_bytes, int code_cap,
                                    int streamed, void* spill, void* stream) {
  static bool configured[2] = {false, false};
  return launch(columns_kernel, columns_stream_kernel, configured, jobs, n_jobs, code,
                pool, src, xs, threads, blocks, smem_bytes, code_cap, streamed, spill, stream);
}
