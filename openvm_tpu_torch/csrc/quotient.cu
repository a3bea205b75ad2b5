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
//  * Global-memory mode, for programs whose code and slots do not fit one
//    SM's shared memory beside each other (keccakf's 56,186 instructions
//    are 899 KB of code; the ECC and Fp2 chips need 1,600-1,700 slot words
//    a row): the same body instantiated with the code read from global
//    memory through the read-only path (it stays in the 50 MB L2) and the
//    slots in a global scratch laid out slot-major over the R = blocks x T
//    rows in flight (slot s of row r at word s R + r), so a warp's access
//    to one slot is one coalesced transaction; every job of the launch
//    puts its extension file after the launch's largest base file (J_NBASE),
//    as rows of different jobs are in flight together.  The wrapper caps R
//    (stark/quotient.py global_rows); a block walks the plan's blocks with
//    a grid stride.  No cp.async here: its target must be shared memory.
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
// fold a root computed only for its fold, alpha^e at pool word d.
enum Op : int {
  CONST_B, CONST_E, LOAD_B, LOAD_E, SEL, ADD_BB, SUB_BB, MUL_BB, NEG_B,
  ADD_EE, SUB_EE, MUL_EE, NEG_E, ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B,
  FOLD_E, STORE_B, MADD_EB, MSUB_EB, MRSUB_EB, MULFOLD_BB, SUBFOLD_EE, N_OPS
};

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

// Slot files of one block: base slot s of lane l at bf[s L + l], extension
// slot s at ef[s L + l]; a thread's lane is its thread index.
struct Slots {
  uint32_t* bf;
  uint4* ef;
  uint32_t L, tid;
  __device__ __forceinline__ uint32_t& b(int s) const { return bf[s * L + tid]; }
  __device__ __forceinline__ uint4& e(int s) const { return ef[s * L + tid]; }
};

// One block's state, shared by the opcodes' bodies (all inlined, so the
// lane's values stay in registers).
struct Ctx {
  Slots S;
  const uint32_t* pool;
  const long long* src;
  const long long* job;
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
__device__ __forceinline__ void load_async(const Ctx& c, const int4& ins) {
  const uint32_t* m = (const uint32_t*)c.src[2 * (ins.z >> 1)] + ins.w;
  const long long stride = c.src[2 * (ins.z >> 1) + 1];
  const uint32_t* p = m + (long long)((ins.z & 1) ? c.rows[1] : c.rows[0]) * stride;
  if (ins.x == LOAD_B) {
    cp_async4(&c.S.b(ins.y), p);
  } else {
    uint32_t* e = reinterpret_cast<uint32_t*>(&c.S.e(ins.y));
#pragma unroll
    for (int w = 0; w < 4; ++w) cp_async4(e + w, p + w);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int OP, bool QUOTIENT>
__device__ __forceinline__ void exec(Ctx& c, int d, int a, int b, int issued) {
  const Slots& S = c.S;
  if constexpr (OP == CONST_B) {
    S.b(d) = c.pool[a];
  } else if constexpr (OP == CONST_E) {
    S.e(d) = make_uint4(c.pool[a], c.pool[a + 1], c.pool[a + 2], c.pool[a + 3]);
  } else if constexpr (OP == LOAD_B || OP == LOAD_E) {
    if (issued) {  // load_async put the cells in the slot (2: a later copy is out)
      if (issued == 2)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      return;
    }
    const uint32_t* m = (const uint32_t*)c.src[2 * (a >> 1)] + b;
    const uint32_t* p = m + (long long)((a & 1) ? c.rows[1] : c.rows[0]) * c.src[2 * (a >> 1) + 1];
    if constexpr (OP == LOAD_B)
      S.b(d) = __ldg(p);
    else
      S.e(d) = make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
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
    S.e(d) = to_u4(ext::add(to_e(S.e(a)), to_e(S.e(b))));
  } else if constexpr (OP == SUB_EE) {
    S.e(d) = to_u4(ext::sub(to_e(S.e(a)), to_e(S.e(b))));
  } else if constexpr (OP == MUL_EE) {
    S.e(d) = to_u4(ext::mul(to_e(S.e(a)), to_e(S.e(b))));
  } else if constexpr (OP == NEG_E) {
    S.e(d) = to_u4(ext::neg(to_e(S.e(a))));
  } else if constexpr (OP == ADD_EB) {
    ext::E x = to_e(S.e(a));
    x.c[0] = bb::add(x.c[0], S.b(b));
    S.e(d) = to_u4(x);
  } else if constexpr (OP == SUB_EB) {
    ext::E x = to_e(S.e(a));
    x.c[0] = bb::sub(x.c[0], S.b(b));
    S.e(d) = to_u4(x);
  } else if constexpr (OP == SUB_BE) {  // base a minus extension b
    ext::E x = ext::neg(to_e(S.e(b)));
    x.c[0] = bb::add(x.c[0], S.b(a));
    S.e(d) = to_u4(x);
  } else if constexpr (OP == MUL_EB) {
    S.e(d) = to_u4(ext::scale(to_e(S.e(a)), S.b(b)));
  } else if constexpr (OP == MADD_EB) {
    S.e(d) = to_u4(ext::add(to_e(S.e(d)), ext::scale(to_e(S.e(a)), S.b(b))));
  } else if constexpr (OP == MSUB_EB) {
    S.e(d) = to_u4(ext::sub(to_e(S.e(d)), ext::scale(to_e(S.e(a)), S.b(b))));
  } else if constexpr (OP == MRSUB_EB) {
    S.e(d) = to_u4(ext::sub(ext::scale(to_e(S.e(a)), S.b(b)), to_e(S.e(d))));
  } else if constexpr (OP == MULFOLD_BB) {
    if constexpr (QUOTIENT)
      c.acc = ext::add(c.acc, ext::scale(ext::load(c.pool + d), bb::mul(S.b(a), S.b(b))));
  } else if constexpr (OP == SUBFOLD_EE) {
    if constexpr (QUOTIENT)
      c.acc = ext::add(c.acc, ext::mul(ext::sub(to_e(S.e(a)), to_e(S.e(b))),
                                       ext::load(c.pool + d)));
  } else if constexpr (OP == FOLD_B) {
    if constexpr (QUOTIENT) c.acc = ext::add(c.acc, ext::scale(ext::load(c.pool + b), S.b(a)));
  } else if constexpr (OP == FOLD_E) {
    if constexpr (QUOTIENT)
      c.acc = ext::add(c.acc, ext::mul(to_e(S.e(a)), ext::load(c.pool + b)));
  } else if constexpr (OP == STORE_B) {
    if constexpr (!QUOTIENT)
      if (c.valid) ((uint32_t*)c.job[J_OUT])[(long long)b * c.nq + c.orow] = S.b(a);
  }
}

// The dispatch: a balanced tree of range compares on the opcode, four or
// five uniform branches deep.  A switch compiles to a jump table and an
// indirect branch, which costs this card more than twice as many cycles an
// instruction.
template <int LO, int HI, bool QUOTIENT>
__device__ __forceinline__ void dispatch(int op, Ctx& c, int d, int a, int b, int issued) {
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

// The body of every kernel: plan block vb of its job, one lane (row) a
// thread.  GLOBAL: code in global memory, slots in the scratch (slot s of
// the thread's lane at s * gridDim.x * blockDim.x + its global index).
template <bool QUOTIENT, bool GLOBAL>
__device__ __forceinline__ void interpret(const long long* __restrict__ jobs, int n_jobs,
                                          const int4* __restrict__ code_all,
                                          const uint32_t* __restrict__ pool_all,
                                          const long long* __restrict__ src_all,
                                          const uint32_t* __restrict__ xs, int code_cap,
                                          uint32_t* __restrict__ scratch, long long vb) {
  extern __shared__ uint4 smem[];
  int jk = 0;
  while (jk + 1 < n_jobs && vb >= jobs[(jk + 1) * JOB_WORDS + J_BLOCK0]) ++jk;
  const long long* job = jobs + jk * JOB_WORDS;
  const int n_instr = (int)job[J_NINSTR];
  const int log_q = (int)job[J_LOGQ];
  const uint32_t qd = 1u << (int)job[J_LQD];
  const int sel_mask = (int)job[J_SEL];

  // Shared mode stages the job's code in shared memory ahead of the slot
  // files; global mode reads it where it is.
  const int4* code = code_all + job[J_CODE];
  if constexpr (!GLOBAL) {
    int4* staged = reinterpret_cast<int4*>(smem);
    for (int i = threadIdx.x; i < n_instr; i += blockDim.x) staged[i] = code[i];
    code = staged;
  }
  Ctx c;
  c.pool = pool_all + job[J_POOL];
  c.src = src_all + 2 * job[J_SRC];
  c.job = job;
  c.nq = 1u << log_q;
  if constexpr (GLOBAL) {
    c.S.L = gridDim.x * blockDim.x;
    c.S.tid = blockIdx.x * blockDim.x + threadIdx.x;
    c.S.bf = scratch;
  } else {
    c.S.L = blockDim.x;
    c.S.tid = threadIdx.x;
    c.S.bf = reinterpret_cast<uint32_t*>(smem + code_cap);
  }
  c.S.ef = reinterpret_cast<uint4*>(c.S.bf + (uint32_t)job[J_NBASE] * c.S.L);

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
  if constexpr (!GLOBAL) __syncthreads();

  auto fetch = [&](int pc) -> int4 {
    if constexpr (GLOBAL)
      return __ldg(code + pc);
    else
      return code[pc];
  };
  // Two instructions are read ahead.  In shared mode, after an instruction
  // runs, the one after next, when it is a load whose slot the next one
  // neither reads nor writes, has its copy issued, so that it overlaps the
  // next one.
  const int4 none = make_int4(-1, -1, -1, -1);
  int4 nxt = n_instr > 0 ? fetch(0) : none;
  int4 nxt2 = n_instr > 1 ? fetch(1) : none;
  bool out1 = false, out2 = false;  // nxt's and nxt2's copies are issued
  for (int pc = 0; pc < n_instr; ++pc) {
    const int4 ins = nxt;
    const bool out = out1;
    nxt = nxt2;
    out1 = out2;
    nxt2 = pc + 2 < n_instr ? fetch(pc + 2) : none;
    out2 = false;
    // a copy issued for ins is waited for, leaving a later one (nxt's) out
    dispatch<0, N_OPS, QUOTIENT>(ins.x, c, ins.y, ins.z, ins.w, out ? (out1 ? 2 : 1) : 0);
    if constexpr (!GLOBAL) {
      if ((nxt2.x == LOAD_B || nxt2.x == LOAD_E) && nxt2.y != nxt.y &&
          nxt2.y != nxt.z && nxt2.y != nxt.w) {
        load_async(c, nxt2);
        out2 = true;
      }
    }
  }
  if (QUOTIENT && c.valid)
    ext::store((uint32_t*)job[J_OUT] + 4ull * c.orow,
               ext::scale(c.acc, pool_all[job[J_ZH] + (c.orow & (qd - 1))]));
}

// Each mode has its own __global__, so that a profile tells them apart.
#define OVT_INTERP_ARGS                                                              \
  const long long* __restrict__ jobs, int n_jobs, const int4* __restrict__ code_all, \
      const uint32_t* __restrict__ pool_all, const long long* __restrict__ src_all,  \
      const uint32_t* __restrict__ xs, int code_cap
#define OVT_GLOBAL_ARGS OVT_INTERP_ARGS, uint32_t* __restrict__ scratch, long long vblocks

__global__ void __launch_bounds__(128) quotient_kernel(OVT_INTERP_ARGS) {
  interpret<true, false>(jobs, n_jobs, code_all, pool_all, src_all, xs, code_cap, nullptr,
                         blockIdx.x);
}

__global__ void __launch_bounds__(128) columns_kernel(OVT_INTERP_ARGS) {
  interpret<false, false>(jobs, n_jobs, code_all, pool_all, src_all, xs, code_cap, nullptr,
                          blockIdx.x);
}

__global__ void __launch_bounds__(128) quotient_global_kernel(OVT_GLOBAL_ARGS) {
  for (long long vb = blockIdx.x; vb < vblocks; vb += gridDim.x)
    interpret<true, true>(jobs, n_jobs, code_all, pool_all, src_all, xs, code_cap, scratch,
                          vb);
}

__global__ void __launch_bounds__(128) columns_global_kernel(OVT_GLOBAL_ARGS) {
  for (long long vb = blockIdx.x; vb < vblocks; vb += gridDim.x)
    interpret<false, true>(jobs, n_jobs, code_all, pool_all, src_all, xs, code_cap, scratch,
                           vb);
}

// Shared mode when scratch is null: ``blocks`` plan blocks, smem_bytes of
// dynamic shared memory.  Global mode otherwise: ``blocks`` blocks walk the
// plan's ``vblocks`` blocks, the slots in scratch.
template <class K, class G>
int launch(K shared_kernel, G global_kernel, bool& configured, const void* jobs, int n_jobs,
           const void* code, const void* pool, const void* src, const void* xs, int threads,
           int blocks, int smem_bytes, int code_cap, void* scratch, long long vblocks,
           void* stream) {
  if (!configured) {  // shared memory above 48 KB is opt-in
    const cudaError_t e = cudaFuncSetAttribute(
        shared_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  if (blocks == 0) return (int)cudaGetLastError();
  if (scratch)
    global_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const long long*)jobs, n_jobs, (const int4*)code, (const uint32_t*)pool,
        (const long long*)src, (const uint32_t*)xs, code_cap, (uint32_t*)scratch, vblocks);
  else
    shared_kernel<<<blocks, threads, smem_bytes, (cudaStream_t)stream>>>(
        (const long long*)jobs, n_jobs, (const int4*)code, (const uint32_t*)pool,
        (const long long*)src, (const uint32_t*)xs, code_cap);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ovt_quotient(const void* jobs, int n_jobs, const void* code,
                            const void* pool, const void* src, const void* xs,
                            int threads, int blocks, int smem_bytes, int code_cap,
                            void* scratch, long long vblocks, void* stream) {
  static bool configured = false;
  return launch(quotient_kernel, quotient_global_kernel, configured, jobs, n_jobs, code,
                pool, src, xs, threads, blocks, smem_bytes, code_cap, scratch, vblocks,
                stream);
}

extern "C" int ovt_quotient_columns(const void* jobs, int n_jobs, const void* code,
                                    const void* pool, const void* src, const void* xs,
                                    int threads, int blocks, int smem_bytes, int code_cap,
                                    void* scratch, long long vblocks, void* stream) {
  static bool configured = false;
  return launch(columns_kernel, columns_global_kernel, configured, jobs, n_jobs, code,
                pool, src, xs, threads, blocks, smem_bytes, code_cap, scratch, vblocks,
                stream);
}
