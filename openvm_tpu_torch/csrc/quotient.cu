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
// Bound: the function needs each node's products and adds per row, a batch
// inverse (3 products) per selector it reads, and the fold with precomputed
// powers of alpha; each row reads its local and next cells and writes 16
// bytes.  That is bytes for narrow AIRs such as FibonacciAir, operations for
// constraint-heavy ones.  This first version spends a Fermat inverse (61
// products) per row on each of the first/last-row selectors it reads and
// folds by Horner, so even a narrow AIR costs it operations.
// Design, first version: one thread per quotient-domain row in a
// grid-stride loop; all threads run the same instruction at the same time,
// so the dispatch never diverges and the instruction word is one broadcast
// load.  Slots live in local memory (MAX_SLOTS x 4 words).  Threads walk
// the rows in the LDE's bit-reversed order: thread r's local cells are LDE
// row r, so neighbouring threads read neighbouring rows; its natural row
// j = rev(r) selects the output row and the next row.
//
// Columns mode (ovt_quotient_columns): the same interpreter over the natural
// trace domain for a list of base-valued roots, the counterpart of
// dag.eval(DeviceOps, ...) in logup.stack_interactions (logup.py:155) and
// evaluator.jit_dag_lookup_hist (evaluator.py:283-289).  Thread j is trace
// row j, its next row is j + 1 mod N, selectors read as zero, and STORE_B
// writes root k's value to out[k * N + j] (coalesced across threads).  Its
// bound is bytes: interaction fields are columns and small expressions, so
// each row reads its cells and writes 4 bytes per root.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int MAX_SLOTS = 96;  // stark/quotient.py MAX_SLOTS

enum Op : int {
  CONST_B, CONST_E, LOAD_B, LOAD_E, SEL, ADD_BB, SUB_BB, MUL_BB, NEG_B,
  ADD_EE, SUB_EE, MUL_EE, NEG_E, ADD_EB, SUB_EB, SUB_BE, MUL_EB, FOLD_B,
  FOLD_E, STORE_B
};

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// One row's program.  QUOTIENT: rows are LDE rows, FOLD_* fold into acc by
// alpha; otherwise STORE_B writes slot a to out[b * n + j].
template <bool QUOTIENT>
__device__ __forceinline__ ext::E run_program(
    const int4* __restrict__ code, int n_instr, const uint32_t* __restrict__ pool,
    const long long* __restrict__ src_ptr, const long long* __restrict__ src_stride,
    const uint32_t rows[2], const uint32_t sels[3], const ext::E& alpha,
    uint32_t (*slot)[4], uint32_t j, uint32_t n, uint32_t* __restrict__ out) {
  ext::E acc = ext::zero();
  for (int pc = 0; pc < n_instr; ++pc) {
    const int4 ins = code[pc];
    const int d = ins.y, a = ins.z, b = ins.w;
    switch (ins.x) {
      case CONST_B: slot[d][0] = pool[a]; break;
      case CONST_E:
        for (int c = 0; c < 4; ++c) slot[d][c] = pool[a + c];
        break;
      case LOAD_B: {
        const uint32_t* m = (const uint32_t*)src_ptr[a >> 1];
        slot[d][0] = m[(long long)rows[a & 1] * src_stride[a >> 1] + b];
        break;
      }
      case LOAD_E: {
        const uint32_t* m = (const uint32_t*)src_ptr[a >> 1] +
                            (long long)rows[a & 1] * src_stride[a >> 1] + b;
        for (int c = 0; c < 4; ++c) slot[d][c] = m[c];
        break;
      }
      case SEL: slot[d][0] = sels[a]; break;
      case ADD_BB: slot[d][0] = bb::add(slot[a][0], slot[b][0]); break;
      case SUB_BB: slot[d][0] = bb::sub(slot[a][0], slot[b][0]); break;
      case MUL_BB: slot[d][0] = bb::mul(slot[a][0], slot[b][0]); break;
      case NEG_B: slot[d][0] = bb::sub(0u, slot[a][0]); break;
      case ADD_EE: ext::store(slot[d], ext::add(ext::load(slot[a]), ext::load(slot[b]))); break;
      case SUB_EE: ext::store(slot[d], ext::sub(ext::load(slot[a]), ext::load(slot[b]))); break;
      case MUL_EE: ext::store(slot[d], ext::mul(ext::load(slot[a]), ext::load(slot[b]))); break;
      case NEG_E: ext::store(slot[d], ext::neg(ext::load(slot[a]))); break;
      case ADD_EB: {
        ext::E e = ext::load(slot[a]);
        e.c[0] = bb::add(e.c[0], slot[b][0]);
        ext::store(slot[d], e);
        break;
      }
      case SUB_EB: {
        ext::E e = ext::load(slot[a]);
        e.c[0] = bb::sub(e.c[0], slot[b][0]);
        ext::store(slot[d], e);
        break;
      }
      case SUB_BE: {
        ext::E e = ext::neg(ext::load(slot[b]));
        e.c[0] = bb::add(e.c[0], slot[a][0]);
        ext::store(slot[d], e);
        break;
      }
      case MUL_EB: ext::store(slot[d], ext::scale(ext::load(slot[a]), slot[b][0])); break;
      case FOLD_B:
        if (QUOTIENT) {
          acc = ext::mul(acc, alpha);
          acc.c[0] = bb::add(acc.c[0], slot[a][0]);
        }
        break;
      case FOLD_E:
        if (QUOTIENT) acc = ext::add(ext::mul(acc, alpha), ext::load(slot[a]));
        break;
      case STORE_B:
        if (!QUOTIENT) out[(long long)b * n + j] = slot[a][0];
        break;
      default: break;
    }
  }
  return acc;
}

__global__ void quotient_kernel(const int4* __restrict__ code, int n_instr,
                                const uint32_t* __restrict__ pool,
                                const long long* __restrict__ src_ptr,
                                const long long* __restrict__ src_stride,
                                const uint32_t* __restrict__ xs,
                                const uint32_t* __restrict__ zh_tab,
                                uint32_t g_inv, const uint32_t* __restrict__ alpha_p,
                                int log_q, int lqd, int sel_mask,
                                uint32_t* __restrict__ out) {
  const uint32_t nq = 1u << log_q;
  const uint32_t qd = 1u << lqd;
  const ext::E alpha = ext::load(alpha_p);
  uint32_t slot[MAX_SLOTS][4];
  for (uint32_t r = blockIdx.x * blockDim.x + threadIdx.x; r < nq;
       r += gridDim.x * blockDim.x) {
    const uint32_t j = rev_bits(r, log_q);
    const uint32_t rows[2] = {r, rev_bits((j + qd) & (nq - 1), log_q)};
    const uint32_t zh = zh_tab[j & (qd - 1)];
    const uint32_t inv_zh = zh_tab[qd + (j & (qd - 1))];
    uint32_t sels[3] = {0u, 0u, 0u};
    if (sel_mask) {
      const uint32_t x = xs[r];
      const uint32_t x_mg = bb::sub(x, g_inv);
      if (sel_mask & 1) sels[0] = bb::mul(zh, ext::bb_inv(bb::sub(x, bb::ONE)));
      if (sel_mask & 2) sels[1] = bb::mul(zh, ext::bb_inv(x_mg));
      sels[2] = x_mg;
    }
    const ext::E acc = run_program<true>(code, n_instr, pool, src_ptr, src_stride,
                                         rows, sels, alpha, slot, j, nq, nullptr);
    ext::store(out + 4ull * j, ext::scale(acc, inv_zh));
  }
}

__global__ void columns_kernel(const int4* __restrict__ code, int n_instr,
                               const uint32_t* __restrict__ pool,
                               const long long* __restrict__ src_ptr,
                               const long long* __restrict__ src_stride,
                               int log_n, uint32_t* __restrict__ out) {
  const uint32_t n = 1u << log_n;
  const uint32_t sels[3] = {0u, 0u, 0u};
  uint32_t slot[MAX_SLOTS][4];
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    const uint32_t rows[2] = {j, (j + 1) & (n - 1)};
    run_program<false>(code, n_instr, pool, src_ptr, src_stride, rows, sels,
                       ext::zero(), slot, j, n, out);
  }
}

int grid_for(long long rows, int threads) {
  const long long want = (rows + threads - 1) / threads;
  return (int)(want < 132 * 16 ? want : 132 * 16);
}

}  // namespace

extern "C" int ovt_quotient(const void* code, int n_instr, const void* pool,
                            const void* src_ptr, const void* src_stride,
                            const void* xs, const void* zh_tab, unsigned g_inv,
                            const void* alpha, int log_q, int lqd, int sel_mask,
                            void* out, void* stream) {
  const int threads = 128;
  quotient_kernel<<<grid_for(1ll << log_q, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int4*)code, n_instr, (const uint32_t*)pool,
      (const long long*)src_ptr, (const long long*)src_stride,
      (const uint32_t*)xs, (const uint32_t*)zh_tab, g_inv,
      (const uint32_t*)alpha, log_q, lqd, sel_mask, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int ovt_quotient_columns(const void* code, int n_instr, const void* pool,
                                    const void* src_ptr, const void* src_stride,
                                    int log_n, void* out, void* stream) {
  const int threads = 128;
  columns_kernel<<<grid_for(1ll << log_n, threads), threads, 0, (cudaStream_t)stream>>>(
      (const int4*)code, n_instr, (const uint32_t*)pool,
      (const long long*)src_ptr, (const long long*)src_stride, log_n,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
