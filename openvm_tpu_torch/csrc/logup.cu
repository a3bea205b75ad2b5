// K9 and K10: the LogUp permutation trace.
//
// K9 (ovt_perm_cols) replaces openvm_tpu/stark/logup.py batched_denoms
// (:231) and _perm_block (:247), over the interaction fields and counts
// that the quotient interpreter's columns mode evaluated (stack_interactions,
// :155), one output row a distinct DAG node.  For each row and interaction i, d = alpha + bus_i +
// sum_j beta^(j+1) * f_ij, and the interaction adds sign_i * count_i / d to
// its chunk's column; the inverse of 0 is 0 (babybear.py:234), as in the
// JAX package.  Output: the first 4m columns of the (N, 4m + 4) permutation
// trace, whose last 4 columns K10 fills with phi.
// Bound: operations, priced at the delayed-reduction arithmetic below (a
// 32x32-bit product added into 64 bits 2, a reduction 6, a modular add 3).
// Per interaction: 4 multiply-adds a field and, every 4 fields, 4
// reductions and an extension add; a batch inverse at 3 extension products
// an element (19 multiply-adds and 7 reductions each; the inverse itself
// not counted); the count's scale and the add into its chunk.  Bytes: each
// row reads its distinct field and count words and writes 16m bytes.
// Design: one launch for every AIR of a prove, over a job table (stark/
// logup.py P_*): per AIR its columns, height, first interaction in the
// interaction table, interactions, chunks and output.  The job table, the
// interaction table with the bus words, alpha and beta's powers go up in
// one copy a prove.  Blocks map to (AIR, rows), largest AIR first
// (quotient.block_plan), a thread a row.
//  * Montgomery's trick over batches of PERM_BATCH = 4 interactions of a
//    row (the batch's denominators, counts and running products stay in
//    registers), one extension inverse a batch (through the
//    quadratic subfield, its norm's Fermat inverse by a 39-product
//    addition chain), then a backward pass of two products an element.
//    A zero denominator enters the product as 1 and contributes 0; the
//    other interactions of its row are unchanged.  A batch's loads are
//    issued before its products: the count and the first four fields of
//    each interaction (rows past its fields read its count's row, weighted
//    0), so a warp has dozens of loads in flight instead of one
//    interaction's; each load asks L2 for 256 bytes, as the neighbouring
//    warp reads the next 128.
//  * Delayed reduction: an extension product sums each coefficient's
//    32x32-bit products in 64 bits (at most 4 terms, each below p^2 <
//    2^62) and reduces once (bb::reduce_wide); c4..c6 are reduced before
//    their W fold.  The field sum of a denominator reduces every 4 fields.
//  * Coalesced stores: a thread adds its contributions into its row of
//    chunk sums in shared memory (signed per interaction: a receive
//    subtracts); the block then writes its rows' 4m words in flat order,
//    16 bytes a thread, into the (N, 4m + 4) buffer, phi's columns skipped.
//    Alpha and beta's powers are staged in shared memory too.
// Keeping the batch in shared memory instead (32 bytes an interaction a
// row) allowed 8 warps an SM at rv32_base_alu's 21 interactions, and each
// interaction's loads waited on the one before: slower than the
// one-inverse-an-interaction kernel this replaces.
//
// K10 (ovt_perm_scan) replaces _perm_tail_jit (:328): the row sum over the
// m chunks, the inclusive prefix sum of the row sums down the rows (phi)
// written into the last 4 columns of K9's (N, 4m + 4) buffer, and phi's
// last row, the cumulative sum.  Bound: bytes (each row reads its 16m
// bytes and writes 16).
// Design: one launch, a single-pass scan with decoupled look-back.  A block
// takes the next tile of SCAN_TILE rows from a counter (so every tile before
// it has started), stages the tile's chunk columns in shared memory with
// coalesced 16-byte loads (consecutive threads on consecutive words of the
// tile, phi's words skipped), and each thread sums one row.  The block
// scans its row sums (warp shuffles, then the warp totals), publishes its
// aggregate, and its first warp looks back over 32 predecessors at a time:
// aggregates are added until a published inclusive prefix is found.  The
// block publishes its own inclusive prefix and writes phi.  Modular
// addition is exact and associative, so this order gives the same words as
// any other.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int SCAN_TILE = 256;   // rows a block of the scan, one a thread
constexpr int SCAN_CHUNKS = 11;  // chunk columns staged at once; odd, so a
                                 // thread's row of uint4s hits distinct banks
constexpr int STATUS_WORDS = 16;  // a tile's flag, aggregate and prefix

using ext::inv_d;
using ext::is_zero;
using ext::mul_d;
using ext::to_e;
using ext::to_u4;

// stark/logup.py P_* and PERM_JOB_WORDS
enum PermJob : int { P_COLS, P_N, P_ITS, P_NITS, P_M, P_OUT, P_BLOCK0, PERM_JOB_WORDS = 8 };
constexpr int PERM_THREADS = 128;  // the most threads of a perm_cols block
constexpr int PERM_BATCH = 4;      // interactions an inverse, in registers

// A column word, read through the non-coherent path with a 256-byte L2
// prefetch (neighbouring warps read the next 128 bytes of the same row).
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L2::256B.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// sum_{f0 <= f < f0 + 4, f < nf} beta^(f+1) * field_f, reduced: four
// loads issued together (a row past the fields reads the count's row,
// weighted 0), products summed in 64 bits.
__device__ __forceinline__ ext::E field_sum(const uint32_t* __restrict__ cols,
                                            unsigned long long n, unsigned long long j,
                                            const int* __restrict__ rows, int first, int nf,
                                            int f0, const uint4* ab_s) {
  uint32_t v[4];
#pragma unroll
  for (int f = 0; f < 4; ++f)
    v[f] = load_word(cols + (unsigned long long)rows[first + min(f0 + f, nf)] * n + j);
  uint64_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const uint64_t x = f0 + f < nf ? v[f] : 0u;
    const uint4 bp = ab_s[1 + f0 + f];
    w[0] += bp.x * x;
    w[1] += bp.y * x;
    w[2] += bp.z * x;
    w[3] += bp.w * x;
  }
  return ext::E{{bb::reduce_wide(w[0]), bb::reduce_wide(w[1]), bb::reduce_wide(w[2]),
                 bb::reduce_wide(w[3])}};
}

// jobs: n_jobs rows of PERM_JOB_WORDS int64, largest first; its: (I, 4)
// int32 [first entry in rows, fields, chunk, is_send] and bus: (I,)
// Montgomery words, both over every AIR; rows: each interaction's fields'
// then its count's row of its AIR's columns output (an AIR's interactions
// share rows: the columns program evaluates each DAG node once); ab:
// alpha then beta^1.. (n_ab uint4s, the powers padded with zeros to a
// multiple of 4).  Dynamic shared memory: ab, then stage_w uint4s a row
// of chunk sums.
__global__ void __launch_bounds__(PERM_THREADS)
perm_cols_kernel(const long long* __restrict__ jobs, int n_jobs,
                 const int4* __restrict__ its, const uint32_t* __restrict__ bus,
                 const int* __restrict__ rows, const uint4* __restrict__ ab, int n_ab,
                 int stage_w) {
  extern __shared__ uint4 sm[];
  const int T = blockDim.x, tid = threadIdx.x;
  uint4* ab_s = sm;
  uint4* stage = sm + n_ab;
  for (int k = tid; k < n_ab; k += T) ab_s[k] = ab[k];
  int jk = 0;
  while (jk + 1 < n_jobs && (long long)blockIdx.x >= jobs[(jk + 1) * PERM_JOB_WORDS + P_BLOCK0])
    ++jk;
  const long long* job = jobs + jk * PERM_JOB_WORDS;
  const uint32_t* cols = (const uint32_t*)job[P_COLS];
  const unsigned long long n = (unsigned long long)job[P_N];
  const int n_its = (int)job[P_NITS], m = (int)job[P_M];
  its += job[P_ITS];
  bus += job[P_ITS];
  const unsigned long long row0 = (unsigned long long)(blockIdx.x - job[P_BLOCK0]) * T;
  const int n_rows = (int)min((unsigned long long)T, n - row0);
  const unsigned long long j = row0 + tid;
  uint4* row_s = stage + tid * stage_w;
  for (int c = 0; c < m; ++c) row_s[c] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (tid < n_rows) {
    const ext::E alpha = to_e(ab_s[0]);
    const ext::E one = ext::from_base(bb::ONE);
    for (int g0 = 0; g0 < n_its; g0 += PERM_BATCH) {
      ext::E den[PERM_BATCH], pre[PERM_BATCH];
      uint32_t cnt[PERM_BATCH];
      ext::E acc = one;
      // the batch's denominators and counts; a slot past the AIR's
      // interactions reads the last one and is made a zero denominator
#pragma unroll
      for (int k = 0; k < PERM_BATCH; ++k) {
        const int i = min(g0 + k, n_its - 1);
        const int4 t = its[i];  // first field row, fields, chunk, is_send
        cnt[k] = load_word(cols + (unsigned long long)rows[t.x + t.y] * n + j);
        ext::E d = ext::add(alpha, field_sum(cols, n, j, rows, t.x, t.y, 0, ab_s));
        d.c[0] = bb::add(d.c[0], bus[i]);
        for (int f0 = 4; f0 < t.y; f0 += 4)
          d = ext::add(d, field_sum(cols, n, j, rows, t.x, t.y, f0, ab_s));
        den[k] = g0 + k < n_its ? d : ext::zero();
        if (!is_zero(den[k])) acc = mul_d(acc, den[k]);
        pre[k] = acc;
      }
      ext::E inv = inv_d(acc);
#pragma unroll
      for (int k = PERM_BATCH - 1; k >= 0; --k) {
        if (is_zero(den[k])) continue;
        const ext::E inv_k = k > 0 ? mul_d(inv, pre[k - 1]) : inv;
        inv = mul_d(inv, den[k]);
        const int4 t = its[g0 + k];
        const ext::E v = ext::scale(inv_k, cnt[k]);
        const ext::E s = to_e(row_s[t.z]);
        row_s[t.z] = to_u4(t.w ? ext::add(s, v) : ext::sub(s, v));
      }
    }
  }
  __syncthreads();
  uint4* out = reinterpret_cast<uint4*>((uint32_t*)job[P_OUT]) + row0 * (m + 1);
  for (int q = tid; q < n_rows * m; q += T) {
    const int r = q / m, c = q - r * m;
    out[(unsigned long long)r * (m + 1) + c] = stage[r * stage_w + c];
  }
}

__device__ __forceinline__ ext::E shfl_up(const ext::E& v, int offset) {
  ext::E o;
  for (int c = 0; c < 4; ++c) o.c[c] = __shfl_up_sync(0xffffffffu, v.c[c], offset);
  return o;
}

// The sum over the warp's 32 lanes, in every lane.
__device__ __forceinline__ ext::E warp_sum(ext::E v) {
  for (int off = 16; off > 0; off >>= 1) {
    ext::E o;
    for (int c = 0; c < 4; ++c) o.c[c] = __shfl_xor_sync(0xffffffffu, v.c[c], off);
    v = ext::add(v, o);
  }
  return v;
}

// A tile's status: word 0 its flag (0 nothing yet, 1 aggregate, 2 inclusive
// prefix), words 4-7 its aggregate, 8-11 its inclusive prefix; each value
// is written once, before the release store of its flag.
__device__ __forceinline__ uint32_t flag_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void flag_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// A published value, read past the L1 (a volatile load is relaxed at
// system scope), after the acquire of its flag.
__device__ __forceinline__ ext::E value_relaxed(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return to_e(v);
}

__device__ __forceinline__ void publish(uint32_t* status, uint32_t flag, const ext::E& v) {
  *reinterpret_cast<uint4*>(status + 4 * flag) = to_u4(v);
  flag_release(status, flag);
}

// status: word 0 the tile counter, then STATUS_WORDS a tile, zeroed.
__global__ void __launch_bounds__(SCAN_TILE)
perm_scan_kernel(uint32_t* __restrict__ buf, long long n, int m,
                 uint32_t* __restrict__ status, uint32_t* __restrict__ cumsum) {
  __shared__ uint4 tile_s[SCAN_TILE * SCAN_CHUNKS];
  __shared__ uint32_t warp_sums[SCAN_TILE / 32][4];
  __shared__ uint4 carry_s;
  __shared__ unsigned tile_id;
  if (threadIdx.x == 0) tile_id = atomicAdd(status, 1u);
  __syncthreads();
  const long long t = tile_id;
  const long long row0 = t * SCAN_TILE;
  const int rows = (int)min((long long)SCAN_TILE, n - row0);
  const int wq = m + 1;  // uint4s a row of buf: m chunks, then phi
  const uint4* src = reinterpret_cast<const uint4*>(buf) + row0 * wq;

  // This thread's row sum, the chunk columns staged SCAN_CHUNKS at a time.
  ext::E v = ext::zero();
  for (int c0 = 0; c0 < m; c0 += SCAN_CHUNKS) {
    const int cw = min(SCAN_CHUNKS, m - c0);
    for (int k = threadIdx.x; k < rows * cw; k += SCAN_TILE) {
      const int r = k / cw, c = k - r * cw;
      tile_s[r * SCAN_CHUNKS + c] = src[(long long)r * wq + c0 + c];
    }
    __syncthreads();
    if ((int)threadIdx.x < rows)
      for (int c = 0; c < cw; ++c)
        v = ext::add(v, to_e(tile_s[threadIdx.x * SCAN_CHUNKS + c]));
    __syncthreads();
  }

  // Inclusive scan of the tile's row sums.
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const ext::E o = shfl_up(v, off);
    if (lane >= off) v = ext::add(v, o);
  }
  if (lane == 31) ext::store(warp_sums[warp], v);
  __syncthreads();
  if (warp == 0) {
    ext::E w = lane < SCAN_TILE / 32 ? ext::load(warp_sums[lane]) : ext::zero();
    for (int off = 1; off < SCAN_TILE / 32; off <<= 1) {
      const ext::E o = shfl_up(w, off);
      if (lane >= off) w = ext::add(w, o);
    }
    if (lane < SCAN_TILE / 32) ext::store(warp_sums[lane], w);
  }
  __syncthreads();
  if (warp > 0) v = ext::add(v, ext::load(warp_sums[warp - 1]));
  const ext::E total = ext::load(warp_sums[SCAN_TILE / 32 - 1]);

  // The carry: the sum of every earlier tile, by decoupled look-back.
  uint32_t* mine = status + STATUS_WORDS * (1 + t);
  if (warp == 0) {
    ext::E carry = ext::zero();
    if (t == 0) {
      if (lane == 0) publish(mine, 2, total);
    } else {
      if (lane == 0) publish(mine, 1, total);
      for (long long base = t - 1;; base -= 32) {
        const long long p = base - lane;  // lane 0 the nearest predecessor
        const uint32_t* st = status + STATUS_WORDS * (1 + p);
        uint32_t f;
        do {
          f = p >= 0 ? flag_acquire(st) : 2u;
        } while (__any_sync(0xffffffffu, f == 0));
        const unsigned pre = __ballot_sync(0xffffffffu, f == 2);
        const int stop = pre ? __ffs(pre) - 1 : 31;  // the nearest prefix
        const ext::E x = p >= 0 && lane <= stop ? value_relaxed(st + 4 * f) : ext::zero();
        carry = ext::add(carry, warp_sum(x));
        if (pre) break;
      }
      if (lane == 0) publish(mine, 2, ext::add(carry, total));
    }
    if (lane == 0) carry_s = to_u4(carry);
  }
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    const ext::E phi = ext::add(to_e(carry_s), v);
    const long long j = row0 + threadIdx.x;
    reinterpret_cast<uint4*>(buf)[j * wq + m] = to_u4(phi);
    if (j == n - 1) ext::store(cumsum, phi);
  }
}

}  // namespace

// jobs: device job table (n_jobs x PERM_JOB_WORDS int64), blocks its
// plan's total; threads <= PERM_THREADS; stage_w >= the most chunks of a
// job, as stark/logup.py perm_shape chooses them.
extern "C" int ovt_perm_cols(const void* jobs, int n_jobs, int blocks, const void* its,
                             const void* bus, const void* rows, const void* ab, int n_ab,
                             int threads, int stage_w, void* stream) {
  if (n_jobs <= 0 || blocks <= 0 || threads <= 0 || threads > PERM_THREADS || n_ab <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(n_ab + threads * stage_w) * sizeof(uint4);
  const cudaError_t rc = cudaFuncSetAttribute(
      perm_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  perm_cols_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const long long*)jobs, n_jobs, (const int4*)its, (const uint32_t*)bus,
      (const int*)rows, (const uint4*)ab, n_ab, stage_w);
  return (int)cudaGetLastError();
}

// buf: (n, 4m + 4) words, 16-byte aligned; status: 1 + STATUS_WORDS a tile
// words, zeroed.
extern "C" int ovt_perm_scan(void* buf, long long n, int m, void* status, void* cumsum,
                             void* stream) {
  if (n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  perm_scan_kernel<<<(unsigned)tiles, SCAN_TILE, 0, (cudaStream_t)stream>>>(
      (uint32_t*)buf, n, m, (uint32_t*)status, (uint32_t*)cumsum);
  return (int)cudaGetLastError();
}
