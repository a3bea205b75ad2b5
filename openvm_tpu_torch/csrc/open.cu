// K12: out-of-domain openings from the INTT coefficients, for every matrix
// of a prove's openings stage in one launch (and one launch more to sum):
//   out[job][p, t] = sum_i c[i, t] * zpows[i] * mult_p^i
// for each job's matrix c (N, W) and its one or two base multipliers
// (1 and g_n for a trace matrix's zeta and zeta * g_n, in_shift^-1 for a
// quotient chunk's zeta / in_shift).
//
// Replaces openvm_tpu/stark/prover.py _open_dot_jit (:232) with the
// geometric series it is given (_geo_series, :260-269); the zeta power series
// it reads (_ext_pows_jit, :220) is K2's.  The JAX package pads the rows and
// the width to powers of two for XLA (prover.py:747-749); zero padding adds
// zero, so here there is none.
// Bound: bytes (every coefficient matrix once, zpows once, the partials);
// per element one extension-by-base scale a point, per row and point one
// row weight (a scale of zpows and a product for the next power).  The
// scales' products are summed as 64-bit integers over UNREDUCED rows
// before one reduction, a multiply-add each instead of a Montgomery
// product.
// Design:
//  * A job table (stark/prover.py O_*): pointer, row stride, W, N, points,
//    multipliers, output and partial offsets, first block and blocks, rows
//    a block.  Blocks map to jobs by the table's first blocks, largest job
//    first (as quotient.block_plan), each a range of whole tiles of TILE rows.
//  * Row weights once: per tile, thread r computes u_p[r] = zpows[i] *
//    mult_p^i for row i = tile + r into shared memory; mult_p^i comes from
//    the block's first row by exponentiation, then one product by
//    mult_p^TILE a tile.  No host-built geometric table.
//  * Coalesced reads whatever W: the block's threads cover cw = min(W, T)
//    columns and T / cw rows at once, so consecutive threads read
//    consecutive words of a row (and of the next rows when W is small);
//    wider matrices take column groups of T in turn.  Each thread keeps its
//    column's sums in registers, then a tree over the threads of a column in
//    shared memory writes (block, point, column) partials.
//  * The second launch sums each output word over its job's blocks, a warp
//    a word.  Modular sums are exact, so the order does not matter, and no
//    word is ever added atomically.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int THREADS = 256, TILE = THREADS, MAX_PTS = 2, UNREDUCED = 4;

// stark/prover.py O_* and OPEN_JOB_WORDS
enum Job : int {
  O_PTR, O_STRIDE, O_W, O_N, O_NPTS, O_MULT0, O_MULT1, O_OUT, O_PART, O_BLOCK0, O_NBLK,
  O_RPB, JOB_WORDS = 12
};

// A loop over the job's points with a constant trip count, so that the
// per-point arrays stay in registers.
#define PER_POINT(p) _Pragma("unroll") for (int p = 0; p < MAX_PTS; ++p) if (p < npts)

__device__ __forceinline__ ext::E to_e(const uint4& v) { return ext::E{{v.x, v.y, v.z, v.w}}; }
__device__ __forceinline__ uint4 to_u4(const ext::E& e) {
  return make_uint4(e.c[0], e.c[1], e.c[2], e.c[3]);
}

__global__ void __launch_bounds__(THREADS)
open_partial_kernel(const long long* __restrict__ jobs, int n_jobs,
                    const uint32_t* __restrict__ zpows, uint32_t* __restrict__ partial) {
  __shared__ uint4 u_s[MAX_PTS][TILE];
  __shared__ uint4 red_s[MAX_PTS][THREADS];
  int jk = 0;
  while (jk + 1 < n_jobs && (long long)blockIdx.x >= jobs[(jk + 1) * JOB_WORDS + O_BLOCK0]) ++jk;
  const long long* job = jobs + jk * JOB_WORDS;
  const uint32_t* c = (const uint32_t*)job[O_PTR];
  const long long stride = job[O_STRIDE], n = job[O_N];
  const int w = (int)job[O_W], npts = (int)job[O_NPTS];
  const uint32_t mult[MAX_PTS] = {(uint32_t)job[O_MULT0], (uint32_t)job[O_MULT1]};
  const long long b = blockIdx.x - job[O_BLOCK0];
  const long long r_begin = b * job[O_RPB];
  const long long r_end = min(n, r_begin + job[O_RPB]);
  const int cw = min(w, THREADS), rstep = THREADS / cw;
  const int col_in = threadIdx.x % cw, row_in = threadIdx.x / cw;
  const bool active = row_in < rstep;

  // mult_p^(r_begin + threadIdx.x), this thread's first weight row, and
  // mult_p^TILE, the step from one tile to the next
  uint32_t first[MAX_PTS] = {bb::ONE, bb::ONE}, step[MAX_PTS] = {bb::ONE, bb::ONE};
  PER_POINT(p) {
    first[p] = ext::bb_pow(mult[p], (uint32_t)(r_begin + threadIdx.x));
    step[p] = ext::bb_pow(mult[p], TILE);
  }
  for (int g0 = 0; g0 < w; g0 += cw) {
    const int col = g0 + col_in;
    ext::E acc[MAX_PTS] = {ext::zero(), ext::zero()};
    uint32_t pw[MAX_PTS] = {first[0], first[1]};
    for (long long t0 = r_begin; t0 < r_end; t0 += TILE) {
      const long long wr = t0 + threadIdx.x;
      if (wr < r_end) {
        const ext::E z = ext::load(zpows + 4 * wr);
        PER_POINT(p) u_s[p][threadIdx.x] = to_u4(ext::scale(z, pw[p]));
      }
      PER_POINT(p) pw[p] = bb::mul(pw[p], step[p]);
      __syncthreads();
      if (active && col < w) {
        const int rows = (int)min((long long)TILE, r_end - t0);
        // UNREDUCED rows at a time summed as 64-bit products (each below
        // p^2, so four stay below 2^64), then one reduction a component
        for (int r = row_in; r < rows; r += UNREDUCED * rstep) {
          uint64_t wide[MAX_PTS][4] = {};
#pragma unroll
          for (int q = 0; q < UNREDUCED; ++q) {
            const int rq = r + q * rstep;
            if (rq < rows) {
              const uint32_t v = __ldg(c + (t0 + rq) * stride + col);
              PER_POINT(p) {
                const uint4 u = u_s[p][rq];
                wide[p][0] += (uint64_t)u.x * v;
                wide[p][1] += (uint64_t)u.y * v;
                wide[p][2] += (uint64_t)u.z * v;
                wide[p][3] += (uint64_t)u.w * v;
              }
            }
          }
          PER_POINT(p)
            for (int k = 0; k < 4; ++k) acc[p].c[k] = bb::add(acc[p].c[k], bb::reduce_wide(wide[p][k]));
        }
      }
      __syncthreads();  // the tile's weights are consumed
    }
    // the sums of a column's rstep threads, by a tree in shared memory
    PER_POINT(p) red_s[p][threadIdx.x] = to_u4(acc[p]);
    __syncthreads();
    for (int cnt = rstep; cnt > 1;) {
      const int h = (cnt + 1) / 2;
      if (active && row_in < cnt - h)
        PER_POINT(p)
          red_s[p][threadIdx.x] = to_u4(ext::add(to_e(red_s[p][threadIdx.x]),
                                                 to_e(red_s[p][threadIdx.x + h * cw])));
      cnt = h;
      __syncthreads();
    }
    if (row_in == 0 && col < w)
      PER_POINT(p)
        ext::store(partial + job[O_PART] + ((b * npts + p) * w + col) * 4,
                   to_e(red_s[p][col_in]));
    __syncthreads();
  }
}

// out[k] = sum over the job's blocks b of partial[job part + b * words + i]
// for output word k = job out + i, a warp a word.
__global__ void open_reduce_kernel(const long long* __restrict__ jobs, int n_jobs,
                                   const uint32_t* __restrict__ partial, long long total,
                                   uint32_t* __restrict__ out) {
  const long long k = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= total) return;
  int lo = 0, hi = n_jobs - 1;  // the last job whose output starts at or before k
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (jobs[mid * JOB_WORDS + O_OUT] <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  const long long* job = jobs + lo * JOB_WORDS;
  const long long words = job[O_NPTS] * job[O_W] * 4, i = k - job[O_OUT];
  const uint32_t* src = partial + job[O_PART] + i;
  uint32_t s = 0;
  for (long long blk = lane; blk < job[O_NBLK]; blk += 32) s = bb::add(s, src[blk * words]);
  for (int off = 16; off > 0; off >>= 1) s = bb::add(s, __shfl_xor_sync(0xffffffffu, s, off));
  if (lane == 0) out[k] = s;
}

}  // namespace

extern "C" int ovt_open_partial(const void* jobs, int n_jobs, int blocks, const void* zpows,
                                void* partial, void* stream) {
  if (blocks == 0) return (int)cudaGetLastError();
  open_partial_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)jobs, n_jobs, (const uint32_t*)zpows, (uint32_t*)partial);
  return (int)cudaGetLastError();
}

extern "C" int ovt_open_reduce(const void* jobs, int n_jobs, const void* partial,
                               long long total, void* out, void* stream) {
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (total * 32 + threads - 1) / threads;
  open_reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)jobs, n_jobs, (const uint32_t*)partial, total, (uint32_t*)out);
  return (int)cudaGetLastError();
}
