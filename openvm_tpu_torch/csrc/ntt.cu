// K3: radix-2 NTT and coset LDE down the rows of an (N, W) row-major matrix.
//
// Replaces openvm_tpu/ntt.py: _dif_stages (:60), ntt (:80), intt (:92),
// coset_lde (:117) and bitrev_rows (:55).
// Bound on this card: bytes, then integer issue.  A pass over the matrix
// moves each word twice, so the first thing that counts is how often the
// matrix crosses device memory; a butterfly is one Montgomery product and
// two modular additions per pair of words, about a dozen integer
// instructions, and a pass of 10-11 stages spends as long issuing them as
// it does moving its words (PERF.md).
// Design: one launch runs a *pass* of k consecutive decimation-in-frequency
// stages s0 .. s0+k-1 (k <= 11) on tiles held in shared memory, so a
// transform of 2^21 rows takes two passes instead of 21 (the host's plan is
// ntt.py _pass_plan).  The stages of a pass pair rows that share their bits
// above log_n - s0 and below L = log_n - s0 - k, so a tile is the 2^k rows
// hi | t << L | lo (t < 2^k) of C = 8 adjacent columns: 2^k * 32 bytes,
// 64 KB at k = 11.  Tiles are numbered column tile first, so the blocks
// that share a row's 32-byte sectors run together and meet in L2; the
// ragged column edge is masked.  Inside the tile a thread keeps 2^g rows of
// 4 columns (two 16-byte words of shared memory each) in registers and runs
// g <= 3 stages there before the rows go back to shared memory, so a pass
// of 11 stages makes 4 round trips through shared memory, not 11; the
// 16-byte slots are XOR-swizzled to keep those round trips free of bank
// conflicts in most stages.  Loads go straight to shared memory (cp.async,
// no registers held, all in flight at once); two blocks of 512 threads fit
// an SM, so one block's stages run while the other's words move.
// The row work of the LDE rides in the passes: a load may stop at row n_in
// (the zero-padded half of the LDE is never read) and multiply each row by
// a factor (the coset-shift powers); a store may send row r to bitrev(r)
// (the natural-order output of ntt/intt, the coefficients of the inverse)
// and multiply by a factor of the destination row (1/N, the shift powers).
// A pass works in place unless it stores bit-reversed.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int C = 8;         // columns per tile
constexpr int K_MAX = 11;    // stages per pass
constexpr int THREADS = 512;
constexpr int G_MAX = 3;       // stages in registers a round trip (ntt.py _pass_model)
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM must fit

// The 16-byte slot of tile row t, column half h: 2t + h with bits 1-2
// XORed with bits 3-4 of t, so the 2^g rows an item holds spread over the
// banks.  Rows t and t + 32m lie 64m slots apart.
__device__ __forceinline__ uint32_t slot(uint32_t t, uint32_t h) {
  return ((t << 1) | h) ^ ((t >> 2) & 6u);
}

// (a, b) -> (a + b, (a - b) w).  a - b + p < 2p is not reduced: the
// Montgomery product takes it, as (2p) p < p 2^32.
__device__ __forceinline__ uint32_t mul_diff(uint32_t a, uint32_t b, uint32_t w) {
  return bb::monty_reduce((uint64_t)(a + bb::P - b) * w);
}

__device__ __forceinline__ void butterfly(uint4& a, uint4& b, uint32_t w) {
  const uint4 x = a, y = b;
  a = make_uint4(bb::add(x.x, y.x), bb::add(x.y, y.y), bb::add(x.z, y.z),
                 bb::add(x.w, y.w));
  b = make_uint4(mul_diff(x.x, y.x, w), mul_diff(x.y, y.y, w),
                 mul_diff(x.z, y.z, w), mul_diff(x.w, y.w, w));
}

// A 4-byte copy from device to shared memory that does not hold a register
// or wait: src_bytes 0 writes a zero instead.
__device__ __forceinline__ void copy_async(uint32_t* dst, const uint32_t* src,
                                           uint32_t src_bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}

// Stages s .. s+G-1 of the pass, the pass's stages i .. i+G-1, on the tile.
// They pair tile rows that differ in bits b .. b+G-1 (b = k - i - G); an
// item is one setting u of the other k - G bits and one column half h, and
// owns the 2^G rows base | v << b.  The twiddle of the pair (ta, ta + 2^(b+
// bv)) in stage s + qs is tw[j << (s + qs)] with j the global row's bits
// below the butterfly span: ((ta mod 2^(b+bv)) << L) | lo.
template <int G>
__device__ __forceinline__ void group_stages(uint4* sm, const uint32_t* __restrict__ tw,
                                             int k, int i, int s, int L, uint32_t lo) {
  const int b = k - i - G;
  const uint32_t items = 2u << (k - G);
  for (uint32_t item = threadIdx.x; item < items; item += blockDim.x) {
    const uint32_t h = item & 1u, u = item >> 1;
    const uint32_t base = ((u >> b) << (b + G)) | (u & ((1u << b) - 1u));
    uint4 v[1 << G];
#pragma unroll
    for (int q = 0; q < (1 << G); ++q) v[q] = sm[slot(base | ((uint32_t)q << b), h)];
#pragma unroll
    for (int qs = 0; qs < G; ++qs) {
      const int bv = G - 1 - qs;
#pragma unroll
      for (int a = 0; a < (1 << G); ++a) {
        if (a & (1 << bv)) continue;
        const uint32_t ta = base | ((uint32_t)a << b);
        const uint32_t j = ((ta & ((1u << (b + bv)) - 1u)) << L) | lo;
        butterfly(v[a], v[a | (1 << bv)], tw[j << (s + qs)]);
      }
    }
#pragma unroll
    for (int q = 0; q < (1 << G); ++q) sm[slot(base | ((uint32_t)q << b), h)] = v[q];
  }
}

// The tile's rows t = t0, t0 + step, ... of column c (thread (t0, c)): row
// r = row0 | t << L at word slot(t, c / 4) * 4 + c % 4 of the tile.  With
// LINEAR (step a multiple of 32) the slot advances by 2 step a row.
template <bool LINEAR>
__device__ __forceinline__ void load_tile(uint32_t* smw, const uint32_t* in,
                                          uint32_t row0, int L, uint32_t w,
                                          uint32_t c0, uint32_t rows, uint32_t n_in) {
  const uint32_t c = threadIdx.x & 7u, step = blockDim.x >> 3;
  const uint32_t col_bytes = c0 + c < w ? 4u : 0u;
  const uint32_t* col = in + (col_bytes ? c0 + c : 0u);
  uint32_t t = threadIdx.x >> 3;
  uint32_t* dst = smw + slot(t, c >> 2) * 4 + (c & 3u);
  for (uint32_t r = row0 | (t << L); t < rows; t += step, r += step << L) {
    if (!LINEAR) dst = smw + slot(t, c >> 2) * 4 + (c & 3u);
    const bool live = r < n_in && col_bytes;
    copy_async(dst, live ? col + (uint64_t)r * w : in, live ? 4u : 0u);
    if (LINEAR) dst += 8 * step;
  }
}

template <bool LINEAR>
__device__ __forceinline__ void store_tile(const uint32_t* smw, uint32_t* out,
                                           const uint32_t* __restrict__ out_fac,
                                           uint32_t row0, int L, int log_n, uint32_t w,
                                           uint32_t c0, uint32_t rows, int bitrev_out) {
  const uint32_t c = threadIdx.x & 7u, step = blockDim.x >> 3;
  if (c0 + c >= w) return;
  uint32_t* col = out + c0 + c;
  uint32_t t = threadIdx.x >> 3;
  const uint32_t* src = smw + slot(t, c >> 2) * 4 + (c & 3u);
  for (uint32_t r = row0 | (t << L); t < rows; t += step, r += step << L) {
    if (!LINEAR) src = smw + slot(t, c >> 2) * 4 + (c & 3u);
    const uint32_t dst = bitrev_out && log_n > 0 ? __brev(r) >> (32 - log_n) : r;
    uint32_t x = *src;
    if (out_fac != nullptr) x = bb::mul(x, out_fac[dst]);
    col[(uint64_t)dst * w] = x;
    if (LINEAR) src += 8 * step;
  }
}

// The rows of tile `tile` of a pass: column tile ct, rows hi << (log_n -
// s0) | t << L | lo.  Tiles count lo first; a pass that stores bit-reversed
// counts them by the bits of its destination rows instead (hi and lo
// bit-reversed), so that blocks that run together write neighbouring rows.
struct Tile {
  uint32_t row0, lo, c0;
};

__device__ __forceinline__ Tile tile_at(uint32_t tile, uint32_t n_ct, int s0, int L,
                                        int log_n, int bitrev_out) {
  const uint32_t ct = tile % n_ct;
  tile /= n_ct;
  uint32_t hi, lo;
  if (bitrev_out) {
    const uint32_t q_hi = tile & ((1u << s0) - 1u), q_lo = tile >> s0;
    hi = s0 > 0 ? __brev(q_hi) >> (32 - s0) : 0u;
    lo = L > 0 ? __brev(q_lo) >> (32 - L) : 0u;
  } else {
    lo = tile & ((1u << L) - 1u);
    hi = tile >> L;
  }
  return {(hi << (log_n - s0)) | lo, lo, ct * C};
}

// One pass: stages s0 .. s0+k-1 of the 2^log_n-point DIF with twiddles tw,
// one tile a block.  Loads in[r] * in_fac[r] for r < n_in and 0 above;
// stores to row bitrev(r) when bitrev_out, else r, times out_fac[that row].
// `in` may equal `out` unless bitrev_out.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ntt_pass_kernel(const uint32_t* in, uint32_t* out, const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ in_fac, const uint32_t* __restrict__ out_fac,
                int log_n, uint32_t w, int s0, int k, uint32_t n_in, int bitrev_out) {
  extern __shared__ uint4 sm[];
  uint32_t* smw = reinterpret_cast<uint32_t*>(sm);
  const int L = log_n - s0 - k;
  const uint32_t rows = 1u << k;
  const uint32_t c = threadIdx.x & 7u;
  const Tile tl = tile_at(blockIdx.x, (w + C - 1) / C, s0, L, log_n, bitrev_out);
  const bool linear = (blockDim.x & 255u) == 0;
  // Every load in flight at once (cp.async); rows from n_in on and columns
  // from w on read as zeros.
  if (linear) load_tile<true>(smw, in, tl.row0, L, w, tl.c0, rows, n_in);
  else load_tile<false>(smw, in, tl.row0, L, w, tl.c0, rows, n_in);
  asm volatile("cp.async.wait_all;\n" ::);
  if (in_fac != nullptr) {  // each thread scales the words it loaded
    for (uint32_t t = threadIdx.x >> 3; t < rows && tl.c0 + c < w; t += blockDim.x >> 3) {
      const uint32_t r = tl.row0 | (t << L);
      uint32_t* x = smw + slot(t, c >> 2) * 4 + (c & 3u);
      if (r < n_in) *x = bb::mul(*x, in_fac[r]);
    }
  }
  __syncthreads();
  const int n_groups = (k + G_MAX - 1) / G_MAX;
  int i = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    const int g = k / n_groups + (gi < k % n_groups ? 1 : 0);
    if (g == 3) group_stages<3>(sm, tw, k, i, s0 + i, L, tl.lo);
    else if (g == 2) group_stages<2>(sm, tw, k, i, s0 + i, L, tl.lo);
    else group_stages<1>(sm, tw, k, i, s0 + i, L, tl.lo);
    i += g;
    __syncthreads();
  }
  if (linear) store_tile<true>(smw, out, out_fac, tl.row0, L, log_n, w, tl.c0, rows, bitrev_out);
  else store_tile<false>(smw, out, out_fac, tl.row0, L, log_n, w, tl.c0, rows, bitrev_out);
}

}  // namespace

extern "C" int ovt_ntt_pass(const void* in, void* out, const void* tw,
                            const void* in_fac, const void* out_fac, int log_n,
                            unsigned w, int s0, int k, unsigned n_in,
                            int bitrev_out, void* stream) {
  if (k < 0 || k > K_MAX || s0 < 0 || s0 + k > log_n || log_n > 31)
    return (int)cudaErrorInvalidValue;
  static uint64_t smem_set = 0;  // devices whose limit is raised, by bit
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev >= 64) e = cudaErrorInvalidDevice;
  if (e == cudaSuccess && !(smem_set >> dev & 1u)) {
    e = cudaFuncSetAttribute(ntt_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (C * 4) << K_MAX);
    if (e == cudaSuccess) smem_set |= uint64_t(1) << dev;
  }
  if (e != cudaSuccess) return (int)e;
  const uint64_t blocks = (uint64_t)((w + C - 1) / C) << (log_n - k);
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks >= (uint64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  int threads = (1 << k) >> G_MAX << 1;  // the items of a G_MAX-stage group
  threads = threads < 32 ? 32 : (threads > THREADS ? THREADS : threads);
  ntt_pass_kernel<<<(unsigned)blocks, threads, (size_t)(C * 4) << k,
                    (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw,
      (const uint32_t*)in_fac, (const uint32_t*)out_fac, log_n, w, s0, k, n_in,
      bitrev_out);
  return (int)cudaGetLastError();
}
