// K12: out-of-domain openings from the INTT coefficients,
//   out[p, t] = sum_i c[i, t] * zpows[i] * geos[p, i],
// for one matrix c (N, W) and its one or two points (zeta * g_n for the
// next row, zeta / in_shift for a quotient chunk factor as zeta^i * geos).
//
// Replaces openvm_tpu/stark/prover.py _open_dot_jit (:232); the zeta power
// series it reads (_ext_pows_jit, :220) is K2's.  The JAX package pads the
// rows and the width to powers of two for XLA (prover.py:747-749); zero
// padding adds zero, so here there is none.
// Bound: bytes for wide matrices (N W words of c, plus zpows and geos once
// per column tile), operations for narrow ones (per element and point one
// extension scale of zpows by geos and one scale by c: 8 Montgomery
// products).  Design: pass 1, blocks of 32 columns x 8 row lanes over a
// range of rows each, partial sums per block reduced in shared memory and
// written to a (blocks, P, W, 4) scratch; pass 2 sums the partials.
// Modular sums are exact, so the order does not matter, and no word is
// ever added atomically.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int COLS = 32, LANES = 8, MAX_PTS = 2;

__global__ void open_partial_kernel(const uint32_t* __restrict__ c,
                                    long long row_stride, int w, long long n,
                                    const uint32_t* __restrict__ zpows,
                                    const uint32_t* __restrict__ geos, int npts,
                                    uint32_t* __restrict__ partial) {
  __shared__ uint32_t red[LANES][MAX_PTS][COLS][4];
  const int t = blockIdx.y * COLS + threadIdx.x;
  ext::E acc[MAX_PTS] = {ext::zero(), ext::zero()};
  if (t < w) {
    for (long long i = (long long)blockIdx.x * LANES + threadIdx.y; i < n;
         i += (long long)gridDim.x * LANES) {
      const uint32_t ci = c[i * row_stride + t];
      const ext::E z = ext::load(zpows + 4 * i);
      for (int p = 0; p < npts; ++p)
        acc[p] = ext::add(acc[p], ext::scale(ext::scale(z, geos[p * n + i]), ci));
    }
  }
  for (int p = 0; p < MAX_PTS; ++p) ext::store(red[threadIdx.y][p][threadIdx.x], acc[p]);
  __syncthreads();
  if (threadIdx.y == 0 && t < w) {
    for (int p = 0; p < npts; ++p) {
      ext::E s = ext::load(red[0][p][threadIdx.x]);
      for (int l = 1; l < LANES; ++l) s = ext::add(s, ext::load(red[l][p][threadIdx.x]));
      ext::store(partial + (((long long)blockIdx.x * npts + p) * w + t) * 4, s);
    }
  }
}

// out[k] = sum_b partial[b, k] for k < m = P * W * 4.
__global__ void open_reduce_kernel(const uint32_t* __restrict__ partial,
                                   int blocks, int m, uint32_t* __restrict__ out) {
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < m;
       k += gridDim.x * blockDim.x) {
    uint32_t s = 0;
    for (int b = 0; b < blocks; ++b) s = bb::add(s, partial[(long long)b * m + k]);
    out[k] = s;
  }
}

}  // namespace

extern "C" int ovt_open_partial(const void* coeffs, long long row_stride, int w,
                                long long n, const void* zpows, const void* geos,
                                int npts, int blocks, void* partial, void* stream) {
  if (npts < 1 || npts > MAX_PTS) return (int)cudaErrorInvalidValue;
  dim3 grid(blocks, (w + COLS - 1) / COLS), block(COLS, LANES);
  open_partial_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)coeffs, row_stride, w, n, (const uint32_t*)zpows,
      (const uint32_t*)geos, npts, (uint32_t*)partial);
  return (int)cudaGetLastError();
}

extern "C" int ovt_open_reduce(const void* partial, int blocks, int m, void* out,
                               void* stream) {
  const int threads = 256;
  open_reduce_kernel<<<(m + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>((const uint32_t*)partial, blocks,
                                               m, (uint32_t*)out);
  return (int)cudaGetLastError();
}
