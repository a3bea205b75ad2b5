// K13 and K14: the reduced openings and the FRI fold.
//
// K13 replaces openvm_tpu/stark/prover.py _col_comb (:194) and the
// reduced-opening loop (:773-792): for one committed matrix M of LDE height
// H, in one pass over its rows r,
//   comb  = sum_t alpha^t M[r, t]
//   ro[r] += alpha_pow_p * (p_p(z) comb - comb) / (z_p - x_r)
// for each of the matrix's opening points p (two for a trace matrix, one
// for a quotient chunk), x_r = g w_H^rev(r) from a shared table.  The host
// advances alpha_pow by alpha^w per (matrix, point) in the order of the
// JAX loop, which is the transcript's.  Bound: operations (W scale-adds
// per row, then per point a batch inverse, 3 extension products, and two
// more products); the matrix is read once, ro read and written once.
// Design, first version: one thread per row, the accumulation in place, and
// a full extension inverse (about 120 Montgomery products) per row and
// point instead of a batch inverse.
//
// K14 replaces openvm_tpu/fri.py fold_evals (:78) inside commit_phase
// (:104-133): v'[j] = v0 + (beta - y_j)(v1 - v0)/(-2 y_j), v0 = v[2j],
// v1 = v[2j+1], plus beta^2 ro[j] where a reduced opening of the new height
// exists, fused into the same pass.  1/(-2 y_j) comes from a base-field
// table (powers of w^-1 in bit-reversed order), so no element needs an
// inverse.  Bound: bytes (32 bytes read, 16 or 32 more with ro, 16
// written per output).  Design: one thread per output element.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

__global__ void fri_fold_kernel(const uint32_t* __restrict__ evals,
                                const uint32_t* __restrict__ beta_p,
                                const uint32_t* __restrict__ y,
                                const uint32_t* __restrict__ inv_neg2y,
                                const uint32_t* __restrict__ ro, long long half,
                                uint32_t* __restrict__ out) {
  const ext::E beta = ext::load(beta_p);
  const ext::E beta_sq = ext::mul(beta, beta);
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < half;
       j += (long long)gridDim.x * blockDim.x) {
    const ext::E v0 = ext::load(evals + 8 * j);
    const ext::E v1 = ext::load(evals + 8 * j + 4);
    const ext::E slope = ext::scale(ext::sub(v1, v0), inv_neg2y[j]);
    ext::E bmy = beta;
    bmy.c[0] = bb::sub(bmy.c[0], y[j]);
    ext::E r = ext::add(v0, ext::mul(bmy, slope));
    if (ro) r = ext::add(r, ext::mul(beta_sq, ext::load(ro + 4 * j)));
    ext::store(out + 4 * j, r);
  }
}

// pts: per point 12 words: p(z) alpha-combined, z, alpha_pow.
__global__ void reduced_open_kernel(const uint32_t* __restrict__ mat,
                                    long long row_stride, int w, long long h,
                                    const uint32_t* __restrict__ apows, int npts,
                                    const uint32_t* __restrict__ pts,
                                    const uint32_t* __restrict__ xs,
                                    uint32_t* __restrict__ ro) {
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < h;
       r += (long long)gridDim.x * blockDim.x) {
    const uint32_t* row = mat + r * row_stride;
    ext::E comb = ext::zero();
    for (int t = 0; t < w; ++t)
      comb = ext::add(comb, ext::scale(ext::load(apows + 4 * t), row[t]));
    ext::E acc = ext::load(ro + 4 * r);
    const uint32_t x = xs[r];
    for (int p = 0; p < npts; ++p) {
      const ext::E num = ext::sub(ext::load(pts + 12 * p), comb);
      ext::E zmx = ext::load(pts + 12 * p + 4);
      zmx.c[0] = bb::sub(zmx.c[0], x);
      const ext::E q = ext::mul(num, ext::inv(zmx));
      acc = ext::add(acc, ext::mul(ext::load(pts + 12 * p + 8), q));
    }
    ext::store(ro + 4 * r, acc);
  }
}

int blocks_for(long long n, int threads) {
  const long long want = (n + threads - 1) / threads;
  return (int)(want < 132 * 32 ? want : 132 * 32);
}

}  // namespace

extern "C" int ovt_fri_fold(const void* evals, const void* beta, const void* y,
                            const void* inv_neg2y, const void* ro, long long half,
                            void* out, void* stream) {
  if (half <= 0) return (int)cudaGetLastError();
  fri_fold_kernel<<<blocks_for(half, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)evals, (const uint32_t*)beta, (const uint32_t*)y,
      (const uint32_t*)inv_neg2y, (const uint32_t*)ro, half, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int ovt_reduced_open(const void* mat, long long row_stride, int w,
                                long long h, const void* apows, int npts,
                                const void* pts, const void* xs, void* ro,
                                void* stream) {
  if (h <= 0) return (int)cudaGetLastError();
  reduced_open_kernel<<<blocks_for(h, 128), 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mat, row_stride, w, h, (const uint32_t*)apows, npts,
      (const uint32_t*)pts, (const uint32_t*)xs, (uint32_t*)ro);
  return (int)cudaGetLastError();
}
