// K3: radix-2 NTT and coset LDE down the rows of an (N, W) row-major matrix.
//
// Replaces openvm_tpu/ntt.py: _dif_stages (:60), ntt (:80), intt (:92),
// coset_lde (:117) and bitrev_rows (:55).
// Bound on this card: bytes.  A butterfly is one Montgomery product and two
// additions per pair of words, far below what the card can compute per byte.
// Design, first version: one launch per decimation-in-frequency stage, each
// thread one butterfly of one column, neighbouring threads on neighbouring
// columns of a row so loads and stores coalesce; the stage runs in place
// after the first.  A second kernel moves whole rows: bit-reversal, the
// row-wise multiply by 1/N or by the coset-shift powers, and the zero-pad of
// the LDE, in one pass.  Each stage still reads and writes the whole matrix,
// so the LDE moves about 2*log2(N) times the bytes of its bound; passes of
// several stages in shared memory are the next step.
// The wrapper guarantees N*W < 2^32, so 32-bit indices suffice.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

// `in` may equal `out`: each thread reads its two words before writing them.
__global__ void ntt_dif_stage_kernel(const uint32_t* in, uint32_t* out,
                                     const uint32_t* __restrict__ tw,
                                     int log_n, uint32_t w, int s) {
  const uint32_t total = (1u << (log_n - 1)) * w;
  const uint32_t idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const uint32_t bf = idx / w;
  const uint32_t col = idx - bf * w;
  const int half_log = log_n - s - 1;  // butterfly span 2^half_log rows
  const uint32_t j = bf & ((1u << half_log) - 1u);
  const uint32_t r0 = ((bf >> half_log) << (half_log + 1)) | j;
  const uint32_t i0 = r0 * w + col;
  const uint32_t i1 = i0 + (w << half_log);
  const uint32_t a = in[i0];
  const uint32_t b = in[i1];
  out[i0] = bb::add(a, b);
  out[i1] = bb::mul(bb::sub(a, b), tw[j << s]);
}

// out[i, c] = i < n ? in[src(i), c] * pw[i] : 0 for i < big_n, where src
// bit-reverses log2(n) bits when bitrev_log > 0 and pw == nullptr skips the
// multiply.
__global__ void ntt_rows_kernel(const uint32_t* __restrict__ in,
                                uint32_t* __restrict__ out,
                                const uint32_t* __restrict__ pw, uint32_t n,
                                uint32_t big_n, uint32_t w, int bitrev_log) {
  const uint32_t idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= big_n * w) return;
  const uint32_t row = idx / w;
  const uint32_t col = idx - row * w;
  uint32_t v = 0;
  if (row < n) {
    const uint32_t src = bitrev_log > 0 ? __brev(row) >> (32 - bitrev_log) : row;
    v = in[src * w + col];
    if (pw != nullptr) v = bb::mul(v, pw[row]);
  }
  out[idx] = v;
}

unsigned blocks_for(uint64_t total, unsigned threads) {
  return (unsigned)((total + threads - 1) / threads);
}

}  // namespace

extern "C" int ovt_ntt_dif_stage(const void* in, void* out, const void* tw,
                                 int log_n, unsigned w, int s, void* stream) {
  const uint64_t total = (uint64_t(1) << (log_n - 1)) * w;
  if (total == 0) return (int)cudaGetLastError();
  ntt_dif_stage_kernel<<<blocks_for(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)tw, log_n, w, s);
  return (int)cudaGetLastError();
}

extern "C" int ovt_ntt_rows(const void* in, void* out, const void* pw,
                            unsigned n, unsigned big_n, unsigned w,
                            int bitrev_log, void* stream) {
  const uint64_t total = (uint64_t)big_n * w;
  if (total == 0) return (int)cudaGetLastError();
  ntt_rows_kernel<<<blocks_for(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, (const uint32_t*)pw, n, big_n, w,
      bitrev_log);
  return (int)cudaGetLastError();
}
