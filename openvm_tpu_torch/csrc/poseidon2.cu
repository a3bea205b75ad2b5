// K4 and K5: width-16 Poseidon2 over BabyBear (x^7 S-box, 4 + 13 + 4 rounds).
//
// K4 poseidon2_hash_rows replaces openvm_tpu/poseidon2.py: _permute_impl
// (:175) and hash_rows (:213), the rate-8 overwrite sponge over each row.
// K5 poseidon2_compress_layer replaces poseidon2.py compress_pairs (:230) as
// merkle.py commit_layers (:49) uses it: one tree layer, prev[0::2] ||
// prev[1::2] compressed, then optionally compressed with the row digests of
// the matrices injected at that height.
// Bound on this card: integer operations.  A permutation is about 770
// Montgomery products and 1,200 modular additions on 64 bytes of state, so
// both kernels do hundreds of operations per byte they move.
// Design: one thread per state, the 16 lanes in registers (every lane loop
// is unrolled so no lane is ever indexed at run time), round constants and
// the internal diagonal in __constant__ memory, where every thread of a warp
// reads the same word at the same time and the read is a broadcast.  The
// constants are uploaded from Python (ovt_p2_set_constants) before the first
// launch and again after every poseidon2.set_round_constants.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int WIDTH = 16;
constexpr int RATE = 8;
constexpr int HALF_FULL_ROUNDS = 4;
constexpr int PARTIAL_ROUNDS = 13;

__constant__ uint32_t c_begin_rc[HALF_FULL_ROUNDS * WIDTH];
__constant__ uint32_t c_partial_rc[PARTIAL_ROUNDS];
__constant__ uint32_t c_end_rc[HALF_FULL_ROUNDS * WIDTH];
__constant__ uint32_t c_diag[WIDTH];

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = bb::mul(x, x);
  const uint32_t x3 = bb::mul(x2, x);
  return bb::mul(bb::mul(x3, x3), x);
}

// plonky3 MDSMat4 on lanes x[0..4).
__device__ __forceinline__ void mat4(uint32_t* x) {
  const uint32_t t01 = bb::add(x[0], x[1]);
  const uint32_t t23 = bb::add(x[2], x[3]);
  const uint32_t t0123 = bb::add(t01, t23);
  const uint32_t t01123 = bb::add(t0123, x[1]);
  const uint32_t t01233 = bb::add(t0123, x[3]);
  const uint32_t y3 = bb::add(t01233, bb::add(x[0], x[0]));
  const uint32_t y1 = bb::add(t01123, bb::add(x[2], x[2]));
  const uint32_t y0 = bb::add(t01123, t01);
  const uint32_t y2 = bb::add(t01233, t23);
  x[0] = y0;
  x[1] = y1;
  x[2] = y2;
  x[3] = y3;
}

// mds_light_permutation: M4 on each block of 4, then add the column sums.
__device__ __forceinline__ void external_linear(uint32_t* s) {
#pragma unroll
  for (int b = 0; b < 4; ++b) mat4(s + 4 * b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t sum =
        bb::add(bb::add(s[i], s[4 + i]), bb::add(s[8 + i], s[12 + i]));
#pragma unroll
    for (int b = 0; b < 4; ++b) s[4 * b + i] = bb::add(s[4 * b + i], sum);
  }
}

// Round r of the beginning (BEGIN) or ending full rounds.  The constant
// arrays are indexed directly, never through a pointer, so the loads stay
// in the constant space.
template <bool BEGIN>
__device__ __forceinline__ void full_round(uint32_t* s, int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) {
    const uint32_t rc = BEGIN ? c_begin_rc[r * WIDTH + i] : c_end_rc[r * WIDTH + i];
    s[i] = sbox(bb::add(s[i], rc));
  }
  external_linear(s);
}

__device__ __forceinline__ void permute(uint32_t* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL_ROUNDS; ++r) full_round<true>(s, r);
#pragma unroll 1
  for (int r = 0; r < PARTIAL_ROUNDS; ++r) {
    s[0] = sbox(bb::add(s[0], c_partial_rc[r]));
    uint32_t sum = s[0];
#pragma unroll
    for (int i = 1; i < WIDTH; ++i) sum = bb::add(sum, s[i]);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = bb::add(bb::mul(s[i], c_diag[i]), sum);
  }
#pragma unroll 1
  for (int r = 0; r < HALF_FULL_ROUNDS; ++r) full_round<false>(s, r);
}

__global__ void poseidon2_hash_rows_kernel(const uint32_t* __restrict__ mat,
                                           uint32_t* __restrict__ out,
                                           uint32_t n, uint32_t w) {
  const uint32_t row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const uint32_t* src = mat + (uint64_t)row * w;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  for (uint32_t c0 = 0; c0 < w; c0 += RATE) {
    // A short last chunk overwrites only its k lanes.
    const uint32_t k = w - c0 < RATE ? w - c0 : RATE;
#pragma unroll
    for (uint32_t i = 0; i < RATE; ++i)
      if (i < k) s[i] = src[c0 + i];
    permute(s);
  }
#pragma unroll
  for (int i = 0; i < RATE; ++i) out[(uint64_t)row * RATE + i] = s[i];
}

__global__ void poseidon2_compress_layer_kernel(
    const uint32_t* __restrict__ prev, const uint32_t* __restrict__ inj,
    uint32_t* __restrict__ out, uint32_t h_out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h_out) return;
  uint32_t s[WIDTH];
  const uint32_t* pair = prev + (uint64_t)i * 2 * RATE;  // rows 2i and 2i+1
#pragma unroll
  for (int k = 0; k < WIDTH; ++k) s[k] = pair[k];
  permute(s);
  if (inj != nullptr) {
#pragma unroll
    for (int k = 0; k < RATE; ++k) s[RATE + k] = inj[(uint64_t)i * RATE + k];
    permute(s);
  }
#pragma unroll
  for (int k = 0; k < RATE; ++k) out[(uint64_t)i * RATE + k] = s[k];
}

}  // namespace

// Host arrays of Montgomery words: begin (4*16), partial (13), end (4*16),
// diag (16).  The copies are ordered on `stream` before later launches.
extern "C" int ovt_p2_set_constants(const void* begin, const void* partial,
                                    const void* end, const void* diag,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_begin_rc, begin, sizeof(c_begin_rc),
                                          0, cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_partial_rc, partial, sizeof(c_partial_rc), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_end_rc, end, sizeof(c_end_rc), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_diag, diag, sizeof(c_diag), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

extern "C" int ovt_poseidon2_hash_rows(const void* mat, void* out, unsigned n,
                                       unsigned w, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  poseidon2_hash_rows_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)mat, (uint32_t*)out, n, w);
  return (int)cudaGetLastError();
}

extern "C" int ovt_poseidon2_compress_layer(const void* prev, const void* inj,
                                            void* out, unsigned h_out,
                                            void* stream) {
  if (h_out == 0) return (int)cudaGetLastError();
  poseidon2_compress_layer_kernel<<<(h_out + 127) / 128, 128, 0,
                                    (cudaStream_t)stream>>>(
      (const uint32_t*)prev, (const uint32_t*)inj, (uint32_t*)out, h_out);
  return (int)cudaGetLastError();
}
