// K4 and K5: width-16 Poseidon2 over BabyBear (x^7 S-box, 4 + 13 + 4 rounds).
//
// K4 poseidon2_hash_rows replaces openvm_tpu/poseidon2.py: _permute_impl
// (:175) and hash_rows (:213), the rate-8 overwrite sponge over each row.
// K5 poseidon2_compress_layer replaces poseidon2.py compress_pairs (:230) as
// merkle.py commit_layers (:49) uses it: one tree layer, prev[0::2] ||
// prev[1::2] compressed, then optionally compressed with the row digests of
// the matrices injected at that height.
// Bound on this card: integer operations.  A permutation is 564 Montgomery
// products, 117 Montgomery reductions and about 1,300 modular additions on
// 64 bytes of state, so both kernels do hundreds of operations per byte
// they move.
// Design: one thread per state, the 16 lanes in registers (every lane loop
// is unrolled so no lane is ever indexed at run time), round constants in
// __constant__ memory, where every thread of a warp reads the same word at
// the same time and the read is a broadcast.  The constants are uploaded
// from Python (ovt_p2_set_constants) before the first launch and again after
// every poseidon2.set_round_constants.
// The permutation spends as few operations as the structure allows:
//  * the internal layer's diagonal is plonky3's BabyBear diagonal
//    [-2, 1, 2, 1/2, 3, 4, -1/2, -3, -4, 1/2^8, 1/4, 1/8, 1/2^27, -1/2^8,
//    -1/16, -1/2^27] (the wrapper checks it before every upload), so a
//    lane times +-1..4 is made of additions and a lane times 2^-k is one
//    Montgomery reduction of x << (32 - k), with no 32x32 product;
//  * the internal layer's 16-lane sum adds canonical words in pairs below
//    2^32, then in 64 bits, and reduces once (the external layer's sums of
//    four stay modular additions: the 64-bit form of so short a sum costs
//    as many instructions).
// K4 reads a block's 128 rows, which are one contiguous span of memory,
// through shared memory: a warp loads one row's 32-word window with
// neighbouring threads on neighbouring words, then each thread absorbs its
// own row from there.
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

// The Montgomery product from the two halves of a b, with no 64-bit
// register: a b - m p is hi - umulhi(m, p) times 2^32 when m = lo p^-1
// (their low words cancel), a value in (-p, p).
constexpr uint32_t PINV = bb::inv_mod_2_32(bb::P);

__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  const uint32_t hi = __umulhi(a, b);
  const uint32_t mh = __umulhi(a * b * PINV, bb::P);
  return bb::sub(hi, mh);
}

__device__ __forceinline__ uint32_t sbox(uint32_t x) {
  const uint32_t x2 = mul_hi(x, x);
  const uint32_t x3 = mul_hi(x2, x);
  return mul_hi(mul_hi(x3, x3), x);
}

// The canonical word of s mod p for s < 16p: 2^31 = 2^27 - 1 (mod p), so
// s = a 2^31 + b becomes b + a (2^27 - 1) < 2^31 + 15 (2^27 - 1) < 2.07p,
// then at most two subtractions.
__device__ __forceinline__ uint32_t reduce_sum(uint64_t s) {
  uint32_t v = (uint32_t)s & 0x7fffffffu;
  v += (uint32_t)(s >> 31) * ((1u << 27) - 1u);
  v = min(v, v - bb::P);
  return min(v, v - bb::P);
}

// x * 2^-K for a canonical word x: monty_reduce(y) = y 2^-32.
template <int K>
__device__ __forceinline__ uint32_t div_pow2(uint32_t x) {
  return bb::monty_reduce((uint64_t)x << (32 - K));
}

__device__ __forceinline__ uint32_t dbl(uint32_t x) { return bb::add(x, x); }

// plonky3 MDSMat4 on lanes x[0..4).
__device__ __forceinline__ void mat4(uint32_t* x) {
  const uint32_t t01 = bb::add(x[0], x[1]);
  const uint32_t t23 = bb::add(x[2], x[3]);
  const uint32_t t0123 = bb::add(t01, t23);
  const uint32_t t01123 = bb::add(t0123, x[1]);
  const uint32_t t01233 = bb::add(t0123, x[3]);
  const uint32_t y3 = bb::add(t01233, dbl(x[0]));
  const uint32_t y1 = bb::add(t01123, dbl(x[2]));
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

// Lane 0 through the S-box, then s[i] = diag[i] s[i] + sum(s) on every lane.
__device__ __forceinline__ void partial_round(uint32_t* s, int r) {
  s[0] = sbox(bb::add(s[0], c_partial_rc[r]));
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < WIDTH; i += 2) acc += s[i] + s[i + 1];  // each pair < 2p
  const uint32_t sum = reduce_sum(acc);
  s[0] = bb::sub(sum, dbl(s[0]));                      // -2
  s[1] = bb::add(sum, s[1]);                           // 1
  s[2] = bb::add(sum, dbl(s[2]));                      // 2
  s[3] = bb::add(sum, div_pow2<1>(s[3]));              // 1/2
  s[4] = bb::add(sum, bb::add(dbl(s[4]), s[4]));       // 3
  s[5] = bb::add(sum, dbl(dbl(s[5])));                 // 4
  s[6] = bb::sub(sum, div_pow2<1>(s[6]));              // -1/2
  s[7] = bb::sub(sum, bb::add(dbl(s[7]), s[7]));       // -3
  s[8] = bb::sub(sum, dbl(dbl(s[8])));                 // -4
  s[9] = bb::add(sum, div_pow2<8>(s[9]));              // 1/2^8
  s[10] = bb::add(sum, div_pow2<2>(s[10]));            // 1/4
  s[11] = bb::add(sum, div_pow2<3>(s[11]));            // 1/8
  s[12] = bb::add(sum, div_pow2<27>(s[12]));           // 1/2^27
  s[13] = bb::sub(sum, div_pow2<8>(s[13]));            // -1/2^8
  s[14] = bb::sub(sum, div_pow2<4>(s[14]));            // -1/16
  s[15] = bb::sub(sum, div_pow2<27>(s[15]));           // -1/2^27
}

__device__ __forceinline__ void permute(uint32_t* s) {
  external_linear(s);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL_ROUNDS; ++r) full_round<true>(s, r);
#pragma unroll 1
  for (int r = 0; r < PARTIAL_ROUNDS; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = 0; r < HALF_FULL_ROUNDS; ++r) full_round<false>(s, r);
}

constexpr int ROWS = 128;    // rows (threads) per block
constexpr int WINDOW = 32;   // columns staged in shared memory at a time

__global__ void __launch_bounds__(ROWS)
poseidon2_hash_rows_kernel(const uint32_t* __restrict__ mat, uint32_t* __restrict__ out,
                           uint32_t n, uint32_t w) {
  __shared__ uint32_t tile[ROWS][WINDOW + 1];  // +1: a row's words in distinct banks
  const uint32_t row0 = blockIdx.x * ROWS;
  const uint32_t rows = n - row0 < ROWS ? n - row0 : ROWS;
  const uint32_t* span = mat + (uint64_t)row0 * w;  // rows * w contiguous words
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  uint32_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = 0;
  for (uint32_t c0 = 0; c0 < w; c0 += WINDOW) {
    const uint32_t cw = w - c0 < WINDOW ? w - c0 : WINDOW;
    __syncthreads();
    for (uint32_t r = warp; r < rows; r += ROWS / 32)
      if (lane < cw) tile[r][lane] = span[(uint64_t)r * w + c0 + lane];
    __syncthreads();
    for (uint32_t j0 = 0; j0 < cw; j0 += RATE) {
      // A short last chunk overwrites only its k lanes.
      const uint32_t k = cw - j0 < RATE ? cw - j0 : RATE;
#pragma unroll
      for (uint32_t i = 0; i < RATE; ++i)
        if (i < k) s[i] = tile[threadIdx.x][j0 + i];
      permute(s);
    }
  }
  if (threadIdx.x < rows) {
    uint4* dst = reinterpret_cast<uint4*>(out + (uint64_t)(row0 + threadIdx.x) * RATE);
    dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
    dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
  }
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

// Host arrays of Montgomery words: begin (4*16), partial (13), end (4*16).
// The copies are ordered on `stream` before later launches.
extern "C" int ovt_p2_set_constants(const void* begin, const void* partial,
                                    const void* end, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_begin_rc, begin, sizeof(c_begin_rc),
                                          0, cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_partial_rc, partial, sizeof(c_partial_rc), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_end_rc, end, sizeof(c_end_rc), 0,
                                cudaMemcpyHostToDevice, s);
  if (e == cudaSuccess) e = cudaStreamSynchronize(s);
  return e == cudaSuccess ? (int)cudaGetLastError() : (int)e;
}

extern "C" int ovt_poseidon2_hash_rows(const void* mat, void* out, unsigned n,
                                       unsigned w, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  poseidon2_hash_rows_kernel<<<(n + ROWS - 1) / ROWS, ROWS, 0, (cudaStream_t)stream>>>(
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
