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
#include <cooperative_groups.h>
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

// K5, one layer: one thread per output digest, the pair (64 bytes) and the
// injected digest (32 bytes) read as 16-byte vectors.
__global__ void poseidon2_compress_layer_kernel(
    const uint32_t* __restrict__ prev, const uint32_t* __restrict__ inj,
    uint32_t* __restrict__ out, uint32_t h_out) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= h_out) return;
  uint32_t s[WIDTH];
  const uint4* pair = reinterpret_cast<const uint4*>(prev) + (uint64_t)i * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint4 v = pair[k];
    s[4 * k] = v.x;
    s[4 * k + 1] = v.y;
    s[4 * k + 2] = v.z;
    s[4 * k + 3] = v.w;
  }
  permute(s);
  if (inj != nullptr) {
    const uint4* in = reinterpret_cast<const uint4*>(inj) + (uint64_t)i * 2;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const uint4 v = in[k];
      s[RATE + 4 * k] = v.x;
      s[RATE + 4 * k + 1] = v.y;
      s[RATE + 4 * k + 2] = v.z;
      s[RATE + 4 * k + 3] = v.w;
    }
    permute(s);
  }
  uint4* dst = reinterpret_cast<uint4*>(out) + (uint64_t)i * 2;
  dst[0] = make_uint4(s[0], s[1], s[2], s[3]);
  dst[1] = make_uint4(s[4], s[5], s[6], s[7]);
}

// ---------------------------------------------------------------------------
// K5's tail: every layer from an output height of at most TAIL_MAX digests
// to the root, in one launch of one thread-block cluster.  A small layer
// cannot fill the card, so what it costs is one permutation's dependent
// chain (and, one launch per layer, the launch); here four threads hold one
// state, thread q of a group the lanes 4q..4q+3 (M4 block q):
//  * the external layer's M4 is local and its sum over the four blocks two
//    xor-shuffles per lane;
//  * a partial round puts lane 0 through the S-box (every thread computes
//    it, thread 0 keeps it), sums its four lanes into one canonical word and
//    the group's four sums by two xor-shuffles, then applies the diagonal;
//  * the diagonal is one Montgomery product of each lane by its entry's
//    Montgomery form (for 2^-k that is the word 2^(32-k), the reduction of
//    x << (32-k) that K4 uses; for +-1..4 the small multiple), so the four
//    threads of a group run the same instructions;
//  * the round constants are staged in shared memory, where the four
//    threads' different words fall in different banks.
// The cluster's TAIL_BLOCKS blocks (on as many SMs) hold TAIL_MAX groups,
// group g of the cluster the layer's state g: the first layer of TAIL_MAX
// states is spread over TAIL_BLOCKS SMs, and a warp whose groups are all
// past the layer's height skips it.  A block keeps its states' digests in
// shared memory (two buffers, one a layer) and the next layer reads its
// pairs from the owning blocks' buffers through distributed shared memory,
// one cluster barrier a layer; every layer is also written out to the tree,
// and injected row digests are compressed in at any height.
// ---------------------------------------------------------------------------

constexpr int TAIL_BLOCKS = 8;  // a portable cluster
constexpr int TAIL_THREADS = 256;
constexpr int TAIL_GROUPS = TAIL_THREADS / 4;  // states a block holds
constexpr int TAIL_MAX = TAIL_BLOCKS * TAIL_GROUPS;  // merkle.py TAIL_MAX
constexpr int TAIL_LAYERS = 10;

// plonky3's BabyBear internal diagonal (poseidon2.py PLONKY3_DIAG) in
// Montgomery form: diag * 2^32 mod p.
constexpr uint64_t pow_p(uint64_t b, uint64_t e) {
  uint64_t r = 1;
  b %= bb::P;
  while (e) {
    if (e & 1) r = r * b % bb::P;
    b = b * b % bb::P;
    e >>= 1;
  }
  return r;
}
constexpr uint32_t monty(uint64_t x) { return (uint32_t)(((x % bb::P) << 32) % bb::P); }
constexpr uint64_t inv2k(int k) { return pow_p(pow_p(2, k), bb::P - 2); }
constexpr uint64_t negp(uint64_t x) { return (bb::P - x % bb::P) % bb::P; }
__constant__ uint32_t c_diag_monty[WIDTH] = {
    monty(negp(2)), monty(1), monty(2), monty(inv2k(1)),
    monty(3), monty(4), monty(negp(inv2k(1))), monty(negp(3)),
    monty(negp(4)), monty(inv2k(8)), monty(inv2k(2)), monty(inv2k(3)),
    monty(inv2k(27)), monty(negp(inv2k(8))), monty(negp(inv2k(4))),
    monty(negp(inv2k(27)))};

struct TailArgs {
  const uint32_t* inj[TAIL_LAYERS];  // row digests injected at each layer, or null
  uint32_t* out[TAIL_LAYERS];        // each layer's digests
};

__device__ __forceinline__ uint32_t group_sum(uint32_t v) {
  v = bb::add(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return bb::add(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ void external_quad(uint32_t* x) {
  mat4(x);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = bb::add(x[i], group_sum(x[i]));
}

// The permutation of the state whose lanes 4q..4q+3 this thread holds in x.
__device__ __forceinline__ void permute_quad(uint32_t* x, int q, const uint32_t* rc,
                                             const uint32_t* diag) {
  external_quad(x);
#pragma unroll 1
  for (int r = 0; r < 2 * HALF_FULL_ROUNDS; ++r) {
    // rc: the 4 beginning rounds, then the 4 ending rounds, 16 words each
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = sbox(bb::add(x[i], rc[r * WIDTH + 4 * q + i]));
    external_quad(x);
    if (r == HALF_FULL_ROUNDS - 1) {
#pragma unroll 1
      for (int p = 0; p < PARTIAL_ROUNDS; ++p) {
        const uint32_t x0 = sbox(bb::add(x[0], c_partial_rc[p]));
        if (q == 0) x[0] = x0;
        const uint32_t sum = group_sum(reduce_sum((uint64_t)(x[0] + x[1]) + (x[2] + x[3])));
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = bb::add(sum, bb::mul(x[i], diag[i]));
      }
    }
  }
}

__global__ void __cluster_dims__(TAIL_BLOCKS, 1, 1) __launch_bounds__(TAIL_THREADS)
poseidon2_compress_tail_kernel(const uint32_t* __restrict__ prev, TailArgs args,
                               int n_layers, uint32_t h0) {
  namespace cg = cooperative_groups;
  __shared__ uint4 buf[2][TAIL_GROUPS * 2];  // this block's digests, by layer parity
  __shared__ uint32_t rc[2 * HALF_FULL_ROUNDS * WIDTH];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  for (int i = threadIdx.x; i < HALF_FULL_ROUNDS * WIDTH; i += blockDim.x) {
    rc[i] = c_begin_rc[i];
    rc[HALF_FULL_ROUNDS * WIDTH + i] = c_end_rc[i];
  }
  const int q = threadIdx.x & 3;
  const uint32_t g = rank * TAIL_GROUPS + (threadIdx.x >> 2);  // the cluster's group
  const uint32_t warp0 = rank * TAIL_GROUPS + (threadIdx.x & ~31u) / 4;  // its warp's first group
  uint32_t diag[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) diag[i] = c_diag_monty[4 * q + i];
  __syncthreads();
  for (int t = 0; t < n_layers; ++t) {
    const uint32_t h = h0 >> t;
    if (warp0 < h) {
      const uint32_t s = g & (h - 1);  // groups past h (h < 8) repeat a state
      uint4 v;
      if (t == 0) {
        v = reinterpret_cast<const uint4*>(prev)[s * 4 + q];
      } else {  // digest 2s + (q >> 1) of the last layer, its half q & 1
        const uint32_t dgt = 2 * s + (q >> 1);
        const uint4* owner = cluster.map_shared_rank(&buf[(t - 1) & 1][0],
                                                     (int)(dgt / TAIL_GROUPS));
        v = owner[(dgt % TAIL_GROUPS) * 2 + (q & 1)];
      }
      uint32_t x[4] = {v.x, v.y, v.z, v.w};
      permute_quad(x, q, rc, diag);
      if (args.inj[t] != nullptr) {
        if (q >= 2) {
          const uint4 w = reinterpret_cast<const uint4*>(args.inj[t])[s * 2 + q - 2];
          x[0] = w.x;
          x[1] = w.y;
          x[2] = w.z;
          x[3] = w.w;
        }
        permute_quad(x, q, rc, diag);
      }
      if (q < 2 && g < h) {
        const uint4 o = make_uint4(x[0], x[1], x[2], x[3]);
        reinterpret_cast<uint4*>(args.out[t])[s * 2 + q] = o;
        buf[t & 1][(g % TAIL_GROUPS) * 2 + q] = o;
      }
    }
    cluster.sync();  // the layer's digests are visible to the whole cluster
  }
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

// Layers t < n_layers of h0 >> t outputs from prev (2 h0 digests); inj and
// out: host arrays of n_layers device pointers (inj entries may be null).
extern "C" int ovt_poseidon2_compress_tail(const void* prev, const void* const* inj,
                                           void* const* out, int n_layers,
                                           unsigned h0, void* stream) {
  if (n_layers < 1 || n_layers > TAIL_LAYERS || h0 > (unsigned)TAIL_MAX ||
      h0 != (1u << (n_layers - 1)))
    return (int)cudaErrorInvalidValue;
  TailArgs args = {};
  for (int t = 0; t < n_layers; ++t) {
    args.inj[t] = (const uint32_t*)inj[t];
    args.out[t] = (uint32_t*)out[t];
  }
  poseidon2_compress_tail_kernel<<<TAIL_BLOCKS, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)prev, args, n_layers, h0);
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
