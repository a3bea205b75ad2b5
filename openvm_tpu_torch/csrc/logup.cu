// K9 and K10: the LogUp permutation trace.
//
// K9 (ovt_perm_cols) replaces openvm_tpu/stark/logup.py batched_denoms
// (:231) and _perm_block (:247), over the interaction fields and counts
// that the quotient interpreter's columns mode evaluated (stack_interactions,
// :155).  For each row and interaction i, d = alpha + bus_i +
// sum_j beta^(j+1) * f_ij, and the interaction adds sign_i * count_i / d to
// its chunk's column; the inverse of 0 is 0 (babybear.py:234), as in the
// JAX package.  Output: the first 4m columns of the (N, 4m + 4) permutation
// trace, whose last 4 columns K10 fills with phi.
// Bound: operations.  The function needs per interaction its fields'
// products and adds, a batch inverse (3 extension products) and the scale;
// each row reads its field and count words and writes 16m bytes.
// Design, first version: one thread per row walks the interactions in
// order (chunks are contiguous and ascending, as chunk_interactions builds
// them), keeps the current chunk's sum in registers and writes it when the
// chunk ends.  Each interaction takes a full extension inverse through the
// norm (a Fermat inverse of the norm, 61 products); batch inversion across
// a row's interactions is the next step.
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

__global__ void perm_cols_kernel(const uint32_t* __restrict__ cols, uint32_t n,
                                 const int4* __restrict__ table, int n_its,
                                 const uint32_t* __restrict__ bus_m,
                                 const uint32_t* __restrict__ beta_pows,
                                 const uint32_t* __restrict__ alpha_p, int m,
                                 uint32_t* __restrict__ out) {
  const ext::E alpha = ext::load(alpha_p);
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    uint32_t* row = out + (4ull * m + 4) * j;
    ext::E acc = ext::zero();
    int chunk = table[0].z;
    for (int i = 0; i < n_its; ++i) {
      const int4 t = table[i];  // first field row, fields, chunk, is_send
      if (t.z != chunk) {
        ext::store(row + 4 * chunk, acc);
        acc = ext::zero();
        chunk = t.z;
      }
      ext::E d = alpha;
      d.c[0] = bb::add(d.c[0], bus_m[i]);
      for (int f = 0; f < t.y; ++f) {
        const uint32_t v = cols[(unsigned long long)(t.x + f) * n + j];
        d = ext::add(d, ext::scale(ext::load(beta_pows + 4 * f), v));
      }
      const uint32_t count = cols[(unsigned long long)(t.x + t.y) * n + j];
      ext::E v = ext::scale(ext::inv(d), count);
      acc = t.w ? ext::add(acc, v) : ext::sub(acc, v);
    }
    ext::store(row + 4 * chunk, acc);
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

__device__ __forceinline__ ext::E to_e(const uint4& v) { return ext::E{{v.x, v.y, v.z, v.w}}; }
__device__ __forceinline__ uint4 to_u4(const ext::E& e) {
  return make_uint4(e.c[0], e.c[1], e.c[2], e.c[3]);
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

extern "C" int ovt_perm_cols(const void* cols, unsigned n, const void* table,
                             int n_its, const void* bus_m, const void* beta_pows,
                             const void* alpha, int m, void* out, void* stream) {
  const int threads = 128;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  perm_cols_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cols, n, (const int4*)table, n_its, (const uint32_t*)bus_m,
      (const uint32_t*)beta_pows, (const uint32_t*)alpha, m, (uint32_t*)out);
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
