// K9 and K10: the LogUp permutation trace.
//
// K9 (ovt_perm_cols) replaces openvm_tpu/stark/logup.py batched_denoms
// (:231) and _perm_block (:247), over the interaction fields and counts
// that the quotient interpreter's columns mode evaluated (stack_interactions,
// :155).  For each row and interaction i, d = alpha + bus_i +
// sum_j beta^(j+1) * f_ij, and the interaction adds sign_i * count_i / d to
// its chunk's column; the inverse of 0 is 0 (babybear.py:234), as in the
// JAX package.  Output: (N, 4m) Montgomery words.
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
// m chunks, the inclusive prefix sum of the row sums down the rows (phi),
// the (N, 4m + 4) matrix [perm columns | phi] and phi's last row, the
// cumulative sum.  Bound: bytes (each row reads 16m and writes 16m + 16).
// Design: three launches.  A block of 1024 rows copies its perm columns,
// sums its rows and scans them (warp shuffles, then the warp totals); a
// single block scans the block totals into exclusive prefixes (and the
// grand total, the cumulative sum); every block then adds its prefix to its
// phi rows.  Modular addition is associative, so this order gives the same
// words as any other.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int SCAN_ROWS = 1024;  // rows per block of the scan, one per thread

__global__ void perm_cols_kernel(const uint32_t* __restrict__ cols, uint32_t n,
                                 const int4* __restrict__ table, int n_its,
                                 const uint32_t* __restrict__ bus_m,
                                 const uint32_t* __restrict__ beta_pows,
                                 const uint32_t* __restrict__ alpha_p, int m,
                                 uint32_t* __restrict__ out) {
  const ext::E alpha = ext::load(alpha_p);
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    uint32_t* row = out + 4ull * m * j;
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

// Inclusive scan of one value per thread over a block of SCAN_ROWS threads;
// every thread of the block must call it.  *total gets the block's sum.
__device__ ext::E block_scan(ext::E v, ext::E* total) {
  __shared__ uint32_t warp_sums[SCAN_ROWS / 32][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const ext::E o = shfl_up(v, off);
    if (lane >= off) v = ext::add(v, o);
  }
  if (lane == 31) ext::store(warp_sums[warp], v);
  __syncthreads();
  if (warp == 0) {
    ext::E w = ext::load(warp_sums[lane]);
    for (int off = 1; off < 32; off <<= 1) {
      const ext::E o = shfl_up(w, off);
      if (lane >= off) w = ext::add(w, o);
    }
    ext::store(warp_sums[lane], w);
  }
  __syncthreads();
  if (warp > 0) v = ext::add(v, ext::load(warp_sums[warp - 1]));
  *total = ext::load(warp_sums[SCAN_ROWS / 32 - 1]);
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

__global__ void __launch_bounds__(SCAN_ROWS)
scan_rows_kernel(const uint32_t* __restrict__ perm, long long stride, int m,
                 uint32_t n, uint32_t* __restrict__ out,
                 uint32_t* __restrict__ totals) {
  const uint32_t j = blockIdx.x * SCAN_ROWS + threadIdx.x;
  const int w_out = 4 * m + 4;
  ext::E s = ext::zero();
  if (j < n) {
    for (int c = 0; c < m; ++c) {
      const ext::E x = ext::load(perm + j * stride + 4 * c);
      ext::store(out + (unsigned long long)j * w_out + 4 * c, x);
      s = ext::add(s, x);
    }
  }
  ext::E total;
  s = block_scan(s, &total);
  if (j < n) ext::store(out + (unsigned long long)j * w_out + 4 * m, s);
  if (threadIdx.x == 0) ext::store(totals + 4ull * blockIdx.x, total);
}

__global__ void __launch_bounds__(SCAN_ROWS)
scan_totals_kernel(uint32_t* __restrict__ totals, int n_blocks,
                   uint32_t* __restrict__ cumsum) {
  ext::E carry = ext::zero();
  for (int base = 0; base < n_blocks; base += SCAN_ROWS) {
    const int i = base + threadIdx.x;
    const ext::E v = i < n_blocks ? ext::load(totals + 4 * i) : ext::zero();
    ext::E total;
    const ext::E incl = block_scan(v, &total);
    if (i < n_blocks) ext::store(totals + 4 * i, ext::add(carry, ext::sub(incl, v)));
    carry = ext::add(carry, total);
  }
  if (threadIdx.x == 0) ext::store(cumsum, carry);
}

__global__ void __launch_bounds__(SCAN_ROWS)
scan_add_kernel(uint32_t* __restrict__ out, int m, uint32_t n,
                const uint32_t* __restrict__ totals) {
  const uint32_t j = blockIdx.x * SCAN_ROWS + threadIdx.x;
  if (blockIdx.x == 0 || j >= n) return;
  uint32_t* phi = out + (unsigned long long)j * (4 * m + 4) + 4 * m;
  ext::store(phi, ext::add(ext::load(phi), ext::load(totals + 4ull * blockIdx.x)));
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

extern "C" int ovt_perm_scan(const void* perm, long long stride, int m, unsigned n,
                             void* out, void* totals, void* cumsum, void* stream) {
  const int n_blocks = (int)((n + SCAN_ROWS - 1) / SCAN_ROWS);
  cudaStream_t s = (cudaStream_t)stream;
  scan_rows_kernel<<<n_blocks, SCAN_ROWS, 0, s>>>(
      (const uint32_t*)perm, stride, m, n, (uint32_t*)out, (uint32_t*)totals);
  scan_totals_kernel<<<1, SCAN_ROWS, 0, s>>>((uint32_t*)totals, n_blocks,
                                             (uint32_t*)cumsum);
  scan_add_kernel<<<n_blocks, SCAN_ROWS, 0, s>>>((uint32_t*)out, m, n,
                                                 (const uint32_t*)totals);
  return (int)cudaGetLastError();
}
