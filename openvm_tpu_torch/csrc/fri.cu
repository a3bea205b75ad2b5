// K13 and K14: the reduced openings and the FRI fold.
//
// K13 (ovt_reduced_open) replaces openvm_tpu/stark/prover.py _col_comb
// (:194) and the reduced-opening loop (:773-792), for every committed matrix
// of a prove in one launch.  The reference adds, matrix by matrix, over the
// rows r of each LDE height H,
//   ro[r] += sum_p alpha_mp (p_mp(z_p) - comb_m[r]) / (z_p - x_r),
//   comb_m[r] = sum_t alpha^t M_m[r, t],   x_r = g w_H^rev(r).
// Field addition is exact, so the kernel regroups the same sum per height:
//   ro[r] = sum_p N_p[r] / (z_p - x_r),
//   N_p[r] = C_p - sum_m alpha_mp comb_m[r],   C_p = sum_m alpha_mp p_mp(z_p),
// over the height's distinct points z_p (a trace matrix is opened at zeta
// and zeta g_n, a quotient chunk at zeta: every matrix of one height shares
// them).  The host works out alpha_mp and p_mp(z_p) in the transcript's
// order and C_p from them (stark/prover.py reduced_open_many).
// Bound: bytes (each matrix read once, ro written once).  The operations
// are the column combination (4 multiply-adds into 64 bits a word, a
// reduction a coefficient every 4 words), one delayed extension product a
// matrix and point, and per row and point z - x, a batch inverse and one
// product: below the bytes for every matrix wider than a few columns.
// Design:
//  * One launch for the whole prove over a job table (stark/prover.py
//    RH_*, RM_*): heights largest first, each a run of blocks of RO_TILE
//    rows (quotient.block_plan); per height its matrices (pointer, row
//    stride, width, the points they are opened at and their alpha_mp) and
//    its points.  The table, alpha's powers and the constants go up in one
//    copy a prove; ro is written once a row, so nothing is zeroed.
//  * Coalesced reads: a block stages its tile's (matrix, RO_COLS columns)
//    units in shared memory with cp.async, consecutive threads on
//    consecutive words, 16 bytes a copy where the width, the row stride and
//    the address allow it and 4 bytes otherwise, one unit at a time: the
//    other blocks of an SM overlap its copies (two to four buffers a block,
//    with fewer blocks an SM, measured slower).  A staged row's pitch is
//    odd (in words, or in 16-byte units), so the threads reading their own
//    rows hit distinct banks; a whole unit's combination is unrolled.
//  * Delayed reduction: comb_m sums each coefficient's products in 64 bits,
//    folded every 4 words (hi 2^32 = hi (2^32 mod p): one product) and
//    reduced once a matrix.  Weighting the columns by alpha_mp alpha^t
//    directly would cost 4 multiply-adds a word for every point: twice the
//    combination's for a matrix opened at two points.
//  * Inverses in the base field: for a base x, 1/(z - x) = -q(x) / f(x)
//    with f(x) = N(z - x) = prod_k (x - z^(p^k)) in the base field and
//    q(x) = f(x) / (x - z), both cubic or quartic in x with coefficients
//    the host works out per point (stark/prover.py _point_polys).  The f(x)
//    of a thread's RO_ROWS rows and every point share one base inverse
//    (Montgomery's trick, 3 products an element, ext::bb_inv_chain), where
//    an extension batch would take 3 extension products an element and an
//    extension inverse.  A zero f(x), z = x, enters the running product as
//    1 and contributes 0, as ext.inv(0) = 0 makes it in the reference.
//  * No table of the LDE height: x_r = g A(hi) B(lo) for r = hi 2^t + lo
//    (t = ROOT_BITS), B(lo) = w_{2^t}^rev_t(lo) from a 2^t table shared by
//    every height (for H <= 2^t, B(r) is w_H^rev(r) itself) and A(hi) =
//    w_H^rev(hi) made from the powers w_H^(2^k) = w_{H/2^k}, once a block
//    (a tile lies inside one hi).
//
// K14 (ovt_fri_fold) replaces openvm_tpu/fri.py fold_evals (:78) inside
// commit_phase (:104-133): v'[j] = v0 + (beta - y_j)(v1 - v0)/(-2 y_j),
// v0 = v[2j], v1 = v[2j+1], plus beta^2 ro[j] where a reduced opening of the
// new height exists, fused into the same pass.  One launch a fold level:
// beta is sampled after each level's root.
// Bound: bytes (32 read, 16 more with ro, 16 written an output).
// Design: two outputs a thread, its 64 input bytes in four 16-byte loads
// and its outputs in 16-byte stores.  y_j = w_H^rev(2j) and 1/(-2 y_j) =
// -1/2 w_H^-rev(2j) come from the same A(hi) B(lo) split as K13's x_r (and
// its inverse tables), with y_(j+1) = y_j w_4 for even j; no host table.
// Each extension product sums its coefficients in 64 bits (ext::mul_d).  A
// level takes the fewest blocks of at most FOLD_THREADS threads that cover
// it.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

constexpr int ROOT_BITS = 10;            // ntt.ROOT_BITS
constexpr int ROOT_N = 1 << ROOT_BITS;
constexpr int ROOT_GEN = 2 * ROOT_N;     // w_{2^j} at ROOT_GEN + j, j < 32
constexpr int ROOT_GEN_INV = ROOT_GEN + 32;
constexpr uint32_t NEG_HALF = ext::monty_of((bb::P - 1) / 2);  // -1/2

constexpr int RO_THREADS = 128, RO_ROWS = 2, RO_TILE = RO_THREADS * RO_ROWS;
constexpr int RO_COLS = 32;      // columns a staged unit
constexpr int RO_PITCH = 36;     // the most words a staged row takes
constexpr int RO_MAX_PTS = 4;    // distinct points a height
constexpr int RO_PT_WORDS = 5;   // uint4s a point: f, q0, q1, q2, C
constexpr int FOLD_THREADS = 256;

// stark/prover.py RH_* / RM_* and their word counts
enum Height : int { RH_LOG, RH_NMAT, RH_MAT0, RH_NPTS, RH_PT0, RH_OUT, RH_BLOCK0, RH_WORDS = 8 };
enum Mat : int { RM_PTR, RM_STRIDE, RM_W, RM_VEC, RM_MASK, RM_ALPHA, RM_WORDS = 6 };

static_assert(RO_TILE <= ROOT_N, "a tile lies inside one hi of the root split");

// w_H^(+-rev_(log_h - ROOT_BITS)(hi)) times s: the high part of the point
// split, one product for each set bit.
__device__ __forceinline__ uint32_t root_high(const uint32_t* __restrict__ roots, int gen,
                                              int log_h, unsigned long long hi, uint32_t s) {
  const int hb = log_h - ROOT_BITS;
  if (hb <= 0) return s;
  const uint32_t e = __brev((uint32_t)hi) >> (32 - hb);
  for (int k = 0; k < hb; ++k)
    if (e >> k & 1u) s = bb::mul(s, roots[gen + log_h - k]);
  return s;
}

__device__ __forceinline__ void copy_async4(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void copy_async16(uint32_t* dst, const uint32_t* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::
                   "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}

// One unit of a block's staging: columns [c0, c0 + cw) of a matrix's tile.
struct Unit {
  const uint32_t* src;  // the tile's first row at column c0
  long long stride;
  int cw, unit, pitch;  // words; copy unit 1 or 4 words; staged row pitch
};

__device__ __forceinline__ Unit unit_of(const long long* __restrict__ mj, long long r0, int c0) {
  Unit u;
  u.stride = mj[RM_STRIDE];
  u.src = (const uint32_t*)mj[RM_PTR] + r0 * u.stride + c0;
  u.cw = min(RO_COLS, (int)mj[RM_W] - c0);
  u.unit = mj[RM_VEC] ? 4 : 1;
  u.pitch = ((u.cw / u.unit) | 1) * u.unit;  // odd in copy units
  return u;
}

// Issue the cp.async copies of a unit's n_rows rows into buf, consecutive
// threads on consecutive copy units of a row.
__device__ __forceinline__ void stage_unit(const Unit& u, int n_rows, uint32_t* buf) {
  const int per_row = u.cw / u.unit;
  int row = threadIdx.x / per_row, col = threadIdx.x - row * per_row;
  const int drow = RO_THREADS / per_row, dcol = RO_THREADS - drow * per_row;
  for (; row < n_rows; row += drow) {
    uint32_t* dst = buf + row * u.pitch + col * u.unit;
    const uint32_t* src = u.src + row * u.stride + col * u.unit;
    if (u.unit == 4)
      copy_async16(dst, src);
    else
      copy_async4(dst, src);
    col += dcol;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
}

// wd += sum_t alpha^t row[t] over a staged row of cw words, coefficient by
// coefficient in 64 bits.  Every 4 words the sums are folded to below
// 2^60 + 2^32 (hi 2^32 = hi (2^32 mod p)), so 4 more products (each below
// p^2 < 2^62) fit; one reduction a matrix (bb::reduce_wide) follows.
// CW > 0: a whole unit of CW words, unrolled; CW = 0: cw words.
template <int CW>
__device__ __forceinline__ void combine(const uint32_t* row, const uint4* apow, int cw, int unit,
                                        uint64_t* wd) {
  constexpr uint64_t TWO32_MOD_P = (1ull << 32) % bb::P;
  if (CW) cw = CW;
#pragma unroll
  for (int t0 = 0; t0 < (CW ? CW : cw); t0 += 4) {
    uint32_t v[4];
    if (unit == 4) {
      const uint4 q = reinterpret_cast<const uint4*>(row)[t0 / 4];
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = t0 + u < cw ? row[t0 + u] : 0u;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) wd[c] = (wd[c] & 0xffffffffull) + (wd[c] >> 32) * TWO32_MOD_P;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const uint4 a = apow[min(t0 + u, cw - 1)];
      wd[0] += (uint64_t)a.x * v[u];
      wd[1] += (uint64_t)a.y * v[u];
      wd[2] += (uint64_t)a.z * v[u];
      wd[3] += (uint64_t)a.w * v[u];
    }
  }
}

// heights: n_heights rows of RH_WORDS int64, largest first; mats: RM_WORDS
// int64 a matrix, a height's matrices consecutive; consts: alpha^t for
// t < n_apow, then per height RO_PT_WORDS uint4s a point (f's coefficients
// a0..a3 as one uint4, q0, q1, q2, C_p; see stark/prover.py _point_polys),
// then per matrix its alpha_mp (one per point of its height); roots:
// ntt.rev_root_table.  Dynamic shared memory: alpha's powers, then the
// RO_TILE staged rows of one unit.
__global__ void __launch_bounds__(RO_THREADS)
reduced_open_kernel(const long long* __restrict__ heights, int n_heights,
                    const long long* __restrict__ mats, const uint4* __restrict__ consts,
                    int n_apow, const uint32_t* __restrict__ roots, uint32_t shift,
                    uint4* __restrict__ out) {
  extern __shared__ uint4 sm[];
  uint4* apow_s = sm;
  uint32_t* stage = reinterpret_cast<uint32_t*>(sm + n_apow);
  const int tid = threadIdx.x;
  for (int k = tid; k < n_apow; k += RO_THREADS) apow_s[k] = consts[k];
  int hk = 0;
  while (hk + 1 < n_heights && (long long)blockIdx.x >= heights[(hk + 1) * RH_WORDS + RH_BLOCK0])
    ++hk;
  const long long* hj = heights + hk * RH_WORDS;
  const int log_h = (int)hj[RH_LOG], npts = (int)hj[RH_NPTS], n_mat = (int)hj[RH_NMAT];
  const long long r0 = ((long long)blockIdx.x - hj[RH_BLOCK0]) * RO_TILE;
  const int n_rows = (int)min((long long)RO_TILE, (1ll << log_h) - r0);
  const long long* mat0 = mats + hj[RH_MAT0] * RM_WORDS;

  ext::E s[RO_ROWS][RO_MAX_PTS];
#pragma unroll
  for (int k = 0; k < RO_ROWS; ++k)
#pragma unroll
    for (int p = 0; p < RO_MAX_PTS; ++p) s[k][p] = ext::zero();

  // The tile's (matrix, RO_COLS columns) units in order, one staged at a
  // time: the other blocks of the SM overlap a block's copies.
  uint64_t wd[RO_ROWS][4] = {};
  for (int mi = 0; mi < n_mat; ++mi) {
    const long long* mj = mat0 + mi * RM_WORDS;
    for (int c0 = 0; c0 < (int)mj[RM_W]; c0 += RO_COLS) {
      const Unit u = unit_of(mj, r0, c0);
      __syncthreads();  // the last unit is read before this one is staged
      stage_unit(u, n_rows, stage);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // this unit's rows (and alpha's powers) are staged
#pragma unroll
      for (int k = 0; k < RO_ROWS; ++k) {
        const int rr = k * RO_THREADS + tid;
        if (rr >= n_rows) continue;
        if (u.cw == RO_COLS)
          combine<RO_COLS>(stage + rr * u.pitch, apow_s + c0, u.cw, u.unit, wd[k]);
        else
          combine<0>(stage + rr * u.pitch, apow_s + c0, u.cw, u.unit, wd[k]);
      }
    }
    // the matrix is combined: s_p += alpha_mp comb
    const uint32_t mask = (uint32_t)mj[RM_MASK];
#pragma unroll
    for (int k = 0; k < RO_ROWS; ++k) {
      const ext::E comb{{bb::reduce_wide(wd[k][0]), bb::reduce_wide(wd[k][1]),
                         bb::reduce_wide(wd[k][2]), bb::reduce_wide(wd[k][3])}};
#pragma unroll
      for (int p = 0; p < RO_MAX_PTS; ++p)
        if (mask >> p & 1u)
          s[k][p] = ext::add(s[k][p], ext::mul_d(ext::to_e(consts[mj[RM_ALPHA] + p]), comb));
#pragma unroll
      for (int c = 0; c < 4; ++c) wd[k][c] = 0;
    }
  }

  // x_r = g A(hi) B(lo); per point f(x) = N(z - x) in the base field and
  // 1/(z - x) = -q(x) / f(x); the f(x) of the thread's rows and points
  // share one base inverse (Montgomery's trick), a zero f(x) (z = x)
  // entering as 1 and contributing 0.  ro[r] = sum_p (s_p - C_p) q(x) / f(x).
  const uint32_t ga = root_high(roots, ROOT_GEN, log_h, (unsigned long long)r0 >> ROOT_BITS,
                                shift);
  const uint4* pts = consts + hj[RH_PT0];
  uint32_t x[RO_ROWS], f[RO_ROWS * RO_MAX_PTS], pre[RO_ROWS * RO_MAX_PTS];
  uint32_t acc = bb::ONE;
#pragma unroll
  for (int k = 0; k < RO_ROWS; ++k) {
    x[k] = bb::mul(ga, roots[(r0 + k * RO_THREADS + tid) & (ROOT_N - 1)]);
#pragma unroll
    for (int p = 0; p < RO_MAX_PTS; ++p) {
      const int i = k * RO_MAX_PTS + p;
      f[i] = 0;
      if (p < npts && k * RO_THREADS + tid < n_rows) {
        const uint4 a = pts[RO_PT_WORDS * p];
        uint32_t v = bb::add(x[k], a.w);
        v = bb::add(bb::mul(v, x[k]), a.z);
        v = bb::add(bb::mul(v, x[k]), a.y);
        f[i] = bb::add(bb::mul(v, x[k]), a.x);
        if (f[i]) acc = bb::mul(acc, f[i]);
      }
      pre[i] = acc;
    }
  }
  uint32_t inv = ext::bb_inv_chain(acc);
  ext::E res[RO_ROWS];
#pragma unroll
  for (int k = 0; k < RO_ROWS; ++k) res[k] = ext::zero();
#pragma unroll
  for (int i = RO_ROWS * RO_MAX_PTS - 1; i >= 0; --i) {
    const int k = i / RO_MAX_PTS, p = i % RO_MAX_PTS;
    if (!f[i]) continue;
    const uint32_t inv_f = i > 0 ? bb::mul(inv, pre[i - 1]) : inv;
    inv = bb::mul(inv, f[i]);
    const uint4* pt = pts + RO_PT_WORDS * p;
    ext::E q = ext::to_e(pt[3]);
    q.c[0] = bb::add(q.c[0], x[k]);
    q = ext::add(ext::scale(q, x[k]), ext::to_e(pt[2]));
    q = ext::add(ext::scale(q, x[k]), ext::to_e(pt[1]));
    const ext::E num = ext::sub(s[k][p], ext::to_e(pt[4]));
    res[k] = ext::add(res[k], ext::mul_d(num, ext::scale(q, inv_f)));
  }
#pragma unroll
  for (int k = 0; k < RO_ROWS; ++k) {
    const int rr = k * RO_THREADS + tid;
    if (rr < n_rows) out[hj[RH_OUT] + r0 + rr] = ext::to_u4(res[k]);
  }
}

__device__ __forceinline__ ext::E fold_one(const uint4& v0, const uint4& v1,
                                           const ext::E& beta, uint32_t y, uint32_t inv_neg2y) {
  const ext::E a = ext::to_e(v0);
  const ext::E slope = ext::scale(ext::sub(ext::to_e(v1), a), inv_neg2y);
  ext::E bmy = beta;
  bmy.c[0] = bb::sub(bmy.c[0], y);
  return ext::add(a, ext::mul_d(bmy, slope));
}

// Outputs j = 2u and 2u + 1 of thread u from input rows 4u .. 4u + 3.
__global__ void __launch_bounds__(FOLD_THREADS)
fri_fold_kernel(const uint4* __restrict__ evals, const uint32_t* __restrict__ beta_p,
                const uint32_t* __restrict__ roots, const uint4* __restrict__ ro,
                long long half, int log_h, uint4* __restrict__ out) {
  const long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long j = 2 * u;
  if (j >= half) return;
  const ext::E beta = ext::load(beta_p);
  const unsigned long long r = 2ull * j;  // row 2j of the height-2^log_h domain
  const uint32_t lo = (uint32_t)(r & (ROOT_N - 1));
  const uint32_t y0 = bb::mul(root_high(roots, ROOT_GEN, log_h, r >> ROOT_BITS, bb::ONE),
                              roots[lo]);
  const uint32_t n0 = bb::mul(root_high(roots, ROOT_GEN_INV, log_h, r >> ROOT_BITS, NEG_HALF),
                              roots[ROOT_N + lo]);
  const uint4 v0 = evals[2 * j], v1 = evals[2 * j + 1];
  ext::E o0 = fold_one(v0, v1, beta, y0, n0);
  const bool two = j + 1 < half;
  ext::E o1;
  if (two) {
    const uint4 v2 = evals[2 * j + 2], v3 = evals[2 * j + 3];
    o1 = fold_one(v2, v3, beta, bb::mul(y0, roots[ROOT_GEN + 2]),
                  bb::mul(n0, roots[ROOT_GEN_INV + 2]));
  }
  if (ro) {
    const ext::E beta_sq = ext::mul_d(beta, beta);
    o0 = ext::add(o0, ext::mul_d(beta_sq, ext::to_e(ro[j])));
    if (two) o1 = ext::add(o1, ext::mul_d(beta_sq, ext::to_e(ro[j + 1])));
  }
  out[j] = ext::to_u4(o0);
  if (two) out[j + 1] = ext::to_u4(o1);
}

}  // namespace

extern "C" int ovt_fri_fold(const void* evals, const void* beta, const void* roots,
                            const void* ro, long long half, int log_h, void* out,
                            void* stream) {
  if (half <= 0) return (int)cudaGetLastError();
  const long long pairs = (half + 1) / 2;
  const int threads = pairs >= FOLD_THREADS ? FOLD_THREADS : (int)((pairs + 31) / 32 * 32);
  const long long blocks = (pairs + threads - 1) / threads;
  fri_fold_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)evals, (const uint32_t*)beta, (const uint32_t*)roots, (const uint4*)ro,
      half, log_h, (uint4*)out);
  return (int)cudaGetLastError();
}

extern "C" int ovt_reduced_open(const void* heights, int n_heights, const void* mats,
                                const void* consts, int n_apow, const void* roots,
                                unsigned shift, int blocks, void* out, void* stream) {
  if (blocks <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_apow * 16 + (size_t)RO_TILE * RO_PITCH * 4;
  cudaError_t rc = cudaFuncSetAttribute(reduced_open_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  reduced_open_kernel<<<blocks, RO_THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)heights, n_heights, (const long long*)mats, (const uint4*)consts,
      n_apow, (const uint32_t*)roots, shift, (uint4*)out);
  return (int)cudaGetLastError();
}
