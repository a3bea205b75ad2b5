// K8: lookup-multiplicity histograms of the range, bitwise and tuple buses.
//
// Replaces openvm_tpu/stark/evaluator.py jit_dag_lookup_hist (:253), as
// VirtualMachine._lookup_multiplicities (vm/machine.py:591) calls it for
// every AIR.  Its inputs are the quotient interpreter's columns mode output:
// each send's field and count roots over the AIR's natural trace, in
// Montgomery form.  Per row and send it follows evaluator.py:294-313
// exactly: values and counts are canonical (from_monty first), a row whose
// count is 0 adds nothing, and in wrapping uint32
//   range    index = bits == 0 ? 0 : (1 << min(bits, 30)) - 1 + value
//   tuple    index = x * sizes[1] + y
//   bitwise  index = (x * 256 + y) * 2 + is_xor
// and an index at or past its table's height is dropped (mode="drop").
// Counts accumulate in uint32 (wrapping) into tables that the caller keeps
// across AIRs, so the three tables reach the host in one copy each
// (machine.py:654).  uint32 addition is associative and commutative, so
// any order of the adds gives the same words.
// Bound: bytes.  Each row reads each distinct count word of its sends once
// (sends share counts) and each distinct field word once where a send that
// reads it is live; the tables are read and written once (small next to
// the traces; the operations are a from_monty per word read and an index
// and an add per live send).
// Design: one launch for every AIR of a prove, over a job table (stark/
// lookup.py H_*): per AIR its columns, height, first send in the send
// table and first unit; the job and send tables go up in one copy a
// prove.  Units of
// HIST_THREADS rows map to (AIR, rows), largest AIR first
// (quotient.block_plan); persistent blocks, a few per SM, walk the units.
//  * Skew.  Path 3's sends pile onto a few bins: value 0 and the small
//    values of each bit width of the range table (bits 14 value 0 alone
//    takes over a third of the live sends), and x = 0 of the bitwise table.
//    Atomics to one address serialise in L2.
//  * Warp aggregation first: lanes whose live send lands on the same
//    (table, index) find each other with __match_any_sync, and the lowest
//    of them adds the group's sum.
//  * Private bins: each block keeps in shared memory the first RANGE_SEG
//    values of every bit width of the range table (bin (1 << b) - 1 + v,
//    v < RANGE_SEG) and the first BITWISE_HEAD bins of the bitwise table;
//    adds to those use shared-memory atomics, other adds go to device
//    memory.  The drop test is made on the full uint32 index before the
//    private or the global bin is chosen.  At the block's end each nonzero
//    private bin is flushed with one global add.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

enum Kind : int { RANGE = 0, BITWISE = 1, TUPLE = 2 };

// stark/lookup.py HIST_THREADS, RANGE_SEG, BITWISE_HEAD, H_* and
// HIST_JOB_WORDS
constexpr int THREADS = 256, RANGE_SEG = 256, BITWISE_HEAD = 512;
constexpr uint32_t BITWISE_BINS = 2u * 65536u, NONE = 0xffffffffu;
enum Job : int { H_COLS, H_N, H_SEND, H_NSENDS, H_BLOCK0, JOB_WORDS = 8 };

struct Tables {
  uint32_t* range;
  uint32_t* bitwise;
  uint32_t* tuple;
  uint32_t range_h, tuple_h, sizes1;
  int range_segs;  // bit widths of the range table: range_h's bit length
};

// A live send's key: its index in the three tables laid end to end (range,
// bitwise, tuple); NONE when the count is 0 or the index is dropped.
__device__ __forceinline__ uint32_t send_key(const uint32_t* __restrict__ cols,
                                             unsigned long long n, unsigned long long j,
                                             const int* __restrict__ t, const Tables& tb,
                                             uint32_t* count) {
  *count = bb::from_monty(cols[(unsigned long long)t[4] * n + j]);
  if (*count == 0) return NONE;
  const uint32_t x = bb::from_monty(cols[(unsigned long long)t[1] * n + j]);
  const uint32_t y = bb::from_monty(cols[(unsigned long long)t[2] * n + j]);
  if (t[0] == RANGE) {
    const uint32_t idx = y == 0 ? 0u : (1u << (y < 30u ? y : 30u)) - 1u + x;
    return idx < tb.range_h ? idx : NONE;
  }
  if (t[0] == TUPLE) {
    const uint32_t idx = x * tb.sizes1 + y;
    return idx < tb.tuple_h ? tb.range_h + BITWISE_BINS + idx : NONE;
  }
  const uint32_t is_xor = bb::from_monty(cols[(unsigned long long)t[3] * n + j]);
  const uint32_t idx = (x * 256u + y) * 2u + is_xor;
  return idx < BITWISE_BINS ? tb.range_h + idx : NONE;
}

// Add v at ``key``: a private bin in shared memory or the table's word.
__device__ __forceinline__ void add_key(uint32_t* priv, const Tables& tb, uint32_t key,
                                        uint32_t v) {
  if (key < tb.range_h) {
    const int b = 31 - __clz(key + 1u);  // bit width: (1 << b) - 1 <= key
    const uint32_t off = key + 1u - (1u << b);
    if (off < (uint32_t)RANGE_SEG)
      atomicAdd(priv + b * RANGE_SEG + off, v);
    else
      atomicAdd(tb.range + key, v);
    return;
  }
  key -= tb.range_h;
  if (key < BITWISE_BINS) {
    if (key < (uint32_t)BITWISE_HEAD)
      atomicAdd(priv + tb.range_segs * RANGE_SEG + key, v);
    else
      atomicAdd(tb.bitwise + key, v);
    return;
  }
  atomicAdd(tb.tuple + (key - BITWISE_BINS), v);
}

// jobs: n_jobs rows of JOB_WORDS, largest first; units: the plan's total.
// Dynamic shared memory: range_segs * RANGE_SEG + BITWISE_HEAD private
// bins, then a word a thread for the warp sums.
__global__ void __launch_bounds__(THREADS)
lookup_hist_kernel(const long long* __restrict__ jobs, int n_jobs, int units,
                   const int* __restrict__ sends, Tables tb) {
  extern __shared__ uint32_t priv[];
  const int n_priv = tb.range_segs * RANGE_SEG + BITWISE_HEAD;
  uint32_t* lane_cnt = priv + n_priv;
  for (int k = threadIdx.x; k < n_priv; k += THREADS) priv[k] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  uint32_t* warp_cnt = lane_cnt + (threadIdx.x & ~31);
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    int jk = 0;
    while (jk + 1 < n_jobs && u >= jobs[(jk + 1) * JOB_WORDS + H_BLOCK0]) ++jk;
    const long long* job = jobs + jk * JOB_WORDS;
    const uint32_t* cols = (const uint32_t*)job[H_COLS];
    const unsigned long long n = (unsigned long long)job[H_N];
    const unsigned long long j =
        (unsigned long long)(u - job[H_BLOCK0]) * THREADS + threadIdx.x;
    const int* t = sends + 5 * job[H_SEND];
    const int n_sends = (int)job[H_NSENDS];
    for (int s = 0; s < n_sends; ++s, t += 5) {
      uint32_t count = 0;
      const uint32_t key = j < n ? send_key(cols, n, j, t, tb, &count) : NONE;
      const unsigned grp = __match_any_sync(0xffffffffu, key);
      warp_cnt[lane] = count;
      __syncwarp();
      if (key != NONE && lane == __ffs(grp) - 1) {
        uint32_t sum = 0;
        for (unsigned g = grp; g; g &= g - 1) sum += warp_cnt[__ffs(g) - 1];
        add_key(priv, tb, key, sum);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_priv; k += THREADS) {
    const uint32_t v = priv[k];
    if (v == 0) continue;
    if (k < tb.range_segs * RANGE_SEG) {
      const int b = k / RANGE_SEG;
      atomicAdd(tb.range + ((1u << b) - 1u + (uint32_t)(k - b * RANGE_SEG)), v);
    } else {
      atomicAdd(tb.bitwise + (k - tb.range_segs * RANGE_SEG), v);
    }
  }
}

}  // namespace

// jobs: device job table (n_jobs x JOB_WORDS int64); sends: (S, 5) int32
// [kind, row of x, y, is_xor, count]; blocks: the persistent grid.
extern "C" int ovt_lookup_hist(const void* jobs, int n_jobs, int units, int blocks,
                               const void* sends, void* range_tab, unsigned range_h,
                               void* bitwise_tab, void* tuple_tab, unsigned tuple_h,
                               unsigned sizes1, void* stream) {
  if (n_jobs <= 0 || units <= 0 || blocks <= 0 || range_h == 0)
    return (int)cudaErrorInvalidValue;
  Tables tb{(uint32_t*)range_tab, (uint32_t*)bitwise_tab, (uint32_t*)tuple_tab,
            range_h, tuple_h, sizes1, 32 - __builtin_clz(range_h)};
  const size_t smem = (size_t)(tb.range_segs * RANGE_SEG + BITWISE_HEAD + THREADS) * 4;
  lookup_hist_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const long long*)jobs, n_jobs, units, (const int*)sends, tb);
  return (int)cudaGetLastError();
}
