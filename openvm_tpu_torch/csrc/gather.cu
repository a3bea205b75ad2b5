// K6: the query-phase gather: rows of committed matrices, Merkle path
// siblings and FRI fold siblings at the query indices, in canonical form.
//
// Replaces openvm_tpu/merkle.py gather_rows_device (:118) and
// openvm_tpu/fri.py gather_queries_device (:155), which XLA runs as one
// jitted gather per tree and fold level.  Here one launch serves a whole
// list of jobs; a job reads row ((idx[q] >> shift) ^ flip) of one matrix
// (any row stride) for every query q and writes its q x width canonical
// words at its offset of one output buffer, so the prover's whole query
// phase is one launch and one copy to the host.
// Bound: bytes, and tiny (84 queries x a few hundred jobs x at most a few
// hundred words, the job table and the indices); what the design saves is
// host round trips: the table and the indices go up in one non-blocking
// copy (merkle.GatherPlan.run_device) and the output comes back in one.
// Design: the launch covers the total output, not jobs x the widest job.
// The output is cut into units, 4 words (16-byte loads and stores) for a
// job whose width, row stride, source address and output offset allow it
// and 1 word otherwise; a job's units are its rows' units, row by row, so
// the consecutive threads of one group serve one (job, query) row.  One
// thread a unit: the host finds each block's first job by a search over
// the jobs' first units (merkle.GatherPlan.table, sent with the table), and
// each thread its own by a binary search between its block's first job and
// the next block's, a few jobs where rows are wide, so no thread walks a
// search over the whole table.  The conversion from Montgomery form is
// fused into the store.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

constexpr int GATHER_THREADS = 256;

// A job's int64 words (merkle.py GJ_*): source pointer, row stride (words),
// width (words), index shift, index xor, output offset (words), 4 if its
// units are 16 bytes else 1, units a row.
enum : int { GJ_PTR, GJ_STRIDE, GJ_WIDTH, GJ_SHIFT, GJ_FLIP, GJ_OUT, GJ_VEC,
             GJ_ROW_UNITS, GJ_WORDS };

// The last j in [lo, hi) with first[j] <= g, given first[lo] <= g.
__device__ __forceinline__ int find_job(const long long* __restrict__ first,
                                        int lo, int hi, long long g) {
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(first + mid) <= g) lo = mid;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(GATHER_THREADS)
    gather_kernel(const long long* __restrict__ jobs,
                  const long long* __restrict__ first,
                  const long long* __restrict__ block_job, int n_jobs,
                  const long long* __restrict__ idx, long long units,
                  uint32_t* __restrict__ out) {
  const long long g = (long long)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (g >= units) return;
  // the block's last unit lies in the next block's first job or before it
  const int j0 = (int)__ldg(block_job + blockIdx.x);
  const int j1 = blockIdx.x + 1 < gridDim.x ? (int)__ldg(block_job + blockIdx.x + 1) + 1
                                            : n_jobs;
  const int j = find_job(first, j0, j1, g);
  const long long* job = jobs + GJ_WORDS * j;
  const unsigned row_units = (unsigned)__ldg(job + GJ_ROW_UNITS);
  const unsigned u = (unsigned)(g - __ldg(first + j));  // < q x row units
  const unsigned qi = u / row_units, c = u - qi * row_units;
  const long long row = (__ldg(idx + qi) >> __ldg(job + GJ_SHIFT)) ^ __ldg(job + GJ_FLIP);
  const uint32_t* src = (const uint32_t*)__ldg(job + GJ_PTR) + row * __ldg(job + GJ_STRIDE);
  uint32_t* dst = out + __ldg(job + GJ_OUT) + (long long)qi * __ldg(job + GJ_WIDTH);
  if (__ldg(job + GJ_VEC) == 4) {
    uint4 v = __ldg((const uint4*)src + c);
    v.x = bb::from_monty(v.x);
    v.y = bb::from_monty(v.y);
    v.z = bb::from_monty(v.z);
    v.w = bb::from_monty(v.w);
    ((uint4*)dst)[c] = v;
  } else {
    dst[c] = bb::from_monty(__ldg(src + c));
  }
}

}  // namespace

extern "C" int ovt_gather(const void* jobs, const void* first,
                          const void* block_job, int n_jobs, const void* idx,
                          long long units, void* out, void* stream) {
  if (n_jobs <= 0 || units <= 0) return (int)cudaGetLastError();
  const long long blocks = (units + GATHER_THREADS - 1) / GATHER_THREADS;
  gather_kernel<<<(unsigned)blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)jobs, (const long long*)first,
      (const long long*)block_job, n_jobs, (const long long*)idx, units,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
