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
// hundred words); what it saves is launches and host round trips (the
// PR 1 path made 2,352 launches and copies for 84 queries).  Design: one
// block row (blockIdx.y) per job, threads over q x width; the conversion
// from Montgomery form is fused into the store.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

// A job as six int64 words: source pointer, row stride (words), width,
// index shift, index xor, output offset (words).
__global__ void gather_kernel(const long long* __restrict__ jobs,
                              const long long* __restrict__ idx, int q,
                              uint32_t* __restrict__ out) {
  const long long* job = jobs + 6 * blockIdx.y;
  const uint32_t* src = (const uint32_t*)job[0];
  const long long stride = job[1];
  const int width = (int)job[2];
  const int shift = (int)job[3];
  const long long flip = job[4];
  uint32_t* dst = out + job[5];
  const int total = q * width;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int qi = e / width, col = e - qi * width;
    const long long row = (idx[qi] >> shift) ^ flip;
    dst[e] = bb::from_monty(src[row * stride + col]);
  }
}

}  // namespace

extern "C" int ovt_gather(const void* jobs, int n_jobs, const void* idx, int q,
                          int max_total, void* out, void* stream) {
  if (n_jobs <= 0 || q <= 0 || max_total <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const int want = (max_total + threads - 1) / threads;
  dim3 grid(want < 64 ? want : 64, n_jobs);
  gather_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)jobs, (const long long*)idx, q, (uint32_t*)out);
  return (int)cudaGetLastError();
}
