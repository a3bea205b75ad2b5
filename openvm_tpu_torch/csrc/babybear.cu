// K1: BabyBear elementwise Montgomery operations on int32 words.
//
// Replaces openvm_tpu/field/babybear.py: mul (:141) / _monty_reduce (:131),
// add (:157), sub (:163), to_monty (:174), from_monty (:180).
// Bound on this card: bytes (one 32-bit load per operand, one store; a few
// integer operations per word).  Design: one thread per word in a
// grid-stride loop, neighbouring threads on neighbouring words so every
// load and store is coalesced; the operation is a template argument so the
// loop body has no branch.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

enum Op : int { TO_MONTY = 0, FROM_MONTY = 1, MUL = 2, ADD = 3, SUB = 4 };

template <int OP>
__global__ void bb_elementwise_kernel(const uint32_t* __restrict__ a,
                                      const uint32_t* __restrict__ b,
                                      uint32_t* __restrict__ out, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t x = a[i];
    uint32_t r;
    if constexpr (OP == TO_MONTY) r = bb::to_monty(x);
    else if constexpr (OP == FROM_MONTY) r = bb::from_monty(x);
    else if constexpr (OP == MUL) r = bb::mul(x, b[i]);
    else if constexpr (OP == ADD) r = bb::add(x, b[i]);
    else r = bb::sub(x, b[i]);
    out[i] = r;
  }
}

}  // namespace

extern "C" int ovt_bb_elementwise(int op, const void* a, const void* b,
                                  void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const uint32_t*)a;
  auto pb = (const uint32_t*)b;
  auto po = (uint32_t*)out;
  switch (op) {
    case TO_MONTY: bb_elementwise_kernel<TO_MONTY><<<blocks, threads, 0, s>>>(pa, pb, po, n); break;
    case FROM_MONTY: bb_elementwise_kernel<FROM_MONTY><<<blocks, threads, 0, s>>>(pa, pb, po, n); break;
    case MUL: bb_elementwise_kernel<MUL><<<blocks, threads, 0, s>>>(pa, pb, po, n); break;
    case ADD: bb_elementwise_kernel<ADD><<<blocks, threads, 0, s>>>(pa, pb, po, n); break;
    case SUB: bb_elementwise_kernel<SUB><<<blocks, threads, 0, s>>>(pa, pb, po, n); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ovt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
