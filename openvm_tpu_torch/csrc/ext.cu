// K2: Fp4 elementwise operations on (n, 4) int32 Montgomery words.
//
// Replaces openvm_tpu/field/ext.py: mul (:72), inv (:106), scale (:66) and
// the ext add/sub (:54-59); on the prover's path it runs the zeta power
// series of _ext_pows_jit (openvm_tpu/stark/prover.py:220), log2 N doubling
// steps.  The arithmetic lives in ext.cuh, which the other extension-field
// kernels include.
// Bound on this card: bytes for add/sub/scale/mul (16 bytes read per operand
// element, 16 written; a product is 19 Montgomery products), operations for
// inv (about 90 Montgomery products per element).  Design: one thread per
// element in a grid-stride loop, the operation a template argument; a
// one-element operand b (the power series' multiplier) is read once per
// thread from a broadcast index instead of being materialised.
#include <cuda_runtime.h>

#include "ext.cuh"

namespace {

enum Op : int { MUL = 0, ADD = 1, SUB = 2, SCALE = 3, INV = 4 };

template <int OP>
__global__ void ext_elementwise_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       uint32_t* __restrict__ out, int64_t n,
                                       int b_bcast) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t bi = b_bcast ? 0 : i;
    const ext::E x = ext::load(a + 4 * i);
    ext::E r;
    if constexpr (OP == MUL) r = ext::mul(x, ext::load(b + 4 * bi));
    else if constexpr (OP == ADD) r = ext::add(x, ext::load(b + 4 * bi));
    else if constexpr (OP == SUB) r = ext::sub(x, ext::load(b + 4 * bi));
    else if constexpr (OP == SCALE) r = ext::scale(x, b[bi]);
    else r = ext::inv(x);
    ext::store(out + 4 * i, r);
  }
}

}  // namespace

extern "C" int ovt_ext_elementwise(int op, const void* a, const void* b,
                                   void* out, long long n, int b_bcast,
                                   void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 32 ? want : 132 * 32);
  cudaStream_t s = (cudaStream_t)stream;
  auto pa = (const uint32_t*)a;
  auto pb = (const uint32_t*)b;
  auto po = (uint32_t*)out;
  switch (op) {
    case MUL: ext_elementwise_kernel<MUL><<<blocks, threads, 0, s>>>(pa, pb, po, n, b_bcast); break;
    case ADD: ext_elementwise_kernel<ADD><<<blocks, threads, 0, s>>>(pa, pb, po, n, b_bcast); break;
    case SUB: ext_elementwise_kernel<SUB><<<blocks, threads, 0, s>>>(pa, pb, po, n, b_bcast); break;
    case SCALE: ext_elementwise_kernel<SCALE><<<blocks, threads, 0, s>>>(pa, pb, po, n, b_bcast); break;
    case INV: ext_elementwise_kernel<INV><<<blocks, threads, 0, s>>>(pa, pb, po, n, b_bcast); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
