// K2: Fp4 elementwise operations on (n, 4) int32 Montgomery words, and the
// power series u^0 .. u^(n-1) of one element.
//
// Replaces openvm_tpu/field/ext.py: mul (:72), inv (:106), scale (:66) and
// the ext add/sub (:54-59) (ovt_ext_elementwise), and the zeta power series
// of _ext_pows_jit (openvm_tpu/stark/prover.py:220) (ovt_ext_powers), the
// one K2 launch of a prove.  The arithmetic lives in ext.cuh, which the
// other extension-field kernels include.
// Elementwise: bound by bytes for add/sub/scale/mul (16 bytes read per
// operand element, 16 written; a product is 19 Montgomery products), by
// operations for inv (about 90 Montgomery products per element).  Design:
// one thread per element in a grid-stride loop, the operation a template
// argument; a one-element operand b is read once per thread from a
// broadcast index instead of being materialised.
// Power series: bound by bytes (16 written an output; one extension product
// an output, below the bytes).  The reference doubles the series in log2 n
// steps of two launches each, every step re-reading what it wrote; here one
// launch takes u's words by value (nothing is uploaded) and writes each
// output once.  Design: a block of POW_T threads covers POW_T * POW_E
// consecutive powers.  Warp 0 makes u^(2^j) by j squarings in lane j and
// the block's first power u^(b POW_T POW_E) as the product of the u^(2^j)
// of its exponent's bits (a butterfly over the warp); the block builds
// u^0 .. u^(POW_T-1) in shared memory in log2 POW_T rounds; thread t then
// walks its column t, t + POW_T, ... from u^(first + t), one extension
// product an output by the fixed step u^POW_T with its W-multiples made
// once (ext::mul_pre: 16 products into 64-bit sums and 4 reductions), with
// coalesced 16-byte stores.  Every product returns fully reduced words, so
// the words equal the doubling's.
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

constexpr int POW_T = 256;   // threads a block, the table's length
constexpr int POW_LOG_T = 8;
constexpr int POW_E = 16;    // powers a thread (field/ext.py POW_E)
static_assert(POW_T == 1 << POW_LOG_T, "POW_T is 2^POW_LOG_T");

__global__ void __launch_bounds__(POW_T)
    ext_powers_kernel(ext::E u, uint4* __restrict__ out, long long n) {
  __shared__ uint4 tab[POW_T];            // u^t
  __shared__ uint4 sq[POW_LOG_T + 1];     // u^(2^j)
  __shared__ uint4 first_pow;             // u^first
  const int t = threadIdx.x;
  const unsigned long long first = (unsigned long long)blockIdx.x * (POW_T * POW_E);
  const ext::E one = ext::from_base(bb::ONE);
  if (t < 32) {
    // lane j: u^(2^j), for j up to the table's step and the exponent's bits
    const int bits = 64 - __clzll((long long)first);
    ext::E p = u;
    const int k_max = t <= POW_LOG_T || t < bits ? t : 0;
    for (int k = 0; k < k_max; ++k) p = ext::mul_d(p, p);
    if (t <= POW_LOG_T) sq[t] = ext::to_u4(p);
    ext::E f = (first >> t) & 1ull ? p : one;
    for (int m = 16; m; m >>= 1) {
      ext::E o;
      for (int c = 0; c < 4; ++c) o.c[c] = __shfl_xor_sync(0xffffffffu, f.c[c], m);
      f = ext::mul_d(f, o);
    }
    if (t == 0) {
      first_pow = ext::to_u4(f);
      tab[0] = ext::to_u4(one);
    }
  }
  __syncthreads();
  for (int j = 0; j < POW_LOG_T; ++j) {  // tab[k, 2k) = tab[0, k) u^k
    const int k = 1 << j;
    if (t >= k && t < 2 * k) tab[t] = ext::to_u4(ext::mul_d(ext::to_e(tab[t - k]), ext::to_e(sq[j])));
    __syncthreads();
  }
  const ext::Pre step = ext::pre(ext::to_e(sq[POW_LOG_T]));
  ext::E x = ext::mul_d(ext::to_e(first_pow), ext::to_e(tab[t]));
  long long i = (long long)first + t;
  for (int e = 0; e < POW_E; ++e, i += POW_T) {
    if (i < n) out[i] = ext::to_u4(x);
    if (e + 1 < POW_E) x = ext::mul_pre(x, step);
  }
}

}  // namespace

extern "C" int ovt_ext_powers(unsigned u0, unsigned u1, unsigned u2, unsigned u3,
                              void* out, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (n > (1ll << 31)) return (int)cudaErrorInvalidValue;  // warp 0 covers 31 bits
  const long long blocks = (n + POW_T * POW_E - 1) / (POW_T * POW_E);
  ext_powers_kernel<<<(unsigned)blocks, POW_T, 0, (cudaStream_t)stream>>>(
      ext::E{{u0, u1, u2, u3}}, (uint4*)out, n);
  return (int)cudaGetLastError();
}

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
