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
// and an index past its table is dropped (mode="drop").  Counts accumulate
// with uint32 atomics into tables that the caller keeps across AIRs, so the
// three tables reach the host in one copy each (machine.py:654).
// Bound: bytes, each row reads its sends' field and count words once (the
// tables are small next to the traces; the operations are a from_monty per
// word and an atomic per live send).
// Design, first version: one thread per row walks the sends; the atomics go
// straight to device memory, so a hot bin (small values, common bytes) is
// contended across the card.  Per-block tables in shared memory for the
// range table would take most of that traffic off device memory.
#include <cuda_runtime.h>

#include "babybear.cuh"

namespace {

enum Kind : int { RANGE = 0, BITWISE = 1, TUPLE = 2 };

__global__ void lookup_hist_kernel(const uint32_t* __restrict__ cols, uint32_t n,
                                   const int* __restrict__ sends, int n_sends,
                                   uint32_t* __restrict__ range_tab, uint32_t range_h,
                                   uint32_t* __restrict__ bitwise_tab,
                                   uint32_t* __restrict__ tuple_tab,
                                   uint32_t tuple_h, uint32_t sizes1) {
  for (uint32_t j = blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += gridDim.x * blockDim.x) {
    for (int s = 0; s < n_sends; ++s) {
      const int* t = sends + 5 * s;  // kind, rows of x, y, is_xor, count
      const uint32_t count = bb::from_monty(cols[(unsigned long long)t[4] * n + j]);
      if (count == 0) continue;
      const uint32_t x = bb::from_monty(cols[(unsigned long long)t[1] * n + j]);
      const uint32_t y = bb::from_monty(cols[(unsigned long long)t[2] * n + j]);
      if (t[0] == RANGE) {
        const uint32_t idx = y == 0 ? 0u : (1u << (y < 30u ? y : 30u)) - 1u + x;
        if (idx < range_h) atomicAdd(range_tab + idx, count);
      } else if (t[0] == TUPLE) {
        const uint32_t idx = x * sizes1 + y;
        if (idx < tuple_h) atomicAdd(tuple_tab + idx, count);
      } else {
        const uint32_t is_xor = bb::from_monty(cols[(unsigned long long)t[3] * n + j]);
        const uint32_t idx = (x * 256u + y) * 2u + is_xor;
        if (idx < 2u * 65536u) atomicAdd(bitwise_tab + idx, count);
      }
    }
  }
}

}  // namespace

extern "C" int ovt_lookup_hist(const void* cols, unsigned n, const void* sends,
                               int n_sends, void* range_tab, unsigned range_h,
                               void* bitwise_tab, void* tuple_tab, unsigned tuple_h,
                               unsigned sizes1, void* stream) {
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  lookup_hist_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)cols, n, (const int*)sends, n_sends, (uint32_t*)range_tab,
      range_h, (uint32_t*)bitwise_tab, (uint32_t*)tuple_tab, tuple_h, sizes1);
  return (int)cudaGetLastError();
}
