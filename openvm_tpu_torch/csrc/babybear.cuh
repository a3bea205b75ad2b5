// BabyBear Montgomery arithmetic shared by every kernel of openvm_tpu_torch.
//
// Field elements are 32-bit Montgomery words x*R mod p with R = 2^32 and
// values in [0, p), p = 2^31 - 2^27 + 1: the layout of
// openvm_tpu/field/babybear.py, so raw words compare equal with the JAX
// package's uint32 output.  Hopper has a native 32x32->64 product, so the
// reduction works on one 64-bit value instead of the JAX package's 16-bit
// limbs (babybear.py:112-128, there only because the TPU lacks u64).
#pragma once

#include <cstdint>

namespace bb {

constexpr uint32_t P = 2013265921u;

// p^-1 mod 2^32 by Newton iteration (each step doubles the correct bits).
constexpr uint32_t inv_mod_2_32(uint32_t a) {
  uint32_t x = a;  // correct to 3 bits for odd a
  for (int i = 0; i < 5; ++i) x *= 2u - a * x;
  return x;
}

constexpr uint32_t NPRIME = 0u - inv_mod_2_32(P);  // -p^-1 mod 2^32
constexpr uint32_t ONE = (uint32_t)((1ull << 32) % P);  // R mod p
constexpr uint32_t R2 = (uint32_t)((uint64_t)ONE * ONE % P);  // R^2 mod p

static_assert(P * inv_mod_2_32(P) == 1u, "Newton inverse of p");
static_assert(NPRIME == 2013265919u, "-p^-1 mod 2^32");

// The conditional subtractions are written as unsigned minima: for s < 2p,
// s - p wraps above s exactly when s < p, so min(s, s - p) is s mod p (and
// min(d, d + p) for a wrapped difference), three instructions with no
// predicate.

// x * R^-1 mod p, canonical, for any x < p * 2^32.
__device__ __forceinline__ uint32_t monty_reduce(uint64_t x) {
  const uint32_t m = (uint32_t)x * NPRIME;
  // x + m*p < 2^64 and is divisible by 2^32; the quotient is below 2p.
  const uint32_t t = (uint32_t)((x + (uint64_t)m * P) >> 32);
  return min(t, t - P);
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return monty_reduce((uint64_t)a * b);
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2p < 2^32
  return min(s, s - P);
}

__device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return min(d, d + P);
}

__device__ __forceinline__ uint32_t to_monty(uint32_t x) { return mul(x, R2); }

__device__ __forceinline__ uint32_t from_monty(uint32_t x) {
  return monty_reduce((uint64_t)x);
}

}  // namespace bb
