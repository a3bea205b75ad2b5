// Quartic extension Fp4 = Fp[x]/(x^4 - 11) over BabyBear: device helpers
// shared by the kernels that compute in the extension (K2, K7+K11, K12, K13,
// K14).
//
// Replaces openvm_tpu/field/ext.py: mul (:72), frobenius (:99), inv (:106),
// scale (:66), from_base (:35).  An element is four Montgomery words
// c0 + c1 x + c2 x^2 + c3 x^3 (the JAX package's trailing axis of 4).
#pragma once

#include <cstdint>

#include "babybear.cuh"

namespace ext {

struct E {
  uint32_t c[4];
};

// Montgomery form of x (canonical x < p).
constexpr uint32_t monty_of(uint64_t x) {
  return (uint32_t)((x << 32) % bb::P);
}

constexpr uint64_t pow_mod(uint64_t b, uint64_t e) {
  uint64_t r = 1;
  b %= bb::P;
  while (e) {
    if (e & 1) r = r * b % bb::P;
    b = b * b % bb::P;
    e >>= 1;
  }
  return r;
}

constexpr uint32_t W = 11;
constexpr uint32_t W_MONTY = monty_of(W);
// x^(p^k) = W^(k(p-1)/4) x: coefficient i of a^(p^k) is scaled by
// FROB_S^(k*i), FROB_S = W^((p-1)/4).
constexpr uint64_t FROB_S = pow_mod(W, (bb::P - 1) / 4);

__device__ __forceinline__ E zero() { return E{{0u, 0u, 0u, 0u}}; }

__device__ __forceinline__ E from_base(uint32_t a) { return E{{a, 0u, 0u, 0u}}; }

__device__ __forceinline__ E load(const uint32_t* p) {
  return E{{p[0], p[1], p[2], p[3]}};
}

__device__ __forceinline__ void store(uint32_t* p, const E& a) {
  p[0] = a.c[0];
  p[1] = a.c[1];
  p[2] = a.c[2];
  p[3] = a.c[3];
}

__device__ __forceinline__ E add(const E& a, const E& b) {
  return E{{bb::add(a.c[0], b.c[0]), bb::add(a.c[1], b.c[1]),
            bb::add(a.c[2], b.c[2]), bb::add(a.c[3], b.c[3])}};
}

__device__ __forceinline__ E sub(const E& a, const E& b) {
  return E{{bb::sub(a.c[0], b.c[0]), bb::sub(a.c[1], b.c[1]),
            bb::sub(a.c[2], b.c[2]), bb::sub(a.c[3], b.c[3])}};
}

__device__ __forceinline__ E neg(const E& a) { return sub(zero(), a); }

__device__ __forceinline__ E scale(const E& a, uint32_t s) {
  return E{{bb::mul(a.c[0], s), bb::mul(a.c[1], s), bb::mul(a.c[2], s),
            bb::mul(a.c[3], s)}};
}

// Schoolbook product; c4..c6 fold into c0..c2 times W (ext.py:72-92).
__device__ __forceinline__ E mul(const E& a, const E& b) {
  using bb::add;
  using bb::mul;
  const uint32_t c0 = mul(a.c[0], b.c[0]);
  const uint32_t c1 = add(mul(a.c[0], b.c[1]), mul(a.c[1], b.c[0]));
  const uint32_t c2 =
      add(add(mul(a.c[0], b.c[2]), mul(a.c[1], b.c[1])), mul(a.c[2], b.c[0]));
  const uint32_t c3 = add(add(mul(a.c[0], b.c[3]), mul(a.c[1], b.c[2])),
                          add(mul(a.c[2], b.c[1]), mul(a.c[3], b.c[0])));
  const uint32_t c4 =
      add(add(mul(a.c[1], b.c[3]), mul(a.c[2], b.c[2])), mul(a.c[3], b.c[1]));
  const uint32_t c5 = add(mul(a.c[2], b.c[3]), mul(a.c[3], b.c[2]));
  const uint32_t c6 = mul(a.c[3], b.c[3]);
  return E{{add(c0, mul(c4, W_MONTY)), add(c1, mul(c5, W_MONTY)),
            add(c2, mul(c6, W_MONTY)), c3}};
}

// FROB_S^j in Montgomery form, for the exponents k*i that k, i in 1..3 give.
constexpr uint32_t FS1 = monty_of(pow_mod(FROB_S, 1));
constexpr uint32_t FS2 = monty_of(pow_mod(FROB_S, 2));
constexpr uint32_t FS3 = monty_of(pow_mod(FROB_S, 3));
constexpr uint32_t FS4 = monty_of(pow_mod(FROB_S, 4));
constexpr uint32_t FS6 = monty_of(pow_mod(FROB_S, 6));
constexpr uint32_t FS9 = monty_of(pow_mod(FROB_S, 9));

// a^(p^k) for k in 1..3.
__device__ __forceinline__ E frobenius(const E& a, int k) {
  if (k == 1)
    return E{{a.c[0], bb::mul(a.c[1], FS1), bb::mul(a.c[2], FS2), bb::mul(a.c[3], FS3)}};
  if (k == 2)
    return E{{a.c[0], bb::mul(a.c[1], FS2), bb::mul(a.c[2], FS4), bb::mul(a.c[3], FS6)}};
  return E{{a.c[0], bb::mul(a.c[1], FS3), bb::mul(a.c[2], FS6), bb::mul(a.c[3], FS9)}};
}

// Base-field a^e by square and multiply.
__device__ __forceinline__ uint32_t bb_pow(uint32_t a, uint32_t e) {
  uint32_t r = bb::ONE;
  while (e) {
    if (e & 1u) r = bb::mul(r, a);
    a = bb::mul(a, a);
    e >>= 1;
  }
  return r;
}

// Fermat inverse a^(p-2); 0 maps to 0, as bb.inv (babybear.py:233).
__device__ __forceinline__ uint32_t bb_inv(uint32_t a) { return bb_pow(a, bb::P - 2); }

// a^-1 = (a^p a^p^2 a^p^3) / N(a), N(a) = a * a^p a^p^2 a^p^3 in Fp
// (ext.py:106-116); 0 maps to 0.
__device__ __forceinline__ E inv(const E& a) {
  const E g = mul(frobenius(a, 1), mul(frobenius(a, 2), frobenius(a, 3)));
  // Only coefficient 0 of a*g is needed: the norm lies in the base field.
  const uint32_t norm = bb::add(
      bb::mul(a.c[0], g.c[0]),
      bb::mul(W_MONTY, bb::add(bb::add(bb::mul(a.c[1], g.c[3]), bb::mul(a.c[2], g.c[2])),
                               bb::mul(a.c[3], g.c[1]))));
  return scale(g, bb_inv(norm));
}

}  // namespace ext
