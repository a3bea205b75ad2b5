// Quartic extension Fp4 = Fp[x]/(x^4 - 11) over BabyBear: device helpers
// shared by the kernels that compute in the extension (K2, K7+K11, K9, K10,
// K12, K13, K14).
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

__device__ __forceinline__ E to_e(const uint4& v) { return E{{v.x, v.y, v.z, v.w}}; }

__device__ __forceinline__ uint4 to_u4(const E& e) {
  return make_uint4(e.c[0], e.c[1], e.c[2], e.c[3]);
}

__device__ __forceinline__ bool is_zero(const E& a) {
  return (a.c[0] | a.c[1] | a.c[2] | a.c[3]) == 0u;
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

// a * b with delayed reduction: each coefficient's products summed in 64
// bits (at most 4 terms, each below p^2 < 2^62) and reduced once
// (bb::reduce_wide); c4..c6 reduced before their fold by W.
__device__ __forceinline__ E mul_d(const E& a, const E& b) {
  const uint64_t a0 = a.c[0], a1 = a.c[1], a2 = a.c[2], a3 = a.c[3];
  const uint64_t b0 = b.c[0], b1 = b.c[1], b2 = b.c[2], b3 = b.c[3];
  const uint64_t c4 = a1 * b3 + a2 * b2 + a3 * b1;
  const uint64_t c5 = a2 * b3 + a3 * b2;
  const uint64_t c6 = a3 * b3;
  const uint64_t w = W_MONTY;
  const uint64_t c0 = a0 * b0 + bb::reduce_wide(c4) * w;
  const uint64_t c1 = a0 * b1 + a1 * b0 + bb::reduce_wide(c5) * w;
  const uint64_t c2 = a0 * b2 + a1 * b1 + a2 * b0 + bb::reduce_wide(c6) * w;
  const uint64_t c3 = a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0;
  return E{{bb::reduce_wide(c0), bb::reduce_wide(c1), bb::reduce_wide(c2),
            bb::reduce_wide(c3)}};
}

// A fixed multiplier b with W b1, W b2, W b3 beside it (mul_pre).
struct Pre {
  E b;
  uint32_t bw1, bw2, bw3;
};

__device__ __forceinline__ Pre pre(const E& b) {
  return Pre{b, bb::mul(b.c[1], W_MONTY), bb::mul(b.c[2], W_MONTY),
             bb::mul(b.c[3], W_MONTY)};
}

// a * b for a fixed b (K2's power series): with b's W-multiples made once,
// every coefficient is four products summed in 64 bits (each below p^2,
// the sum below 2^64) and reduced once, 4 reductions where mul_d takes 7.
__device__ __forceinline__ E mul_pre(const E& a, const Pre& p) {
  const uint64_t a0 = a.c[0], a1 = a.c[1], a2 = a.c[2], a3 = a.c[3];
  const uint64_t b0 = p.b.c[0], b1 = p.b.c[1], b2 = p.b.c[2], b3 = p.b.c[3];
  const uint64_t w1 = p.bw1, w2 = p.bw2, w3 = p.bw3;
  return E{{bb::reduce_wide(a0 * b0 + a1 * w3 + a2 * w2 + a3 * w1),
            bb::reduce_wide(a0 * b1 + a1 * b0 + a2 * w3 + a3 * w2),
            bb::reduce_wide(a0 * b2 + a1 * b1 + a2 * b0 + a3 * w3),
            bb::reduce_wide(a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0)}};
}

__device__ __forceinline__ uint32_t sqr_n(uint32_t x, int n) {
  for (int k = 0; k < n; ++k) x = bb::mul(x, x);
  return x;
}

// x^(p-2) by an addition chain, 29 squarings and 10 products (square and
// multiply takes 61): p - 2 = 7 * 2^28 + 2^27 - 1.  0 maps to 0.
__device__ __forceinline__ uint32_t bb_inv_chain(uint32_t x) {
  const uint32_t t3 = bb::mul(sqr_n(bb::mul(sqr_n(x, 1), x), 1), x);  // x^(2^3 - 1)
  const uint32_t t6 = bb::mul(sqr_n(t3, 3), t3);
  const uint32_t t12 = bb::mul(sqr_n(t6, 6), t6);
  const uint32_t t24 = bb::mul(sqr_n(t12, 12), t12);
  const uint32_t t27 = bb::mul(sqr_n(t24, 3), t3);  // x^(2^27 - 1)
  const uint32_t v = sqr_n(bb::mul(t27, x), 1);     // x^(2^28)
  const uint32_t v2 = sqr_n(v, 1);
  return bb::mul(bb::mul(bb::mul(sqr_n(v2, 1), v2), v), t27);
}

// a^-1 through the quadratic subfield F_p[y], y = x^2, y^2 = W: with
// a = A + x B (A = a0 + a2 y, B = a1 + a3 y), a (A - x B) = A^2 - y B^2 =
// c0 + c1 y, whose inverse is (c0 - c1 y) / (c0^2 - W c1^2); then
// a^-1 = (A - x B) (c0 - c1 y) / N.  21 products and the chain (the norm
// through three Frobenius maps takes 33).  0 maps to 0.
__device__ __forceinline__ E inv_d(const E& a) {
  using bb::add;
  using bb::mul;
  using bb::sub;
  const uint32_t w = W_MONTY;
  const uint32_t p13 = mul(a.c[1], a.c[3]);
  const uint32_t c0 = add(mul(a.c[0], a.c[0]), mul(w, sub(mul(a.c[2], a.c[2]), add(p13, p13))));
  const uint32_t p02 = mul(a.c[0], a.c[2]);
  const uint32_t c1 = sub(add(p02, p02), add(mul(a.c[1], a.c[1]), mul(w, mul(a.c[3], a.c[3]))));
  const uint32_t inv_n = bb_inv_chain(sub(mul(c0, c0), mul(w, mul(c1, c1))));
  const uint64_t e0 = mul(c0, inv_n), e1 = mul(sub(0u, c1), inv_n);
  const uint64_t a0 = a.c[0], a1 = a.c[1], a2 = a.c[2], a3 = a.c[3];
  return E{{bb::reduce_wide(a0 * e0 + (uint64_t)bb::reduce_wide(a2 * e1) * w),
            sub(0u, bb::reduce_wide(a1 * e0 + (uint64_t)bb::reduce_wide(a3 * e1) * w)),
            bb::reduce_wide(a0 * e1 + a2 * e0),
            sub(0u, bb::reduce_wide(a1 * e1 + a3 * e0))}};
}

}  // namespace ext
