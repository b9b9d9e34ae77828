// 384-bit arithmetic over the BLS12-381 base field, one element per
// thread, shared by the CUDA kernels (mont_mul.cu, fp_addsub.cu,
// fp_inv.cu, g1_masked_sum.cu, and the tower kernels through fp12.cuh)
// and, as plain C++, by the host tests of their arithmetic
// (tests/test_torch_fp384_host.py, tests/test_torch_miller_host.py,
// tests/test_torch_g1_host.py).
//
// The boundary format is the port's: 32 little-endian limbs of 12 bits,
// canonical (< p).  Inside, an element is 12 little-endian words of 32 bits
// (8 limbs fill 3 words exactly), so a product is 12 x 12 word products
// instead of 32 x 32 limb products, and a carry ripples over 12 words.
// Products are written with uint64_t and not with inline PTX, so that g++
// compiles the same source.
//
// The modulus comes in as macros from a header that the build generates
// from ops/_constants.py and pre-includes (kernels/_build.py):
//   HARMONY_P_WORDS   p as 12 little-endian 32-bit words
//   HARMONY_P_INV32   -p^-1 mod 2^32
//   HARMONY_R3_WORDS  R^3 mod p (R = 2^384) as 12 words: the Montgomery
//                     product by it takes inv's plain inverse back into
//                     the Montgomery domain

#pragma once

#include <cstdint>

#if !defined(HARMONY_P_WORDS) || !defined(HARMONY_P_INV32) || \
    !defined(HARMONY_R3_WORDS)
#error "build through harmony_tpu_torch/kernels/_build.py, which defines the modulus"
#endif

#if defined(__CUDACC__)
#define FP384_FN __host__ __device__ __forceinline__
#define FP384_UNROLL _Pragma("unroll")
#define FP384_ROLLED _Pragma("unroll 1")
#else
#define FP384_FN inline
#define FP384_UNROLL
#define FP384_ROLLED
#endif

#if defined(__CUDA_ARCH__)
// One instruction of a PTX carry or borrow chain, d = a op b, the carry
// kept in the condition code (add.cc/addc.cc, sub.cc/subc.cc).
#define FP384_CHAIN(op, d, a, b) \
  asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b))
#endif

namespace fp384 {

constexpr int kLimbs = 32;
constexpr int kWords = 12;
constexpr uint32_t kLimbMask = 0xfffu;
constexpr uint32_t kPInv = HARMONY_P_INV32;

// 32 limbs of 12 bits -> 12 words of 32 bits; each group of 8 limbs is 96
// bits, 3 words.  Limbs must be < 2^12.
FP384_FN void pack(const uint32_t l[kLimbs], uint32_t w[kWords]) {
  FP384_UNROLL
  for (int k = 0; k < 4; ++k) {
    const uint32_t* s = l + 8 * k;
    uint32_t* d = w + 3 * k;
    d[0] = s[0] | s[1] << 12 | s[2] << 24;
    d[1] = s[2] >> 8 | s[3] << 4 | s[4] << 16 | s[5] << 28;
    d[2] = s[5] >> 4 | s[6] << 8 | s[7] << 20;
  }
}

// The inverse of pack.
FP384_FN void unpack(const uint32_t w[kWords], uint32_t l[kLimbs]) {
  FP384_UNROLL
  for (int k = 0; k < 4; ++k) {
    const uint32_t* s = w + 3 * k;
    uint32_t* d = l + 8 * k;
    d[0] = s[0] & kLimbMask;
    d[1] = s[0] >> 12 & kLimbMask;
    d[2] = (s[0] >> 24 | s[1] << 8) & kLimbMask;
    d[3] = s[1] >> 4 & kLimbMask;
    d[4] = s[1] >> 16 & kLimbMask;
    d[5] = (s[1] >> 28 | s[2] << 4) & kLimbMask;
    d[6] = s[2] >> 8 & kLimbMask;
    d[7] = s[2] >> 20;
  }
}

// out = a + b mod 2^384; returns the carry out of the top word.
FP384_FN uint32_t add_words(const uint32_t a[kWords], const uint32_t b[kWords],
                            uint32_t out[kWords]) {
  uint64_t c = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += static_cast<uint64_t>(a[j]) + b[j];
    out[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  return static_cast<uint32_t>(c);
}

// out = a - b mod 2^384; returns the borrow out of the top word (1 iff a < b).
FP384_FN uint32_t sub_words(const uint32_t a[kWords], const uint32_t b[kWords],
                            uint32_t out[kWords]) {
  uint64_t borrow = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    const uint64_t d = static_cast<uint64_t>(a[j]) - b[j] - borrow;
    out[j] = static_cast<uint32_t>(d);
    borrow = d >> 63;  // |a_j - b_j - borrow| < 2^33: bit 63 is the sign
  }
  return static_cast<uint32_t>(borrow);
}

// out = x < p ? x : x - p, for x < 2p.
FP384_FN void cond_sub_p(const uint32_t x[kWords], uint32_t out[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  uint32_t d[kWords];
  const uint32_t borrow = sub_words(x, p, d);
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) out[j] = borrow ? x[j] : d[j];
}

// (a + b) mod p for canonical a, b: a + b < 2p < 2^382, so no carry leaves
// the top word, and one conditional subtraction lands in [0, p).
FP384_FN void add(const uint32_t a[kWords], const uint32_t b[kWords],
                  uint32_t out[kWords]) {
  uint32_t s[kWords];
  add_words(a, b, s);
  cond_sub_p(s, out);
}

// (a - b) mod p for canonical a, b: where a - b borrowed, adding p (the
// carry out of the top word falls away) lands in [0, p).
FP384_FN void sub(const uint32_t a[kWords], const uint32_t b[kWords],
                  uint32_t out[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  uint32_t d[kWords], w[kWords];
  const uint32_t borrow = sub_words(a, b, d);
  add_words(d, p, w);
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) out[j] = borrow ? w[j] : d[j];
}

// (-a) mod p for canonical a, with -0 = 0.
FP384_FN void neg(const uint32_t a[kWords], uint32_t out[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  uint32_t d[kWords];
  sub_words(p, a, d);
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) any |= a[j];
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) out[j] = any ? d[j] : 0u;
}

// Montgomery product a b 2^-384 mod p of canonical a, b: CIOS over 12
// words.  Step i adds a_i b to the accumulator t; then
// m = t_0 (-p^-1) mod 2^32 makes t + m p divisible by 2^32, and the
// division is a one-word shift.  Every 64-bit sum is at most
// (2^32 - 1) + (2^32 - 1)^2 + (2^32 - 1) = 2^64 - 1, so none overflows.
// p < 2^381 keeps t short: if t < 2p, then t + a_i b + m p < 2^33 p <
// 2^414 fits in 13 words, and the shifted t is again < 2p < 2^382, so t
// needs no 13th word between steps (the "no-carry" CIOS).  After 12 steps
// t < 2p, and one conditional subtraction gives the canonical result, the
// same digits as the 12-bit schedule of the JAX package.
FP384_FN void mont_mul(const uint32_t a[kWords], const uint32_t b[kWords],
                       uint32_t out[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  uint32_t t[kWords];
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) t[j] = 0;
  FP384_UNROLL
  for (int i = 0; i < kWords; ++i) {
    uint64_t c = 0;
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) {
      c += static_cast<uint64_t>(t[j]) + static_cast<uint64_t>(a[i]) * b[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    const uint32_t top = static_cast<uint32_t>(c);  // word 12 of t + a_i b

    const uint32_t m = t[0] * kPInv;
    c = (static_cast<uint64_t>(m) * p[0] + t[0]) >> 32;  // low word is 0
    FP384_UNROLL
    for (int j = 1; j < kWords; ++j) {
      c += static_cast<uint64_t>(t[j]) + static_cast<uint64_t>(m) * p[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    t[kWords - 1] = top + static_cast<uint32_t>(c);  // < 2^30: t < 2^382
  }
  cond_sub_p(t, out);
}

// --- Inversion by a binary extended GCD --------------------------------
//
// Variable-time: its loop and branches follow the value.  Both inversions
// on the verify path invert public values (an aggregate key's Z and a
// pairing value); a secret-derived value must not be inverted with it.

// out = a - b mod 2^384, and the borrow (1 iff a < b): one PTX
// sub.cc/subc.cc chain on the card, sub_words under g++.  out may be a or
// b.
FP384_FN uint32_t sub_chain(const uint32_t a[kWords], const uint32_t b[kWords],
                            uint32_t out[kWords]) {
#if defined(__CUDA_ARCH__)
  uint32_t borrow;
  FP384_CHAIN("sub.cc.u32", out[0], a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("subc.cc.u32", out[j], a[j], b[j]);
  }
  FP384_CHAIN("subc.u32", borrow, 0u, 0u);  // all ones iff a < b
  return borrow & 1u;
#else
  return sub_words(a, b, out);
#endif
}

// out = a + b mod 2^384 (the carry out falls away), as sub_chain.
FP384_FN void add_chain(const uint32_t a[kWords], const uint32_t b[kWords],
                        uint32_t out[kWords]) {
#if defined(__CUDA_ARCH__)
  FP384_CHAIN("add.cc.u32", out[0], a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("addc.cc.u32", out[j], a[j], b[j]);
  }
#else
  add_words(a, b, out);
#endif
}

// x = (x - y) mod p for canonical x, y: where x - y borrowed, adding p
// lands in [0, p).
FP384_FN void sub_mod(uint32_t x[kWords], const uint32_t y[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  const uint32_t mask = 0u - sub_chain(x, y, x);
  uint32_t q[kWords];
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) q[j] = p[j] & mask;
  add_chain(x, q, x);
}

FP384_FN int ctz(uint32_t w) {  // w != 0
#if defined(__CUDA_ARCH__)
  return __ffs(w) - 1;
#else
  return __builtin_ctz(w);
#endif
}

// v = v / 2^k for 1 <= k <= 32, the words above v's top being 0.
FP384_FN void shift_down(uint32_t v[kWords], int k) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    const uint64_t hi = j + 1 < kWords ? v[j + 1] : 0u;
    v[j] = static_cast<uint32_t>((hi << 32 | v[j]) >> k);
  }
}

// x = x 2^-k mod p for canonical x and 1 <= k <= 32: m = x (-p^-1) mod
// 2^k makes x + m p divisible by 2^k (a k-bit step of Montgomery's
// reduction), and (x + m p) / 2^k < p (1 + 2^k) / 2^k < 2p, so one
// conditional subtraction makes it canonical.
FP384_FN void div_pow2(uint32_t x[kWords], int k) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  const uint32_t m = x[0] * kPInv & (k == 32 ? ~0u : (1u << k) - 1u);
  uint32_t t[kWords];
  uint64_t c = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += static_cast<uint64_t>(x[j]) + static_cast<uint64_t>(m) * p[j];
    t[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    const uint64_t hi = j + 1 < kWords ? t[j + 1] : c;
    t[j] = static_cast<uint32_t>((hi << 32 | t[j]) >> k);
  }
  uint32_t d[kWords];
  const uint32_t borrow = sub_chain(t, p, d);
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) x[j] = borrow ? t[j] : d[j];
}

// v odd, keeping x a = v (mod p): divide v by its factors of 2 and x by
// as many.  v != 0.
FP384_FN void strip_twos(uint32_t v[kWords], uint32_t x[kWords]) {
  FP384_ROLLED
  while (v[0] == 0) {
    shift_down(v, 32);
    div_pow2(x, 32);
  }
  const int k = ctz(v[0]);
  if (k) {
    shift_down(v, k);
    div_pow2(x, k);
  }
}

// a^-1 in the Montgomery domain (the inverse of a R is a^-1 R) for
// canonical a, with inv(0) = 0.  Binary extended Euclid on the plain
// value A = a R: u = A and v = p, with coefficients x = 1 and y = 0 kept
// so that x A = u and y A = v (mod p).  Both stay odd after their factors of 2
// are stripped; each step subtracts the smaller from the larger (and its
// coefficient from the other's, mod p) and strips the difference's
// factors of 2, dividing the coefficient by as many (div_pow2).  The gcd
// is 1, so u and v meet at 1, and then x = A^-1 = a^-1 R^-1: one
// Montgomery product by R^3 gives a^-1 R.  For BLS12-381's p: 268
// subtractions on average over random inputs (at most about 300), each a
// 12-word subtraction, a modular subtraction and a shift by about 2 bits.
// The inverse is unique, so the limbs are those of the plain Fermat chain
// (ops/fp.py inv_reference).
FP384_FN void inv(const uint32_t a[kWords], uint32_t out[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  constexpr uint32_t r3[kWords] = {HARMONY_R3_WORDS};
  uint32_t u[kWords], v[kWords], x[kWords], y[kWords], d[kWords];
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    u[j] = a[j];
    v[j] = p[j];
    x[j] = j == 0;
    y[j] = 0;
    any |= a[j];
  }
  if (!any) {
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) out[j] = 0;
    return;
  }
  strip_twos(u, x);
  FP384_ROLLED
  for (;;) {
    if (!sub_chain(u, v, d)) {  // u >= v
      uint32_t nonzero = 0;
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) nonzero |= d[j];
      if (!nonzero) break;  // u = v = 1
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) u[j] = d[j];
      sub_mod(x, y);
      strip_twos(u, x);
    } else {
      sub_chain(v, u, v);
      sub_mod(y, x);
      strip_twos(v, y);
    }
  }
  mont_mul(x, r3, out);
}

#if defined(__CUDACC__)
// One row of 32 limbs from device memory into 12 words, by 16-byte loads:
// each row is 128 B and 16-byte aligned (the wrappers check the base
// pointers).
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src,
                                         uint32_t w[kWords]) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  uint32_t l[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs / 4; ++k) {
    const int4 x = __ldg(s4 + k);
    l[4 * k] = x.x; l[4 * k + 1] = x.y; l[4 * k + 2] = x.z; l[4 * k + 3] = x.w;
  }
  pack(l, w);
}

// 12 words out to one row of 32 limbs, by 16-byte stores.
__device__ __forceinline__ void store_row(const uint32_t w[kWords],
                                          int32_t* __restrict__ dst) {
  uint32_t l[kLimbs];
  unpack(w, l);
  int4* d4 = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < kLimbs / 4; ++k) {
    d4[k] = make_int4(l[4 * k], l[4 * k + 1], l[4 * k + 2], l[4 * k + 3]);
  }
}
#endif  // __CUDACC__

}  // namespace fp384
