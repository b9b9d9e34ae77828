// 384-bit arithmetic over the BLS12-381 base field, one element per
// thread, shared by the CUDA kernels (mont_mul.cu, fp_addsub.cu,
// fp_inv.cu, and the tower kernels through fp12.cuh) and, as plain C++, by
// the host tests of their arithmetic (tests/test_torch_fp384_host.py,
// tests/test_torch_miller_host.py).
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
//   HARMONY_P_WORDS          p as 12 little-endian 32-bit words
//   HARMONY_P_INV32          -p^-1 mod 2^32
//   HARMONY_P_MINUS_2_WORDS  p - 2, the Fermat exponent, as 12 words

#pragma once

#include <cstdint>

#if !defined(HARMONY_P_WORDS) || !defined(HARMONY_P_INV32) || \
    !defined(HARMONY_P_MINUS_2_WORDS)
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

// a^(p - 2) = a^-1 mod p for canonical a in the Montgomery domain (the
// inverse of a R is a^-1 R), with inv(0) = 0: Fermat's chain, left to
// right over the bits of p - 2.  The top bit starts the chain at a; each
// lower bit squares, and a set bit multiplies by a: 380 squarings and 228
// products in a row for BLS12-381's p.  The plain version
// (ops/fp.py inv_reference) squares 1 once more and multiplies it by a
// first; both give the canonical residue, so the limbs agree.
FP384_FN void inv(const uint32_t a[kWords], uint32_t out[kWords]) {
  constexpr uint32_t e[kWords] = {HARMONY_P_MINUS_2_WORDS};
  int top = 32 * kWords - 1;
  while (!(e[top / 32] >> (top % 32) & 1u)) --top;
  uint32_t acc[kWords], sq[kWords];
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) acc[j] = a[j];
  FP384_ROLLED
  for (int bit = top - 1; bit >= 0; --bit) {
    mont_mul(acc, acc, sq);
    if (e[bit / 32] >> (bit % 32) & 1u) {
      mont_mul(sq, a, acc);
    } else {
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) acc[j] = sq[j];
    }
  }
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) out[j] = acc[j];
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
