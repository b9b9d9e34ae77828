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

// Montgomery product a b 2^-384 mod p of a, b < 2p (canonical or not; the
// result is canonical): CIOS over 12 words.  Step i adds a_i b to the
// accumulator t; then
// m = t_0 (-p^-1) mod 2^32 makes t + m p divisible by 2^32, and the
// division is a one-word shift.  Every 64-bit sum is at most
// (2^32 - 1) + (2^32 - 1)^2 + (2^32 - 1) = 2^64 - 1, so none overflows.
// p < 2^381 keeps t short: if t < 2p, then t + a_i b + m p < 2^33 p <
// 2^414 fits in 13 words, and the shifted t is again < 2p < 2^382, so t
// needs no 13th word between steps (the "no-carry" CIOS).  After 12 steps
// t < 2p, and one conditional subtraction gives the canonical result, the
// same digits as the 12-bit schedule of the JAX package.  For b < 2p, t <
// b + p < 3p between steps and t < a b / 2^384 + p < 1.5p at the end, so
// one subtraction still suffices.
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
    t[kWords - 1] = top + static_cast<uint32_t>(c);  // < 2^31: t < 3p < 2^383
  }
  cond_sub_p(t, out);
}

// --- Inversion by batched binary GCD steps ---------------------------------
//
// Pornin's optimized binary GCD (IACR ePrint 2020/972, algorithm 2) with
// Montgomery-style updates of the coefficients.  Variable-time: its loop
// and branches follow the value.  That is acceptable here because both
// inversions on the verify path invert public values (an aggregate key's
// Z and a pairing value); a value derived from a secret must not be
// inverted with it (ROADMAP queue A item 3).
//
// The values live in 13 limbs of 30 bits (390 bits), the low 12 in [0,
// 2^30) and the top one signed.  A batch is 30 steps, so its coefficients
// satisfy |f| + |g| <= 2^30 and fit an int32: a limb's product by one is
// one 32 x 32 -> 64-bit multiply, a limb's terms and carry fit an int64,
// and the division by 2^30 is a move by one limb.

constexpr int kLimbs30 = 13;
constexpr uint32_t kMask30 = 0x3fffffffu;
constexpr int kBatchSteps = 30;  // steps a batch, on 62-bit approximations
// ceil((2 len(p) - 1) / 30) = 26 batches always suffice for BLS12-381's
// p (the paper's bound); the loop stops at a = 0, and this cap only keeps
// a fault from looping for ever
constexpr int kMaxBatches = 32;

struct Limbs30 {
  int32_t l[kLimbs30];
};

// 12 words (< 2^384) -> 13 limbs of 30 bits (< 2^390).
FP384_FN constexpr Limbs30 to30(const uint32_t w[kWords]) {
  Limbs30 out{};
  for (int i = 0; i < kLimbs30; ++i) {
    const int bit = 30 * i, word = bit / 32, off = bit % 32;
    const uint64_t lo = word < kWords ? w[word] : 0u;
    const uint64_t hi = word + 1 < kWords ? w[word + 1] : 0u;
    out.l[i] = static_cast<int32_t>((hi << 32 | lo) >> off & kMask30);
  }
  return out;
}

FP384_FN constexpr Limbs30 p30() {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  return to30(p);
}

// 13 limbs of a value in [0, 2^384) -> 12 words.  Word j is bits [32 j,
// 32 j + 32): limb 32 j / 30 from bit 32 j % 30 <= 28, then the next limb.
FP384_FN void from30(const int32_t l[kLimbs30], uint32_t w[kWords]) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    const int i = 32 * j / 30, off = 32 * j % 30;
    const uint64_t v =
        static_cast<uint64_t>(static_cast<uint32_t>(l[i])) >> off |
        static_cast<uint64_t>(static_cast<uint32_t>(l[i + 1])) << (30 - off);
    w[j] = static_cast<uint32_t>(v);
  }
}

// Limb i of l for a limb number i known only at run time (0 past the
// top), by selects: no register array is indexed at run time.
FP384_FN uint64_t limb_at(const int32_t l[kLimbs30], int i) {
  uint64_t v = 0;
  FP384_UNROLL
  for (int k = 0; k < kLimbs30; ++k) {
    v = k == i ? static_cast<uint32_t>(l[k]) : v;
  }
  return v;
}

FP384_FN int clz(uint32_t w) {  // w != 0
#if defined(__CUDA_ARCH__)
  return __clz(w);
#else
  return __builtin_clz(w);
#endif
}

// The 62-bit approximation of l >= 0 for a batch: its low 30 bits, and
// above them the 32 bits of l from bit `at` on.
FP384_FN uint64_t approx(const int32_t l[kLimbs30], int at) {
  const int i = at / 30, off = at % 30;
  const uint64_t w =
      limb_at(l, i) | limb_at(l, i + 1) << 30 | limb_at(l, i + 2) << 60;
  return static_cast<uint32_t>(l[0]) | (w >> off & 0xffffffffull) << 30;
}

// l = -l.
FP384_FN void neg30(int32_t l[kLimbs30]) {
  int64_t c = 0;
  FP384_UNROLL
  for (int j = 0; j + 1 < kLimbs30; ++j) {
    c -= l[j];
    l[j] = static_cast<int32_t>(c & kMask30);
    c >>= 30;
  }
  l[kLimbs30 - 1] = static_cast<int32_t>(c - l[kLimbs30 - 1]);
}

// l = l + sign p, sign = 1 or -1, and whether the result is negative.
FP384_FN bool add_p30(int32_t l[kLimbs30], int sign, int32_t out[kLimbs30]) {
  constexpr Limbs30 p = p30();
  int64_t c = 0;
  FP384_UNROLL
  for (int j = 0; j + 1 < kLimbs30; ++j) {
    c += l[j] + static_cast<int64_t>(sign) * p.l[j];
    out[j] = static_cast<int32_t>(c & kMask30);
    c >>= 30;
  }
  out[kLimbs30 - 1] = static_cast<int32_t>(
      c + l[kLimbs30 - 1] + static_cast<int64_t>(sign) * p.l[kLimbs30 - 1]);
  return out[kLimbs30 - 1] < 0;
}

FP384_FN bool is_zero30(const int32_t l[kLimbs30]) {
  int32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kLimbs30; ++j) any |= l[j];
  return any == 0;
}

// (-l) mod p for l in [0, p), with -0 = 0.
FP384_FN void neg_mod30(int32_t l[kLimbs30]) {
  if (is_zero30(l)) return;
  neg30(l);
  add_p30(l, 1, l);
}

// The inversion runs on four threads (a group; under g++, four states
// stepped in turn): threads 0 and 1 hold the pair (a, b), threads 2 and 3
// the pair (u, v).  A batch:
//   1. threads 0 and 1 form the batch's matrix from a and b (inv_matrix);
//      every thread takes thread 0's;
//   2. thread r forms row r % 2 of the matrix times its pair (inv_combine):
//      the new a (r = 0) or b (r = 1), exactly divided by 2^30 and made
//      positive (neg: whether that negated it), or the new u (r = 2) or v
//      (r = 3), times 2^-30 mod p;
//   3. thread r takes thread r ^ 1's result, and threads 0's and 1's sign
//      changes, and forms its new pair (inv_update): u and v negated mod p
//      where a or b changed sign.
// So each thread holds two values and forms one linear combination a
// batch, not four.
struct InvThread {
  int32_t x[kLimbs30], y[kLimbs30];  // the pair: (a, b) or (u, v)
  int32_t w[kLimbs30];               // this batch's row
  int32_t f0, g0, f1, g1;            // this batch's matrix
  bool neg;
};

// Thread r's pair before the first batch, for the plain value X.
FP384_FN void inv_start(int r, const Limbs30& x, InvThread& st) {
  constexpr Limbs30 p = p30();
  FP384_UNROLL
  for (int j = 0; j < kLimbs30; ++j) {
    st.x[j] = r < 2 ? x.l[j] : j == 0;
    st.y[j] = r < 2 ? p.l[j] : 0;
  }
}

// The batch's matrix from a = x and b = y: 30 binary GCD steps on their
// 62-bit approximations at the larger one's length.
FP384_FN void inv_matrix(InvThread& st) {
  int32_t top = 0;  // the number of the top limb of a | b
  FP384_UNROLL
  for (int j = 0; j < kLimbs30; ++j) {
    if (st.x[j] | st.y[j]) top = j;
  }
  const uint32_t high =
      static_cast<uint32_t>(limb_at(st.x, top) | limb_at(st.y, top));
  int n = 30 * top + 32 - clz(high);  // the length of max(a, b) > 0
  n = n < 62 ? 62 : n;
  uint64_t ta = approx(st.x, n - 32), tb = approx(st.y, n - 32);
  int32_t f0 = 1, g0 = 0, f1 = 0, g1 = 1;
  FP384_UNROLL
  for (int k = 0; k < kBatchSteps; ++k) {
    if (ta & 1) {
      const uint64_t d = ta - tb;
      if (ta < tb) {  // swap, then subtract: (tb - ta, ta)
        tb = ta;
        ta = 0 - d;
        int32_t q = f0;
        f0 = f1 - f0;
        f1 = q;
        q = g0;
        g0 = g1 - g0;
        g1 = q;
      } else {
        ta = d;
        f0 -= f1;
        g0 -= g1;
      }
    }
    ta >>= 1;
    f1 += f1;
    g1 += g1;
  }
  st.f0 = f0;
  st.g0 = g0;
  st.f1 = f1;
  st.g1 = g1;
}

// Row r % 2 of the matrix times the pair: (x f + y g + k p) / 2^30, with
// k = 0 for a, b (the steps made x f + y g a multiple of 2^30; the result
// is made positive) and k = -(x f + y g) p^-1 mod 2^30 for u, v (a 30-bit
// step of Montgomery's reduction; the result, in (-p, 2p), is reduced).
// |f| + |g| <= 2^30 and limbs below 2^30 keep each limb's terms below
// 2^62.
FP384_FN void inv_combine(int r, InvThread& st) {
  constexpr Limbs30 p = p30();
  const int32_t f = r % 2 ? st.f1 : st.f0, g = r % 2 ? st.g1 : st.g0;
  int64_t c = static_cast<int64_t>(st.x[0]) * f +
              static_cast<int64_t>(st.y[0]) * g;
  const uint32_t low = static_cast<uint32_t>(c) * kPInv & kMask30;
  const int32_t k = r < 2 ? 0 : static_cast<int32_t>(low);
  c = (c + static_cast<int64_t>(k) * p.l[0]) >> 30;  // exact
  FP384_UNROLL
  for (int j = 1; j < kLimbs30; ++j) {
    c += static_cast<int64_t>(st.x[j]) * f + static_cast<int64_t>(st.y[j]) * g +
         static_cast<int64_t>(k) * p.l[j];
    st.w[j - 1] = static_cast<int32_t>(c & kMask30);
    c >>= 30;  // arithmetic: the carry keeps the sign
  }
  st.w[kLimbs30 - 1] = static_cast<int32_t>(c);
  st.neg = st.w[kLimbs30 - 1] < 0;
  if (r < 2) {
    if (st.neg) neg30(st.w);
  } else {  // (-p, 2p) -> [0, p)
    int32_t d[kLimbs30];
    const bool below = add_p30(st.w, st.neg ? 1 : -1, d);
    if (st.neg || !below) {
      FP384_UNROLL
      for (int j = 0; j < kLimbs30; ++j) st.w[j] = d[j];
    }
  }
}

// Thread r's new pair from its row and thread r ^ 1's (other), given
// whether a (neg0) and b (neg1) changed sign: u or v negated mod p where
// its row of a, b did.
FP384_FN void inv_update(int r, InvThread& st, int32_t other[kLimbs30],
                         bool neg0, bool neg1) {
  if (r >= 2) {
    if (r == 2 ? neg0 : neg1) neg_mod30(st.w);
    if (r == 2 ? neg1 : neg0) neg_mod30(other);
  }
  FP384_UNROLL
  for (int j = 0; j < kLimbs30; ++j) {
    st.x[j] = r % 2 ? other[j] : st.w[j];
    st.y[j] = r % 2 ? st.w[j] : other[j];
  }
}

// a^-1 in the Montgomery domain (the inverse of a R is a^-1 R) for
// canonical a, with inv(0) = 0; returns the number of batches it took.
// On the plain value X = a R: a = X, b = p, u = 1, v = 0, with a = u X
// and b = v X (mod p) throughout.  Each batch runs 30 binary GCD steps on
// 62-bit approximations of a and b (the low 30 bits and the top 32 bits
// of each, at the larger one's length), which give the exact low bits of
// the steps' 2x2 matrix (f0 g0; f1 g1); then a, b = (a f0 + b g0,
// a f1 + b g1) / 2^30 on the full values (made positive, negating the
// row), and u, v by the same matrix times 2^-30 mod p.  When a reaches 0,
// b = gcd(X, p) = 1 = v X, so v = X^-1 = a^-1 R^-1, and one Montgomery
// product by R^3 gives a^-1 R.  For BLS12-381's p, at most 26 batches
// (about 19 on random values) where the plain binary GCD takes about 268
// steps on all 12 words.  The inverse is unique, so the limbs are those
// of the plain Fermat chain (ops/fp.py inv_reference).
//
// This is the four threads' steps run one after another (in reverse
// within each step where `reverse`): the host tests', and a reference for
// inv4, which runs them on the card.
FP384_FN int inv(const uint32_t x[kWords], uint32_t out[kWords],
                 bool reverse = false) {
  constexpr uint32_t r3[kWords] = {HARMONY_R3_WORDS};
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) any |= x[j];
  if (!any) {
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) out[j] = 0;
    return 0;
  }
  InvThread st[4];
  const Limbs30 x30 = to30(x);
  for (int r = 0; r < 4; ++r) inv_start(r, x30, st[r]);
  int batches = 0;
  for (bool done = false; !done;) {
    inv_matrix(st[0]);
    for (int r = 1; r < 4; ++r) {
      st[r].f0 = st[0].f0;
      st[r].g0 = st[0].g0;
      st[r].f1 = st[0].f1;
      st[r].g1 = st[0].g1;
    }
    for (int i = 0; i < 4; ++i) {
      const int r = reverse ? 3 - i : i;
      inv_combine(r, st[r]);
    }
    int32_t other[4][kLimbs30];
    for (int r = 0; r < 4; ++r) {
      for (int j = 0; j < kLimbs30; ++j) other[r][j] = st[r ^ 1].w[j];
    }
    const bool neg0 = st[0].neg, neg1 = st[1].neg;
    ++batches;
    done = is_zero30(st[0].w) || batches == kMaxBatches;
    for (int i = 0; i < 4; ++i) {
      const int r = reverse ? 3 - i : i;
      inv_update(r, st[r], other[r], neg0, neg1);
    }
  }
  uint32_t w[kWords];
  from30(st[2].y, w);
  mont_mul(w, r3, out);
  return batches;
}

#if defined(__CUDACC__)
// inv on a group of four consecutive lanes of a warp (a 1-D block): lane
// r = lane % 4 of the group calls it with the same x, `mask` being the
// group's lanes (or more, all with the same trip count); every lane gets
// a^-1 R.  The exchanges are shuffles within the group.
__device__ __forceinline__ int inv4(int r, unsigned mask,
                                    const uint32_t x[kWords],
                                    uint32_t out[kWords]) {
  constexpr uint32_t r3[kWords] = {HARMONY_R3_WORDS};
  uint32_t any = 0;
#pragma unroll
  for (int j = 0; j < kWords; ++j) any |= x[j];
  if (!any) {
#pragma unroll
    for (int j = 0; j < kWords; ++j) out[j] = 0;
    return 0;
  }
  InvThread st;
  inv_start(r, to30(x), st);
  int batches = 0;
#pragma unroll 1
  for (bool done = false; !done;) {
    if (r < 2) inv_matrix(st);
    st.f0 = __shfl_sync(mask, st.f0, 0, 4);
    st.g0 = __shfl_sync(mask, st.g0, 0, 4);
    st.f1 = __shfl_sync(mask, st.f1, 0, 4);
    st.g1 = __shfl_sync(mask, st.g1, 0, 4);
    inv_combine(r, st);
    int32_t other[kLimbs30];
#pragma unroll
    for (int j = 0; j < kLimbs30; ++j) {
      other[j] = __shfl_xor_sync(mask, st.w[j], 1, 4);
    }
    const int flags = (st.neg ? 1 : 0) | (is_zero30(st.w) ? 2 : 0);
    const int flags0 = __shfl_sync(mask, flags, 0, 4);
    const int flags1 = __shfl_sync(mask, flags, 1, 4);
    ++batches;
    done = (flags0 & 2) || batches == kMaxBatches;
    inv_update(r, st, other, flags0 & 1, flags1 & 1);
  }
  uint32_t w[kWords];
  from30(st.y, w);  // v, in threads 2 and 3
  mont_mul(w, r3, out);
#pragma unroll
  for (int j = 0; j < kWords; ++j) out[j] = __shfl_sync(mask, out[j], 2, 4);
  return batches;
}
#endif  // __CUDACC__

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
