// The final exponentiation of the BLS12-381 pairing for one lane, as a
// program of plans of phases (phases.cuh): run by final_exp.cu on one
// block per lane and, as plain C++, by the host test of its plans
// (tests/test_torch_final_exp_host.py).
//
// It computes ops/pairing.py final_exponentiation_reference, f^(3 (p^12 -
// 1) / r), the cubed pairing of the JAX package: the easy part
// f2 = (conj(f) f^-1)^(p^2 + 1), then the hard part by the x-chain,
//   m1 = conj(f2^|x-1|), m2 = conj(m1^|x-1|), m3 = conj(m2^|x|) m2^p,
//   out = m3^(x^2) m3^(p^2) conj(m3) f2^3,
// each power a square-and-multiply over |x|'s or |x - 1|'s static
// schedule.  Every value is canonical, so each product, inverse and
// Frobenius map gives the plain version's limbs whatever the formula; the
// squarings of the powers are the plain version's Granger-Scott
// polynomial (cyclo.cuh SquareLazy: Square's canonical operations, its
// products' operands left below 2p), so a lane outside the cyclotomic
// subgroup (a pad lane's Miller value, or 0) gets the plain version's
// limbs too, and the inverse keeps 0 -> 0.
//
// The lane's values stay in its scratch area for the whole call (elements
// of 12 words): the accumulator (squared in place, its sums and products
// following it), the base of the power, f2^3, m3, the input, and one
// region for the intermediates of a product, a Frobenius map or the
// inverse.  The steps are a program (make_program) fixed at compile
// time: a run of squarings, a product ACC = ACC BASE, a Frobenius map of
// BASE in place, the inverse, or a move of one value to another slot.
// The card runs it as one table of the steps' phases (make_phases), so
// that each phase's code appears once and the product's once; the host
// test runs both the table and each step by its plan (run_step).
//
// From the generated header (kernels/_build.py params_header):
//   HARMONY_MILLER_DBL, HARMONY_MILLER_ADD   |x|'s schedule: per segment,
//                                            the squarings, and 1 if a
//                                            multiply follows
//   HARMONY_XM1_SQR, HARMONY_XM1_MUL         |x - 1|'s, the same way
//   HARMONY_FROB_WORDS  FROB_GAMMA (ops/_constants.py): xi^(m (p^k - 1)/6)
//                       for k = 1..3, m = 0..5, as Fp2 pairs of 12 words

#pragma once

#include <cstdint>
#include <tuple>
#include <type_traits>

#include "cyclo.cuh"
#include "fp12_plans.cuh"

#if !defined(HARMONY_MILLER_DBL) || !defined(HARMONY_MILLER_ADD) || \
    !defined(HARMONY_XM1_SQR) || !defined(HARMONY_XM1_MUL) ||       \
    !defined(HARMONY_FROB_WORDS)
#error "build through harmony_tpu_torch/kernels/_build.py, which defines the schedules"
#endif

namespace final_exp {

using fp12::ld;
using fp12::st;
using fp12_plans::TimesVKinds;
using fp12_plans::times_v;
using fp384::kWords;

// --- the lane's scratch area ------------------------------------------------

constexpr int kAcc = 0;    // 12: the accumulator; Square's sums and
                           //     products follow it, up to 36
constexpr int kBase = 36;  // 12: the base of the power, the other factor
constexpr int kF2 = 48;    // 12: f2^3
constexpr int kM3 = 60;    // 12: m3
constexpr int kT = 72;     // 12: the input f
constexpr int kWork = 84;  // the intermediates of one product, Frobenius
                           // map or inverse at a time
static_assert(cyclo::kV == kAcc && cyclo::kScratch <= kBase,
              "the squaring works on the accumulator");

// ACC = ACC BASE
using Mul = fp12_plans::Fp12Product<kAcc, kBase, kAcc, kWork>;

// --- moves ------------------------------------------------------------------

// The value at kTo = the value at kFrom, conjugated (its w coefficient
// negated: x^(p^6)) if kConj.
template <int kFrom, int kTo, bool kConj>
struct Move : phases::Linear<12> {
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t w[kWords], r[kWords];
    ld(s, kFrom + k, w);
    if (kConj && k >= 6) {
      phases::neg(w, r);
      st(s, kTo + k, r);
    } else {
      st(s, kTo + k, w);
    }
  }
};

// --- the Frobenius map of BASE, in place (ops/towers.py fp12_frobenius) -----
//
// x^(p^K): each Fp2 coefficient, conjugated for odd K, times
// FROB_GAMMA[K - 1][m], m = i12 + 2 i6 for the coefficient of w^i12
// v^i6: 6 Karatsuba products over Fp2, 18 Fp products in one round.

#if defined(__CUDACC__)
__constant__ uint32_t kGammaCard[] = {HARMONY_FROB_WORDS};
#endif
constexpr uint32_t kGamma[] = {HARMONY_FROB_WORDS};
static_assert(sizeof(kGamma) == 3 * 6 * 2 * kWords * sizeof(uint32_t),
              "FROB_GAMMA is 3 x 6 Fp2 constants");

// Component c of FROB_GAMMA[k - 1][m].
FP384_FN void gamma(int k, int m, int c, uint32_t out[kWords]) {
  const int at = (((k - 1) * 6 + m) * 2 + c) * kWords;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
#if defined(__CUDA_ARCH__)
    out[j] = kGammaCard[at + j];
#else
    out[j] = kGamma[at + j];
#endif
  }
}

constexpr int kFrobV = kWork;  // 18: the products [coefficient][h]

template <int K>
struct FrobProducts : phases::Products<18> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int e = k / 3, h = k % 3;
    uint32_t a0[kWords], a1[kWords], g0[kWords], g1[kWords];
    ld(s, kBase + 2 * e, a0);
    ld(s, kBase + 2 * e + 1, g0);
    if (K % 2) {
      phases::neg(g0, a1);
    } else {
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) a1[j] = g0[j];
    }
    phases::kara(a0, a1, h, x);
    const int m = e / 3 + 2 * (e % 3);
    gamma(K, m, 0, g0);
    gamma(K, m, 1, g1);
    phases::kara(g0, g1, h, y);
    return kFrobV + k;
  }
};

struct FrobCombine : phases::Linear<12> {
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t r[kWords];
    phases::combine(s, kFrobV + 3 * (k / 2), k % 2, r);
    st(s, kBase + k, r);
  }
};

template <int K>
using Frob = phases::Plan<FrobProducts<K>, FrobCombine>;

// --- the inverse of the input, and its conjugate (ops/towers.py fp12_inv) ---
//
// BASE = f^-1 and ACC = conj(f) for f at kT, by the norms of the plain
// version: f^-1 = (a0 n^-1, -a1 n^-1) with n = a0^2 - v a1^2 over Fp6;
// n^-1 = (t0, t1, t2) d^-1 with t0 = n0^2 - xi n1 n2, t1 = xi n2^2 - n0 n1,
// t2 = n1^2 - n0 n2 and d = n0 t0 + xi (n2 t1 + n1 t2) over Fp2; d^-1 =
// (d0, -d1) (d0^2 + d1^2)^-1, the one Fp inverse (fp384.cuh inv4,
// batched binary GCD steps on four threads; it inverts a public pairing
// value, so its variable time is acceptable here).  A zero f has zero
// norms and gets 0, as the plain version.  Fp6 products by fp12_plans.cuh,
// Fp2 products by Karatsuba.
//
//   phase        tasks  writes
//   Sq           4 ph.  kIU: a0^2, a1^2 (Fp6Products, 36 products)
//   Norm         6      kIN: n
//   NPairs       18     kIQ: n0^2, n2^2, n1^2, n1 n2, n0 n1, n0 n2
//   Cofactors    6      kIT: t0, t1, t2
//   NTProducts   9      kIM: n0 t0, n2 t1, n1 t2
//   Fp2Norm      2      kID: d
//   Fp2NormSq    2      kIDsq: d0^2, d1^2
//   Gcd          4      kIE: (d0^2 + d1^2)^-1 (four threads)
//   Fp2NormInv   2      kIDi: d^-1
//   TProducts    9      kIO: t_i d^-1
//   Fp6NormInv   6      kINi: n^-1
//   Out          4 ph.  kIU: a0 n^-1, a1 n^-1 (Fp6Products, 36 products)
//   Last         24     BASE: f^-1; beside it ACC = conj(f)
// Out reuses Sq's regions, each after Sq's last read of it.

constexpr int kIS = kWork;       // 24: Fp6Products: the sums
constexpr int kIV = kIS + 24;    // 36: the products
constexpr int kIW = kIV + 36;    // 24: the Fp2 products
constexpr int kIU = kIW + 24;    // 12: the Fp6 products
constexpr int kIN = kIU + 12;    // 6: n
constexpr int kIQ = kIN + 6;     // 18: products of the Fp2 pairs of n
constexpr int kIT = kIQ + 18;    // 6: t0, t1, t2
constexpr int kIM = kIT + 6;     // 9: products of n_i t_j
constexpr int kID = kIM + 9;     // 2: d
constexpr int kIDsq = kID + 2;   // 2: d0^2, d1^2
constexpr int kIE = kIDsq + 2;   // 1: (d0^2 + d1^2)^-1
constexpr int kIDi = kIE + 1;    // 2: d^-1
constexpr int kIO = kIDi + 2;    // 9: products of t_i d^-1
constexpr int kINi = kIO + 9;    // 6: n^-1
constexpr int kScratch =
    Mul::kEnd > kINi + 6 ? Mul::kEnd : kINi + 6;  // 241 elements, 11,568 B

struct SqOperand {  // a0 a0, a1 a1
  static FP384_FN int base(int, int f6) { return kT + 6 * f6; }
};
using Sq = fp12_plans::Fp6Products<2, SqOperand, kIS, kIV, kIW, kIU>;

struct Norm {  // n = a0^2 - v a1^2
  static FP384_FN void element(int e, uint32_t* s) {
    uint32_t t[kWords], z[kWords], r[kWords];
    times_v(s, kIU + 6, e, t);
    ld(s, kIU + e, z);
    phases::sub(z, t, r);
    st(s, kIN + e, r);
  }
};

// The Fp2 pairs of n that Q multiplies: (0, 0), (2, 2), (1, 1), (1, 2),
// (0, 1), (0, 2); and the coefficients of n that M multiplies by t0, t1,
// t2: 0, 2, 1.
FP384_FN int q_left(int g) { return g == 1 ? 2 : g == 2 || g == 3 ? 1 : 0; }
FP384_FN int q_right(int g) {
  return g == 0 ? 0 : g == 2 || g == 4 ? 1 : 2;
}
FP384_FN int m_left(int g) { return g == 0 ? 0 : g == 1 ? 2 : 1; }

struct NPairs : phases::Products<18> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int g = k / 3, h = k % 3;
    phases::kara(s, kIN + 2 * q_left(g), h, x);
    phases::kara(s, kIN + 2 * q_right(g), h, y);
    return kIQ + k;
  }
};

struct Cofactors : phases::Linear<6> {  // t0, t1, t2, component c
  static FP384_FN void task(int k, uint32_t* s) {
    const int i = k / 2, c = k % 2;
    uint32_t a[kWords], b0[kWords], b1[kWords], r[kWords];
    if (i == 0) {  // n0^2 - xi (n1 n2)
      phases::combine(s, kIQ, c, a);
      phases::combine(s, kIQ + 9, 0, b0);
      phases::combine(s, kIQ + 9, 1, b1);
      phases::xi_part(b0, b1, c, r);
      phases::sub(a, r, b0);
    } else if (i == 1) {  // xi n2^2 - n0 n1
      phases::combine(s, kIQ + 3, 0, b0);
      phases::combine(s, kIQ + 3, 1, b1);
      phases::xi_part(b0, b1, c, a);
      phases::combine(s, kIQ + 12, c, r);
      phases::sub(a, r, b0);
    } else {  // n1^2 - n0 n2
      phases::combine(s, kIQ + 6, c, a);
      phases::combine(s, kIQ + 15, c, r);
      phases::sub(a, r, b0);
    }
    st(s, kIT + k, b0);
  }
};

struct NTProducts : phases::Products<9> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int g = k / 3, h = k % 3;
    phases::kara(s, kIN + 2 * m_left(g), h, x);
    phases::kara(s, kIT + 2 * g, h, y);
    return kIM + k;
  }
};

struct Fp2Norm : phases::Linear<2> {  // d = m0 + xi (m1 + m2)
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t a[kWords], b[kWords], u0[kWords], u1[kWords];
    phases::combine(s, kIM + 3, 0, a);
    phases::combine(s, kIM + 6, 0, b);
    phases::add(a, b, u0);
    phases::combine(s, kIM + 3, 1, a);
    phases::combine(s, kIM + 6, 1, b);
    phases::add(a, b, u1);
    phases::xi_part(u0, u1, c, a);
    phases::combine(s, kIM, c, b);
    phases::add(b, a, u0);
    st(s, kID + c, u0);
  }
};

struct Fp2NormSq : phases::Products<2> {
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    ld(s, kID + c, x);
    ld(s, kID + c, y);
    return kIDsq + c;
  }
};

// (d0^2 + d1^2)^-1, 0 for 0: on the card the four tasks are the four
// threads of fp384::inv4; under g++ task 0 runs fp384::inv, which steps
// the same four threads in turn.
struct Gcd : phases::Linear<4> {
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t a[kWords], r[kWords];
    phases::ld_add(s, kIDsq, kIDsq + 1, a);
#if defined(__CUDA_ARCH__)
    fp384::inv4(k, 0xfu, a, r);
#else
    if (k) return;
    fp384::inv(a, r);
#endif
    if (k == 0) st(s, kIE, r);
  }
};

struct Fp2NormInv : phases::Products<2> {  // d0 e, (-d1) e
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    ld(s, kID + c, y);
    if (c) {
      phases::neg(y, x);
    } else {
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) x[j] = y[j];
    }
    ld(s, kIE, y);
    return kIDi + c;
  }
};

struct TProducts : phases::Products<9> {  // t_i d^-1
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int g = k / 3, h = k % 3;
    phases::kara(s, kIT + 2 * g, h, x);
    phases::kara(s, kIDi, h, y);
    return kIO + k;
  }
};

struct Fp6NormInv : phases::Linear<6> {
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t r[kWords];
    phases::combine(s, kIO + 3 * (k / 2), k % 2, r);
    st(s, kINi + k, r);
  }
};

struct OutOperand {  // a0 n^-1, a1 n^-1
  static FP384_FN int base(int side, int f6) {
    return side ? kINi : kT + 6 * f6;
  }
};
using Out = fp12_plans::Fp6Products<2, OutOperand, kIS, kIV, kIW, kIU>;

struct Last : phases::Linear<12> {  // f^-1 = (a0 n^-1, -a1 n^-1)
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t w[kWords], r[kWords];
    ld(s, kIU + k, w);
    if (k >= 6) {
      phases::neg(w, r);
      st(s, kBase + k, r);
    } else {
      st(s, kBase + k, w);
    }
  }
};

using Inverse = phases::Plan<
    Sq::Sums, Sq::Products, Sq::Fp2Combine, Sq::Fp6Combine,
    TimesVKinds<Norm>, NPairs, Cofactors, NTProducts, Fp2Norm, Fp2NormSq,
    Gcd, Fp2NormInv, TProducts, Fp6NormInv,
    Out::Sums, Out::Products, Out::Fp2Combine, Out::Fp6Combine,
    phases::Beside<Last, Move<kT, kAcc, true>>>;

// --- the program ------------------------------------------------------------

enum Op : uint16_t {
  kEnd,
  kInverse,     // BASE = f^-1, ACC = conj(f)
  kSquare,      // ACC = ACC^(2^n), n squarings (the step's high byte)
  kMul,         // ACC = ACC BASE
  kFrob1,       // BASE = BASE^p
  kFrob2,       // BASE = BASE^(p^2)
  kConjAcc,     // ACC = conj(ACC)
  kAccFromBase,
  kBaseFromAcc,
  kBaseFromConjAcc,
  kBaseFromM3,
  kBaseFromConjM3,
  kBaseFromF2,
  kF2FromAcc,
  kM3FromAcc,
};

constexpr int kMaxSteps = 128;

struct Program {
  uint16_t step[kMaxSteps];
  int n;
};

FP384_FN constexpr void put(Program& p, int op, int arg = 0) {
  p.step[p.n++] = static_cast<uint16_t>(op | arg << 8);
}

// ACC = BASE^e by e's schedule: per segment, squarings, then a product by
// BASE where one follows.
template <int N>
FP384_FN constexpr void power(Program& p, const int (&n_sqr)[N],
                              const int (&do_mul)[N]) {
  put(p, kAccFromBase);
  for (int g = 0; g < N; ++g) {
    put(p, kSquare, n_sqr[g]);
    if (do_mul[g]) put(p, kMul);
  }
}

FP384_FN constexpr Program make_program() {
  constexpr int x_sqr[] = {HARMONY_MILLER_DBL};
  constexpr int x_mul[] = {HARMONY_MILLER_ADD};
  constexpr int xm1_sqr[] = {HARMONY_XM1_SQR};
  constexpr int xm1_mul[] = {HARMONY_XM1_MUL};
  Program p{};
  put(p, kInverse);
  put(p, kMul);  // f1 = conj(f) f^-1 = f^(p^6 - 1)
  put(p, kBaseFromAcc);
  put(p, kFrob2);
  put(p, kMul);  // f2 = f1^(p^2) f1
  put(p, kBaseFromAcc);
  put(p, kMul);
  put(p, kMul);
  put(p, kF2FromAcc);  // f2^3; BASE = f2
  power(p, xm1_sqr, xm1_mul);
  put(p, kBaseFromConjAcc);  // m1 = conj(f2^|x-1|) = f2^(x-1)
  power(p, xm1_sqr, xm1_mul);
  put(p, kBaseFromConjAcc);  // m2 = m1^(x-1)
  power(p, x_sqr, x_mul);
  put(p, kConjAcc);
  put(p, kFrob1);
  put(p, kMul);  // m3 = m2^x m2^p
  put(p, kBaseFromAcc);
  put(p, kM3FromAcc);
  power(p, x_sqr, x_mul);
  put(p, kBaseFromAcc);
  power(p, x_sqr, x_mul);  // m3^(x^2): the two conjugations cancel
  put(p, kBaseFromM3);
  put(p, kFrob2);
  put(p, kMul);  // m3^(x^2) m3^(p^2)
  put(p, kBaseFromConjM3);
  put(p, kMul);  // m4 = m3^(x^2) m3^(p^2) m3^-1
  put(p, kBaseFromF2);
  put(p, kMul);  // m4 f2^3
  put(p, kEnd);
  return p;
}

constexpr Program kProgram = make_program();
static_assert(kProgram.n <= kMaxSteps, "the program fits its table");
#if defined(__CUDACC__)
__constant__ Program kProgramCard = make_program();
#endif

FP384_FN int step_at(int i) {
#if defined(__CUDA_ARCH__)
  return kProgramCard.step[i];
#else
  return kProgram.step[i];
#endif
}

// The plan of one step of the program, given to v (which returns false
// if the plan's tasks conflicted: the host test's runner; the card's
// never does).  A run of squarings is its plan once; the caller repeats
// it.
template <class V>
FP384_FN constexpr bool visit(const V& v, int op) {
  switch (op) {
    case kInverse:
      return v(Inverse{});
    case kSquare:
      return v(cyclo::SquareLazy{});
    case kMul:
      return v(Mul::Plan{});
    case kFrob1:
      return v(Frob<1>{});
    case kFrob2:
      return v(Frob<2>{});
    case kConjAcc:
      return v(phases::Plan<Move<kAcc, kAcc, true>>{});
    case kAccFromBase:
      return v(phases::Plan<Move<kBase, kAcc, false>>{});
    case kBaseFromAcc:
      return v(phases::Plan<Move<kAcc, kBase, false>>{});
    case kBaseFromConjAcc:
      return v(phases::Plan<Move<kAcc, kBase, true>>{});
    case kBaseFromM3:
      return v(phases::Plan<Move<kM3, kBase, false>>{});
    case kBaseFromConjM3:
      return v(phases::Plan<Move<kM3, kBase, true>>{});
    case kBaseFromF2:
      return v(phases::Plan<Move<kF2, kBase, false>>{});
    case kF2FromAcc:
      return v(phases::Plan<Move<kAcc, kF2, false>>{});
    case kM3FromAcc:
      return v(phases::Plan<Move<kAcc, kM3, false>>{});
    default:
      return false;
  }
}

// One step of the program by plans (the host test runs each step alone
// this way): `run` runs a plan.
template <class Run>
FP384_FN bool run_step(const Run& run, int step) {
  const int op = step & 0xff;
  if (op == kEnd) return true;
  bool ok = true;
  const int n = op == kSquare ? step >> 8 : 1;
  FP384_ROLLED
  for (int r = 0; r < n; ++r) ok = visit(run, op) && ok;
  return ok;
}

// --- the program as one table of phases --------------------------------------
//
// The card runs the whole program as one loop over a table of phases
// (kPhases, from the program at compile time: 1,198 entries, each a
// phase's number and its tasks), so that the code of each phase appears
// once and the split product once: a product phase forms its operands by
// its number (product_operands), then every product phase reaches the
// same product.  Numbers
// [0, kProducts) are product phases, the rest phases of adds.

template <class... Ph>
struct List {};

using ProductPhases = List<
    cyclo::SquaresLazy, Mul::Products, FrobProducts<1>, FrobProducts<2>,
    Sq::Products, NPairs, NTProducts, Fp2NormSq, Fp2NormInv, TProducts,
    Out::Products>;
using LinearPhases = List<
    cyclo::Sums, cyclo::Next, Mul::Pre, Mul::Sums, Mul::Fp2Combine,
    Mul::Fp6Combine, Mul::Post, FrobCombine, Sq::Sums, Sq::Fp2Combine,
    Sq::Fp6Combine, TimesVKinds<Norm>, Cofactors, Fp2Norm, Gcd, Fp6NormInv,
    Out::Sums, Out::Fp2Combine, Out::Fp6Combine,
    phases::Beside<Last, Move<kT, kAcc, true>>, Move<kAcc, kAcc, true>,
    Move<kBase, kAcc, false>, Move<kAcc, kBase, false>,
    Move<kAcc, kBase, true>, Move<kM3, kBase, false>, Move<kM3, kBase, true>,
    Move<kF2, kBase, false>, Move<kAcc, kF2, false>, Move<kAcc, kM3, false>>;

template <class... Ph>
constexpr int length(List<Ph...>) {
  return sizeof...(Ph);
}
constexpr int kProducts = length(ProductPhases{});
constexpr int kEndPhase = 0xff;

// The index of T in a list, or -1.
template <class T, class... Ph>
constexpr int index_of(List<Ph...>) {
  int i = 0, found = -1;
  ((std::is_same<T, Ph>::value && found < 0 ? found = i : 0, ++i), ...);
  return found;
}

// A phase's entry in the table: its number, and its tasks above it.
template <class Ph>
constexpr uint16_t entry() {
  constexpr int id = Ph::kProduct ? index_of<Ph>(ProductPhases{})
                                  : kProducts + index_of<Ph>(LinearPhases{});
  static_assert(id >= 0 && id < kEndPhase && Ph::kTasks < 256,
                "every phase of the program is in the lists");
  return static_cast<uint16_t>(id | Ph::kTasks << 8);
}

constexpr int kMaxPhases = 1536;

struct PhaseTable {
  uint16_t e[kMaxPhases];
  int n;
};

struct Append {
  PhaseTable* t;
  template <class... Ph>
  constexpr bool operator()(phases::Plan<Ph...>) const {
    ((t->e[t->n++] = entry<Ph>()), ...);
    return true;
  }
};

constexpr PhaseTable make_phases() {
  constexpr Program p = make_program();
  PhaseTable t{};
  for (int i = 0; i < p.n; ++i) {
    const int op = p.step[i] & 0xff;
    const int n = op == kSquare ? p.step[i] >> 8 : 1;
    for (int r = 0; r < n; ++r) visit(Append{&t}, op);
  }
  t.e[t.n++] = kEndPhase;
  return t;
}

constexpr PhaseTable kPhases = make_phases();
static_assert(kPhases.n <= kMaxPhases, "the phases fit their table");
#if defined(__CUDACC__)
__constant__ PhaseTable kPhasesCard = make_phases();
#endif

// Entry i of the program's table.
FP384_FN int phase_at(int i) {
#if defined(__CUDA_ARCH__)
  return kPhasesCard.e[i];
#else
  return kPhases.e[i];
#endif
}

struct ProgramPhases {
  FP384_FN int operator()(int i) const { return phase_at(i); }
};

template <int I, class... Ph>
using At = typename std::tuple_element<I, std::tuple<Ph...>>::type;

// Phase I of a list, if the list has one.
template <int I, class... Ph>
struct Nth {
  static constexpr bool kHas = I < static_cast<int>(sizeof...(Ph));
  using Type = At<kHas ? I : 0, Ph...>;
};

// Task k of phase I: its operands and where the product goes (-1:
// nowhere; a task past the phase's last forms the last's), or its adds.
template <int I, class... Ph>
FP384_FN int operands_of(List<Ph...>, int k, const uint32_t* s,
                         uint32_t x[kWords], uint32_t y[kWords]) {
  using P = typename Nth<I, Ph...>::Type;
  const int out = P::operands(k < P::kTasks ? k : P::kTasks - 1, s, x, y);
  return k < P::kTasks ? out : -1;
}

template <int I, class... Ph>
FP384_FN void task_of(List<Ph...>, int k, uint32_t* s) {
  using P = typename Nth<I, Ph...>::Type;
  if (k < P::kTasks) P::task(k, s);
}

// Product phase id's task k, by a binary search over the product
// phases (a switch here, as for the phases of adds below, takes the kernel
// above the 128 registers a thread that two blocks of 224 threads allow).
template <int Lo = 0, int Hi = length(ProductPhases{})>
FP384_FN int product_operands(int id, int k, const uint32_t* s,
                              uint32_t x[kWords], uint32_t y[kWords]) {
  if constexpr (Hi - Lo == 1) {
    return operands_of<Lo>(ProductPhases{}, k, s, x, y);
  } else {
    constexpr int kMid = (Lo + Hi) / 2;
    return id < kMid ? product_operands<Lo, kMid>(id, k, s, x, y)
                     : product_operands<kMid, Hi>(id, k, s, x, y);
  }
}

constexpr int kLongestList = 32;  // the cases of the switch below
static_assert(length(LinearPhases{}) <= kLongestList,
              "the switch below has a case for every phase of adds");

// Phase id's task k of adds, by one switch over the phases of adds, so
// that such a phase costs one indirect jump to its code.
#define FINAL_EXP_CASES(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) \
  X(13) X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) \
  X(24) X(25) X(26) X(27) X(28) X(29) X(30) X(31)

FP384_FN void linear_task(int id, int k, uint32_t* s) {
  switch (id - kProducts) {
#define FINAL_EXP_CASE(I)                                 \
  case I:                                                 \
    if constexpr (I < length(LinearPhases{})) {           \
      task_of<I>(LinearPhases{}, k, s);                   \
    }                                                     \
    break;
    FINAL_EXP_CASES(FINAL_EXP_CASE)
#undef FINAL_EXP_CASE
  }
}
#undef FINAL_EXP_CASES

template <class... Ph>
constexpr int most_threads(List<Ph...>) {
  int m = 0;
  ((m = phases::threads<Ph>() > m ? phases::threads<Ph>() : m), ...);
  return m;
}
constexpr int kMostThreads =
    most_threads(ProductPhases{}) > most_threads(LinearPhases{})
        ? most_threads(ProductPhases{})
        : most_threads(LinearPhases{});
constexpr int kThreads = (kMostThreads + 31) / 32 * 32;

#if defined(__CUDACC__)
// The phases of a table (at(i) is entry i; ProgramPhases: the whole
// final exponentiation, on f at kT, the result at kAcc) on one block
// whose scratch area is s.  Product phases give each task a group
// of split::kGroup threads, whole warps at a time (a warp past the last
// task skips the phase; a group past it in a busy warp multiplies the
// last task's operands again and stores nothing); the group's first
// thread stores the product.  Every phase ends with
// __syncthreads(), which every thread of the block reaches.
template <class Table>
__device__ __forceinline__ void run_phases(uint32_t* s, const Table& at) {
  const int t = threadIdx.x, g = t / split::kGroup, r = t % split::kGroup;
#pragma unroll 1
  for (int i = 0;; ++i) {
    const int e = at(i), id = e & 0xff, tasks = e >> 8;
    if (id == kEndPhase) break;
    if (id < kProducts) {
      if (t < (tasks * split::kGroup + 31) / 32 * 32) {
        uint32_t x[kWords], y[kWords], z[kWords];
        const int out = product_operands(id, g, s, x, y);
        split::mont_mul(r, x, y, z);
        if (r == 0 && out >= 0) fp12::st(s, out, z);
      }
    } else {
      linear_task(id, t, s);
    }
    __syncthreads();
  }
}
#endif  // __CUDACC__

}  // namespace final_exp
