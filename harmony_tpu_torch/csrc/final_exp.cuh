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
// polynomial (cyclo.cuh Square, unchanged), so a lane outside the
// cyclotomic subgroup (a pad lane's Miller value, or 0) gets the plain
// version's limbs too, and the inverse keeps 0 -> 0.
//
// The lane's values stay in its scratch area for the whole call (elements
// of 12 words): the accumulator (squared in place by Square, whose sums
// and products follow it), the base of the power, f2^3, m3, the input,
// and one region for the intermediates of a product, a Frobenius map or
// the inverse.  The steps are a program (make_program) fixed at compile
// time, read from a table at run time (__constant__ on the card), so
// that each plan's code appears once: the loop over the program runs a
// run of squarings, a product ACC = ACC BASE, a Frobenius map of BASE in
// place, the inverse, or a move of one value to another slot.
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
// (d0, -d1) (d0^2 + d1^2)^-1, the one Fp inverse (fp384.cuh inv, the
// binary GCD, on one thread; it inverts a public pairing value, so its
// variable time is acceptable here).  A zero f has zero norms and gets 0,
// as the plain version.  Fp6 products by fp12_plans.cuh, Fp2 products by
// Karatsuba.
//
//   phase        tasks  writes
//   Sq           4 ph.  kIU: a0^2, a1^2 (Fp6Products, 36 products)
//   Norm         6      kIN: n
//   NPairs       18     kIQ: n0^2, n2^2, n1^2, n1 n2, n0 n1, n0 n2
//   Cofactors    6      kIT: t0, t1, t2
//   NTProducts   9      kIM: n0 t0, n2 t1, n1 t2
//   Fp2Norm      2      kID: d
//   Fp2NormSq    2      kIDsq: d0^2, d1^2
//   Gcd          1      kIE: (d0^2 + d1^2)^-1
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

struct Gcd : phases::Linear<1> {  // (d0^2 + d1^2)^-1, 0 for 0
  static FP384_FN void task(int, uint32_t* s) {
    uint32_t a[kWords], r[kWords];
    phases::ld_add(s, kIDsq, kIDsq + 1, a);
    fp384::inv(a, r);
    st(s, kIE, r);
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

// One step of the program: `run` runs a plan and returns false if the
// plan's tasks conflicted (the host test's runner; the card's never does).
template <class Run>
FP384_FN bool run_step(const Run& run, int step) {
  switch (step & 0xff) {
    case kEnd:
      return true;
    case kInverse:
      return run(Inverse{});
    case kSquare: {
      bool ok = true;
      FP384_ROLLED
      for (int r = 0; r < step >> 8; ++r) ok = run(cyclo::Square{}) && ok;
      return ok;
    }
    case kMul:
      return run(Mul::Plan{});
    case kFrob1:
      return run(Frob<1>{});
    case kFrob2:
      return run(Frob<2>{});
    case kConjAcc:
      return run(phases::Plan<Move<kAcc, kAcc, true>>{});
    case kAccFromBase:
      return run(phases::Plan<Move<kBase, kAcc, false>>{});
    case kBaseFromAcc:
      return run(phases::Plan<Move<kAcc, kBase, false>>{});
    case kBaseFromConjAcc:
      return run(phases::Plan<Move<kAcc, kBase, true>>{});
    case kBaseFromM3:
      return run(phases::Plan<Move<kM3, kBase, false>>{});
    case kBaseFromConjM3:
      return run(phases::Plan<Move<kM3, kBase, true>>{});
    case kBaseFromF2:
      return run(phases::Plan<Move<kF2, kBase, false>>{});
    case kF2FromAcc:
      return run(phases::Plan<Move<kAcc, kF2, false>>{});
    case kM3FromAcc:
      return run(phases::Plan<Move<kAcc, kM3, false>>{});
    default:
      return false;
  }
}

// The whole final exponentiation on one lane whose f is loaded at kT; the
// result is at kAcc.  One loop over the program, each step's plans in
// one place.
template <class Run>
FP384_FN bool run_program(const Run& run) {
  bool ok = true;
  FP384_ROLLED
  for (int i = 0;; ++i) {
    const int step = step_at(i);
    if ((step & 0xff) == kEnd) return ok;
    ok = run_step(run, step) && ok;
  }
}

constexpr int kThreads =
    phases::block_threads<Mul::Plan, Inverse, Frob<1>, cyclo::Square>();

}  // namespace final_exp
