// Jacobian points over Fp (G1) or Fp2 (the G2 twist), as plans of phases
// fixed at compile time (phases.cuh): the step of harmony_tpu/ops/curve.py
// scalar_mul (namespace ladder), which scalar_mul.cu runs on one block per
// lane, and the add of its masked_sum (namespace sum), which
// g2_masked_sum.cu runs on two warps an add, with the tree's partition
// over blocks; the host tests (tests/test_torch_scalar_mul_host.py,
// tests/test_torch_g2_sum_host.py) run the same plans under g++.
//
// A Jacobian point's limbs depend on the formula that made it, so the
// values here are the reference's: dbl-2009-l for the doubling,
// add-2007-bl for the addition, and curve.py add's select cascade in its
// order (equal X and Y gives the doubling, where the caller asks for it;
// then equal X and opposite Y gives (1, 1, 0); then p1 at infinity gives
// p2; then p2 at infinity gives p1).  How a value is formed does not
// matter: every element is canonical, so any correct formula for the
// same field value gives the same words.
//
// The field is a template parameter (Fp or Fp2 below), so G1 and G2 share
// one plan.  A field value is kE consecutive elements of the scratch area
// (12 words each, fp12::ld/st); a product's Montgomery products go to
// elements of their own and a phase of adds forms the value from them.
// Both plans are rounds of uniform products: each product task loads its
// two operands and stores to a third element, by a table, so that the
// card runs every round through one copy of the product code; each round
// is followed by one phase of adds, a task per component, which forms the
// values and the next round's operands.
//
// Constant time: the scalar multiplication sees secret keys.  Its step
// computes the doubling and the addition whatever the bit, every phase and
// every product in the same order; the bit, the flags of the cascade
// (which depend on the key: the accumulator is at infinity until the first
// set bit) and the result are combined by masks of all ones or all zeros,
// never by a branch; no value is inverted.  Only the masked sum (public
// signatures) branches on its data, to run the doubling where an add's
// operands are equal.

#pragma once

#include <cstdint>
#include <tuple>

#include "phases.cuh"

#if !defined(HARMONY_ONE_MONT_WORDS)
#error "build through harmony_tpu_torch/kernels/_build.py, which defines 1 R"
#endif

namespace jac {

using fp12::ld;
using fp12::st;
using fp384::kWords;

// --- the fields: a value is kE elements ------------------------------------

struct Fp {
  static constexpr int kE = 1;
};

struct Fp2 {
  static constexpr int kE = 2;
};

// --- masks: selects without a branch ----------------------------------------

// All ones where c, else 0.
FP384_FN uint32_t mask(bool c) { return 0u - static_cast<uint32_t>(c); }

// w = a where m is all ones; w unchanged where m is 0.
FP384_FN void pick(uint32_t m, const uint32_t a[kWords], uint32_t w[kWords]) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) w[j] = (a[j] & m) | (w[j] & ~m);
}

// Element k of the point at infinity (1, 1, 0) of field F: 1 (in the
// Montgomery domain) as the first element of X and of Y, 0 elsewhere.
template <class F>
FP384_FN void infinity_element(int k, uint32_t w[kWords]) {
  constexpr uint32_t one[kWords] = {HARMONY_ONE_MONT_WORDS};
  const bool is_one = k == 0 || k == F::kE;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) w[j] = is_one ? one[j] : 0u;
}

// --- scalar_mul's ladder: a step in six rounds of uniform products ---------
//
// The step computes acc = 2 acc, then acc + pt where the bit is set: the
// same field values as dbl-2009-l, add-2007-bl and the select cascade
// (the top of this file), on a plan of its own, so that the card runs
// every round of products through one copy of the product code
// (scalar_mul.cu):
//  - Every product task loads x and y from two elements and stores the
//    product in a third, by a table (ladder::Table): no task forms an
//    operand.  Over Fp2 the products are schoolbook (a b from a0 b0, a1 b1,
//    a0 b1, a1 b0; a^2 from a0^2, a1^2, a0 a1), so no operand needs a sum;
//    a value that is only an operand may be left below 2p (add_lazy), which
//    the split product takes.  Every stored value that is not only an
//    operand is canonical.
//  - The addition's second point is the lane's base point, the same every
//    step: the setup forms 2 Z2, Z2^2 and Z2^3 once, and Z1 Z2 (2 Z2)
//    takes the place of (Z1 + Z2)^2 - Z1^2 - Z2^2 (the same field value).
//  - The addition's first round runs beside the doubling's second, its
//    second beside the doubling's third:
//      round  products (Fp2: 10, 16, 16, 15, 11, 8; Fp: 3, 5, 4, 4, 3, 2)
//      1      A = X^2, B = Y^2, Y Z
//      2      C = B^2, T = (X + B)^2, F = E^2 (E = 3A); Z1^2, Z1 (2 Z2)
//             (Z1 = 2 Y Z)
//      3      E (D - X3); U1 = X1 Z2^2, U2 = X2 Z1^2, Z1 Z1^2 (X1: the
//             doubling's X3)
//      4      S1 = Y1 Z2^3, S2 = Y2 Z1^3, I = (2H)^2, Z3 = Z1 (2 Z2) H (Y1:
//             the doubling's Y3 = E (D - X3) - 8C)
//      5      J = H I, V = U1 I, R^2
//      6      R (V - X3), S1 J (X3: the addition's)
//    each followed by one phase of adds; the last forms Y3 and the selects
//    (curve.py add's, from flags the phases of adds wrote once) into acc: 12
//    phases a step.
//  - A phase of adds has one task per component (Fp2: 2), each doing the
//    component's whole work, and the selects one a coordinate and
//    component; scalar_mul.cu runs component c on warp c, so a branch on
//    the component never splits a warp.

namespace ladder {

constexpr int kRounds = 8;     // six a step, then the setup's two
constexpr int kStepRounds = 6;
constexpr int kMostTasks = 16;

// Montgomery products of a product and of a square, by field.
template <class F>
constexpr int kMulOut = F::kE == 1 ? 1 : 4;
template <class F>
constexpr int kSqrOut = F::kE == 1 ? 1 : 3;

// Component c of the product (kSquare: the square) whose Montgomery
// products are at r: over Fp2, r0 - r1, and r2 + r3 (r2 + r2 for a square).
template <class F, bool kSquare>
FP384_FN void value(const uint32_t* s, int r, int c, uint32_t out[kWords]) {
  if constexpr (F::kE == 1) {
    ld(s, r, out);
  } else {
    uint32_t u[kWords], v[kWords];
    if (c == 0) {
      ld(s, r, u);
      ld(s, r + 1, v);
      phases::sub(u, v, out);
    } else {
      ld(s, r + 2, u);
      ld(s, kSquare ? r + 2 : r + 3, v);
      phases::add(u, v, out);
    }
  }
}

FP384_FN bool zero(const uint32_t w[kWords]) {
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) any |= w[j];
  return any == 0;
}

// A lane's scratch area, in elements: the accumulator, the base point,
// the doubled accumulator (the addition's first point), the flags, the
// setup's values and each round's products and values.  The flags are one
// element of words: the step's bit mask, then, a word per component, a
// mask of Z2 = 0, of Z1 = 0, of H = 0 and of R = 0 (all ones where that
// component is 0), each written by its component's task; a value is 0
// where all its components' words are.
template <class F>
struct Slots {
  static constexpr int E = F::kE, M = kMulOut<F>, Q = kSqrOut<F>;
  static constexpr int kAcc = 0, kBase = 3 * E, kD = 6 * E, kFlags = 9 * E,
                       kW2 = kFlags + 1, kZ2Z2 = kW2 + E, kZ2C = kZ2Z2 + E,
                       // round 1 and its adds
                       kAp = kZ2C + E, kBp = kAp + Q, kYZp = kBp + Q,
                       kA = kYZp + M, kB = kA + E, kXB = kB + E, kE3 = kXB + E,
                       // round 2
                       kCp = kE3 + E, kTp = kCp + Q, kFp = kTp + Q,
                       kZ1Z1p = kFp + Q, kZZ3p = kZ1Z1p + Q, kC8 = kZZ3p + M,
                       kDX = kC8 + E, kZ1Z1 = kDX + E, kZZ3 = kZ1Z1 + E,
                       // round 3
                       kEDXp = kZZ3 + E, kU1p = kEDXp + M, kU2p = kU1p + M,
                       kZ1Cp = kU2p + M, kU1 = kZ1Cp + M, kH = kU1 + E,
                       kH2 = kH + E, kZ1C = kH2 + E,
                       // round 4
                       kS1p = kZ1C + E, kS2p = kS1p + M, kIp = kS2p + M,
                       kZ3p = kIp + Q, kS1 = kZ3p + M, kR = kS1 + E,
                       kI = kR + E, kAZ = kI + E,
                       // round 5
                       kJp = kAZ + E, kVp = kJp + M, kRRp = kVp + M,
                       kJ = kRRp + Q, kAX = kJ + E, kVX = kAX + E,
                       // round 6
                       kRVXp = kVX + E, kS1Jp = kRVXp + M, kEnd = kS1Jp + M,
                       // the setup's products, before any step
                       kZ2Z2p = kAp, kZ2Cp = kZ2Z2p + Q;
  // words of kFlags
  static constexpr int kBit = 0, kInf2 = 1, kInf1 = 3, kHZero = 5,
                       kRZero = 7;
};

// The product tasks of every round: element x times element y into out.
struct Task {
  int x, y, out;
};

struct Table {
  Task task[kRounds][kMostTasks];
  int n[kRounds];
};

template <class F>
struct Filler {
  Table t{};
  int r = 0;

  constexpr void put(int x, int y, int out) {
    t.task[r][t.n[r]++] = Task{x, y, out};
  }
  constexpr void mul(int a, int b, int out) {
    put(a, b, out);
    if constexpr (F::kE == 2) {
      put(a + 1, b + 1, out + 1);
      put(a, b + 1, out + 2);
      put(a + 1, b, out + 3);
    }
  }
  constexpr void sqr(int a, int out) {
    put(a, a, out);
    if constexpr (F::kE == 2) {
      put(a + 1, a + 1, out + 1);
      put(a, a + 1, out + 2);
    }
  }
};

template <class F>
constexpr Table make_table() {
  using S = Slots<F>;
  constexpr int E = F::kE;
  Filler<F> b{};
  b.r = 0;
  b.sqr(S::kAcc, S::kAp);
  b.sqr(S::kAcc + E, S::kBp);
  b.mul(S::kAcc + E, S::kAcc + 2 * E, S::kYZp);
  b.r = 1;
  b.sqr(S::kB, S::kCp);
  b.sqr(S::kXB, S::kTp);
  b.sqr(S::kE3, S::kFp);
  b.sqr(S::kD + 2 * E, S::kZ1Z1p);
  b.mul(S::kD + 2 * E, S::kW2, S::kZZ3p);
  b.r = 2;
  b.mul(S::kE3, S::kDX, S::kEDXp);
  b.mul(S::kD, S::kZ2Z2, S::kU1p);
  b.mul(S::kBase, S::kZ1Z1, S::kU2p);
  b.mul(S::kD + 2 * E, S::kZ1Z1, S::kZ1Cp);
  b.r = 3;
  b.mul(S::kD + E, S::kZ2C, S::kS1p);
  b.mul(S::kBase + E, S::kZ1C, S::kS2p);
  b.sqr(S::kH2, S::kIp);
  b.mul(S::kZZ3, S::kH, S::kZ3p);
  b.r = 4;
  b.mul(S::kH, S::kI, S::kJp);
  b.mul(S::kU1, S::kI, S::kVp);
  b.sqr(S::kR, S::kRRp);
  b.r = 5;
  b.mul(S::kR, S::kVX, S::kRVXp);
  b.mul(S::kS1, S::kJ, S::kS1Jp);
  b.r = 6;  // the setup
  b.sqr(S::kBase + 2 * E, S::kZ2Z2p);
  b.r = 7;
  b.mul(S::kBase + 2 * E, S::kZ2Z2, S::kZ2Cp);
  return b.t;
}

// Round R of the table as a phase of products (the host runs these; the
// card runs the same table through one product site, scalar_mul.cu).
template <class F, int R>
struct Round : phases::Products<make_table<F>().n[R]> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    constexpr Table t = make_table<F>();
    ld(s, t.task[R][k].x, x);
    ld(s, t.task[R][k].y, y);
    return t.task[R][k].out;
  }
};

// A phase of adds with one task per component: Body::run(c, s).
template <class F, class Body>
struct PerComponent : phases::Linear<F::kE> {
  static FP384_FN void task(int k, uint32_t* s) { Body::run(k, s); }
};

template <class F>
FP384_FN void flag(uint32_t* s, int word, const uint32_t w[kWords]) {
  s[Slots<F>::kFlags * kWords + word] = mask(zero(w));
}

// The setup: 2 Z2 (an operand only: below 2p) and Z2 = 0; then Z2^2 and
// Z2^3 from their products.
template <class F>
struct SetupW2 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t z[kWords], w[kWords];
    ld(s, S::kBase + 2 * F::kE + c, z);
    phases::add_lazy(z, z, w);
    st(s, S::kW2 + c, w);
    flag<F>(s, S::kInf2 + c, z);
  }
};

template <class F, int From, int To, bool kSquare>
struct SetupValue {
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t w[kWords];
    value<F, kSquare>(s, From, c, w);
    st(s, To + c, w);
  }
};

// After round 1: A, B, X + B (an operand), E = 3A (an operand), Z1 = 2 Y Z.
template <class F>
struct Adds1 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t a[kWords], b[kWords], t[kWords], u[kWords];
    value<F, true>(s, S::kAp, c, a);
    st(s, S::kA + c, a);
    value<F, true>(s, S::kBp, c, b);
    st(s, S::kB + c, b);
    ld(s, S::kAcc + c, t);
    phases::add_lazy(t, b, u);
    st(s, S::kXB + c, u);
    phases::add(a, a, t);
    phases::add_lazy(t, a, u);
    st(s, S::kE3 + c, u);
    value<F, false>(s, S::kYZp, c, t);
    phases::add(t, t, u);
    st(s, S::kD + 2 * F::kE + c, u);
    flag<F>(s, S::kInf1 + c, u);
  }
};

// After round 2: X3 = (F - 4T) + 4 (A + C), D - X3 with D = 2 (T - (A + C)),
// 8C; Z1^2; Z1 (2 Z2).
template <class F>
struct Adds2 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t a[kWords], cc[kWords], t[kWords], f[kWords], ac[kWords],
        d[kWords], u[kWords], w[kWords];
    value<F, true>(s, S::kCp, c, cc);
    value<F, true>(s, S::kTp, c, t);
    value<F, true>(s, S::kFp, c, f);
    ld(s, S::kA + c, a);
    phases::add(a, cc, ac);
    phases::sub(t, ac, u);
    phases::add(u, u, d);  // D
    phases::add(t, t, u);
    phases::add(u, u, u);
    phases::sub(f, u, f);  // F - 4T
    phases::add(ac, ac, u);
    phases::add(u, u, u);
    phases::add(f, u, w);  // X3
    st(s, S::kD + c, w);
    phases::sub(d, w, u);
    st(s, S::kDX + c, u);
    phases::add(cc, cc, u);
    phases::add(u, u, u);
    phases::add(u, u, u);
    st(s, S::kC8 + c, u);
    value<F, true>(s, S::kZ1Z1p, c, u);
    st(s, S::kZ1Z1 + c, u);
    value<F, false>(s, S::kZZ3p, c, u);
    st(s, S::kZZ3 + c, u);
  }
};

// After round 3: Y1 = E (D - X3) - 8C, U1, H = U2 - U1, 2H (an operand),
// Z1^3.
template <class F>
struct Adds3 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t u[kWords], v[kWords], w[kWords];
    value<F, false>(s, S::kEDXp, c, u);
    ld(s, S::kC8 + c, v);
    phases::sub(u, v, w);
    st(s, S::kD + F::kE + c, w);
    value<F, false>(s, S::kU1p, c, u);
    st(s, S::kU1 + c, u);
    value<F, false>(s, S::kU2p, c, v);
    phases::sub(v, u, w);
    st(s, S::kH + c, w);
    flag<F>(s, S::kHZero + c, w);
    phases::add_lazy(w, w, u);
    st(s, S::kH2 + c, u);
    value<F, false>(s, S::kZ1Cp, c, u);
    st(s, S::kZ1C + c, u);
  }
};

// After round 4: S1, R = 2 (S2 - S1), I, Z3.
template <class F>
struct Adds4 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t u[kWords], v[kWords], w[kWords];
    value<F, false>(s, S::kS1p, c, u);
    st(s, S::kS1 + c, u);
    value<F, false>(s, S::kS2p, c, v);
    phases::sub(v, u, w);
    phases::add(w, w, w);
    st(s, S::kR + c, w);
    flag<F>(s, S::kRZero + c, w);
    value<F, true>(s, S::kIp, c, u);
    st(s, S::kI + c, u);
    value<F, false>(s, S::kZ3p, c, u);
    st(s, S::kAZ + c, u);
  }
};

// After round 5: J, X3 = (R^2 - J) - 2V, V - X3.
template <class F>
struct Adds5 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t j[kWords], v[kWords], t[kWords], u[kWords];
    value<F, false>(s, S::kJp, c, j);
    st(s, S::kJ + c, j);
    value<F, false>(s, S::kVp, c, v);
    value<F, true>(s, S::kRRp, c, t);
    phases::sub(t, j, t);
    phases::add(v, v, u);
    phases::sub(t, u, t);
    st(s, S::kAX + c, t);
    phases::sub(v, t, u);
    st(s, S::kVX + c, u);
  }
};

// After round 6, element k of 3 kE (X, Y, Z) of the new accumulator: the
// addition's (Y3 = R (V - X3) - 2 S1 J), then curve.py add's cascade from the
// flags, then the doubled point where the bit's mask is 0.
template <class F>
struct Out : phases::Linear<3 * F::kE> {
  using S = Slots<F>;
  static FP384_FN uint32_t all(const uint32_t* s, int word) {
    uint32_t m = ~0u;
    FP384_UNROLL
    for (int c = 0; c < F::kE; ++c) m &= s[S::kFlags * kWords + word + c];
    return m;
  }
  static FP384_FN void task(int k, uint32_t* s) {
    const int e = k / F::kE, c = k % F::kE;
    uint32_t w[kWords], t[kWords], u[kWords];
    if (e == 1) {
      value<F, false>(s, S::kRVXp, c, w);
      value<F, false>(s, S::kS1Jp, c, t);
      phases::add(t, t, u);
      phases::sub(w, u, w);
    } else {
      ld(s, e == 0 ? S::kAX + c : S::kAZ + c, w);
    }
    const uint32_t inf1 = all(s, S::kInf1), inf2 = all(s, S::kInf2);
    const uint32_t same_x = all(s, S::kHZero) & ~inf1 & ~inf2;
    const uint32_t same_y = all(s, S::kRZero);
    infinity_element<F>(k, t);
    pick(same_x & ~same_y, t, w);
    ld(s, S::kBase + k, t);
    pick(inf1, t, w);
    ld(s, S::kD + k, t);
    pick(inf2 & ~inf1, t, w);
    const uint32_t bit = s[S::kFlags * kWords + S::kBit];
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) w[j] = (w[j] & bit) | (t[j] & ~bit);
    st(s, S::kAcc + k, w);
  }
};

template <class F>
using Adds = std::tuple<PerComponent<F, Adds1<F>>, PerComponent<F, Adds2<F>>,
                        PerComponent<F, Adds3<F>>, PerComponent<F, Adds4<F>>,
                        PerComponent<F, Adds5<F>>, Out<F>>;

// The phase of adds after step round r.
template <class F, int R>
using AddsAfter = typename std::tuple_element<R, Adds<F>>::type;

template <class F>
constexpr int most_threads() {
  constexpr Table t = make_table<F>();
  int m = F::kE * 32;  // the phases of adds: a warp a component
  for (int r = 0; r < kRounds; ++r) {
    m = t.n[r] * split::kGroup > m ? t.n[r] * split::kGroup : m;
  }
  return (m + 31) / 32 * 32;
}

}  // namespace ladder

// A lane's ladder (scalar_mul.cu): the caller puts the base point and
// (1, 1, 0) in place and runs Setup once; then, for each bit, writes its
// mask (all ones for a bit of 1) to word kBitWord and runs Step.
template <class F>
struct Ladder {
  using S = ladder::Slots<F>;
  static constexpr int kAcc = S::kAcc, kBase = S::kBase,
                       kBitWord = S::kFlags * kWords + S::kBit;
  using Setup = phases::Plan<
      ladder::PerComponent<F, ladder::SetupW2<F>>, ladder::Round<F, 6>,
      ladder::PerComponent<F, ladder::SetupValue<F, S::kZ2Z2p, S::kZ2Z2,
                                                 true>>,
      ladder::Round<F, 7>,
      ladder::PerComponent<F, ladder::SetupValue<F, S::kZ2Cp, S::kZ2C,
                                                 false>>>;
  using Step = phases::Plan<
      ladder::Round<F, 0>, ladder::AddsAfter<F, 0>, ladder::Round<F, 1>,
      ladder::AddsAfter<F, 1>, ladder::Round<F, 2>, ladder::AddsAfter<F, 2>,
      ladder::Round<F, 3>, ladder::AddsAfter<F, 3>, ladder::Round<F, 4>,
      ladder::AddsAfter<F, 4>, ladder::Round<F, 5>, ladder::AddsAfter<F, 5>>;
  static constexpr int kPhases = 2 * ladder::kStepRounds;
  static constexpr int kScratch = S::kEnd;
  static constexpr int kThreads = ladder::most_threads<F>();
};

// --- masked_sum's add: p1 + p2 in five rounds of uniform products -----------
//
// curve.py add (handle_equal=True) on a plan of the ladder's kind, so that
// g2_masked_sum.cu runs every round of every add through one product site:
//  - Every product task only loads its operands, by a table (make_table:
//    rounds 0-4 the addition's, 5-7 the doubling's); Fp2 products are
//    schoolbook, as the ladder's.  With 16 groups of four threads an add,
//    every round is one pass whatever its products, so Karatsuba's fewer
//    products would save no pass and need operand sums.
//  - Z1 Z2, doubled, takes the place of (Z1 + Z2)^2 - Z1^2 - Z2^2 (the
//    same field value):
//      round  products (Fp2: 10, 16, 15, 11, 8; Fp: 3, 4, 4, 3, 2)
//      1      Z1^2, Z2^2, Z1 Z2
//      2      U1 = X1 Z2^2, U2 = X2 Z1^2, Z2^3 = Z2 Z2^2, Z1^3 = Z1 Z1^2
//      3      S1 = Y1 Z2^3, S2 = Y2 Z1^3, I = (2H)^2, Z3 = (2 Z1 Z2) H
//      4      J = H I, V = U1 I, R^2
//      5      R (V - X3), S1 J
//    each of the first four followed by one phase of adds (the values, the
//    flags, the next round's operands); a task loads all it reads before
//    its first store, which a later load could not pass.
//  - Where X and Y are equal (H = 0 and R = 0, both finite: a signature
//    twice), the doubling of p1 runs after round 5: the ladder's rounds
//    1-3 of dbl-2009-l (Fp2: 10, 9, 4 products), each followed by its
//    adds.  The data are public signatures, so this is a branch.
//  - Then one phase forms Y3 = R (V - X3) - 2 S1 J and the result with the
//    select cascade, in place of p1, a task a coordinate and component.

namespace sum {

constexpr int kRounds = 8;  // the addition's 5, then the doubling's 3
constexpr int kAddRounds = 5;
constexpr int kDblRound = 5;
// What g2_masked_sum.cu's block sums: 4 leaves (or partials), 2 adds on
// the first level, 128 threads (why: g2_masked_sum.cu).
constexpr int kBlockLeaves = 4;

// One add's scratch area, in elements: p1 (where the result goes), p2,
// the doubling of p1, the flags (a word per component: all ones where
// that component of Z1, of Z2, of H or of R is 0), each round's products
// and values, the doubling's last.
template <class F>
struct Slots {
  static constexpr int E = F::kE, M = ladder::kMulOut<F>,
                       Q = ladder::kSqrOut<F>;
  static constexpr int kP1 = 0, kP2 = 3 * E, kDbl = 6 * E, kFlags = 9 * E,
                       // round 1 and its adds
                       kZ1Z1p = kFlags + 1, kZ2Z2p = kZ1Z1p + Q,
                       kZ1Z2p = kZ2Z2p + Q, kZ1Z1 = kZ1Z2p + M,
                       kZ2Z2 = kZ1Z1 + E, kZZ3 = kZ2Z2 + E,
                       // round 2
                       kU1p = kZZ3 + E, kU2p = kU1p + M, kZ2Cp = kU2p + M,
                       kZ1Cp = kZ2Cp + M, kU1 = kZ1Cp + M, kH = kU1 + E,
                       kH2 = kH + E, kZ2C = kH2 + E, kZ1C = kZ2C + E,
                       // round 3
                       kS1p = kZ1C + E, kS2p = kS1p + M, kIp = kS2p + M,
                       kZ3p = kIp + Q, kS1 = kZ3p + M, kR = kS1 + E,
                       kI = kR + E, kAZ = kI + E,
                       // round 4
                       kJp = kAZ + E, kVp = kJp + M, kRRp = kVp + M,
                       kJ = kRRp + Q, kAX = kJ + E, kVX = kAX + E,
                       // round 5
                       kRVXp = kVX + E, kS1Jp = kRVXp + M,
                       // the doubling of p1
                       kDAp = kS1Jp + M, kDBp = kDAp + Q, kDYZp = kDBp + Q,
                       kDA = kDYZp + M, kDB = kDA + E, kDXB = kDB + E,
                       kDE3 = kDXB + E, kDCp = kDE3 + E, kDTp = kDCp + Q,
                       kDFp = kDTp + Q, kDDX = kDFp + Q, kDC8 = kDDX + E,
                       kDEDXp = kDC8 + E, kEnd = kDEDXp + M;
  // words of kFlags
  static constexpr int kInf1 = 0, kInf2 = 2, kHZero = 4, kRZero = 6;
};

template <class F>
constexpr ladder::Table make_table() {
  using S = Slots<F>;
  constexpr int E = F::kE;
  ladder::Filler<F> b{};
  b.r = 0;
  b.sqr(S::kP1 + 2 * E, S::kZ1Z1p);
  b.sqr(S::kP2 + 2 * E, S::kZ2Z2p);
  b.mul(S::kP1 + 2 * E, S::kP2 + 2 * E, S::kZ1Z2p);
  b.r = 1;
  b.mul(S::kP1, S::kZ2Z2, S::kU1p);
  b.mul(S::kP2, S::kZ1Z1, S::kU2p);
  b.mul(S::kP2 + 2 * E, S::kZ2Z2, S::kZ2Cp);
  b.mul(S::kP1 + 2 * E, S::kZ1Z1, S::kZ1Cp);
  b.r = 2;
  b.mul(S::kP1 + E, S::kZ2C, S::kS1p);
  b.mul(S::kP2 + E, S::kZ1C, S::kS2p);
  b.sqr(S::kH2, S::kIp);
  b.mul(S::kZZ3, S::kH, S::kZ3p);
  b.r = 3;
  b.mul(S::kH, S::kI, S::kJp);
  b.mul(S::kU1, S::kI, S::kVp);
  b.sqr(S::kR, S::kRRp);
  b.r = 4;
  b.mul(S::kR, S::kVX, S::kRVXp);
  b.mul(S::kS1, S::kJ, S::kS1Jp);
  b.r = kDblRound;  // the doubling of p1
  b.sqr(S::kP1, S::kDAp);
  b.sqr(S::kP1 + E, S::kDBp);
  b.mul(S::kP1 + E, S::kP1 + 2 * E, S::kDYZp);
  b.r = kDblRound + 1;
  b.sqr(S::kDB, S::kDCp);
  b.sqr(S::kDXB, S::kDTp);
  b.sqr(S::kDE3, S::kDFp);
  b.r = kDblRound + 2;
  b.mul(S::kDE3, S::kDDX, S::kDEDXp);
  return b.t;
}

static_assert(kRounds == ladder::kRounds, "the ladder's table holds them");

// Round R of the table as a phase of products (the host runs these; the
// card runs the same table through one product site, g2_masked_sum.cu).
template <class F, int R>
struct Round : phases::Products<make_table<F>().n[R]> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    constexpr ladder::Table t = make_table<F>();
    ld(s, t.task[R][k].x, x);
    ld(s, t.task[R][k].y, y);
    return t.task[R][k].out;
  }
};

template <class F>
FP384_FN void flag(uint32_t* s, int word, const uint32_t w[kWords]) {
  s[Slots<F>::kFlags * kWords + word] = mask(ladder::zero(w));
}

// A flag of the add: all ones where every component's word is.
template <class F>
FP384_FN uint32_t all(const uint32_t* s, int word) {
  uint32_t m = ~0u;
  FP384_UNROLL
  for (int c = 0; c < F::kE; ++c) m &= s[Slots<F>::kFlags * kWords + word + c];
  return m;
}

// After round 1: Z1^2, Z2^2, 2 Z1 Z2 (an operand: below 2p); Z1 = 0 and
// Z2 = 0.
template <class F>
struct Adds1 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t a[kWords], b[kWords], u[kWords], v[kWords], z1[kWords],
        z2[kWords];
    ladder::value<F, true>(s, S::kZ1Z1p, c, a);
    ladder::value<F, true>(s, S::kZ2Z2p, c, b);
    ladder::value<F, false>(s, S::kZ1Z2p, c, u);
    ld(s, S::kP1 + 2 * F::kE + c, z1);
    ld(s, S::kP2 + 2 * F::kE + c, z2);
    phases::add_lazy(u, u, v);
    st(s, S::kZ1Z1 + c, a);
    st(s, S::kZ2Z2 + c, b);
    st(s, S::kZZ3 + c, v);
    flag<F>(s, S::kInf1 + c, z1);
    flag<F>(s, S::kInf2 + c, z2);
  }
};

// After round 2: U1, H = U2 - U1 and H = 0, 2H (an operand), Z2^3, Z1^3.
template <class F>
struct Adds2 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t u1[kWords], u2[kWords], z2c[kWords], z1c[kWords], h[kWords],
        h2[kWords];
    ladder::value<F, false>(s, S::kU1p, c, u1);
    ladder::value<F, false>(s, S::kU2p, c, u2);
    ladder::value<F, false>(s, S::kZ2Cp, c, z2c);
    ladder::value<F, false>(s, S::kZ1Cp, c, z1c);
    phases::sub(u2, u1, h);
    phases::add_lazy(h, h, h2);
    st(s, S::kU1 + c, u1);
    st(s, S::kH + c, h);
    st(s, S::kH2 + c, h2);
    st(s, S::kZ2C + c, z2c);
    st(s, S::kZ1C + c, z1c);
    flag<F>(s, S::kHZero + c, h);
  }
};

// After round 3: S1, R = 2 (S2 - S1) and R = 0, I, Z3.
template <class F>
struct Adds3 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t s1[kWords], s2[kWords], i[kWords], z3[kWords], r[kWords];
    ladder::value<F, false>(s, S::kS1p, c, s1);
    ladder::value<F, false>(s, S::kS2p, c, s2);
    ladder::value<F, true>(s, S::kIp, c, i);
    ladder::value<F, false>(s, S::kZ3p, c, z3);
    phases::sub(s2, s1, r);
    phases::add(r, r, r);
    st(s, S::kS1 + c, s1);
    st(s, S::kR + c, r);
    st(s, S::kI + c, i);
    st(s, S::kAZ + c, z3);
    flag<F>(s, S::kRZero + c, r);
  }
};

// After round 4: J, X3 = (R^2 - J) - 2V, V - X3.
template <class F>
struct Adds4 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t j[kWords], v[kWords], t[kWords], u[kWords];
    ladder::value<F, false>(s, S::kJp, c, j);
    ladder::value<F, false>(s, S::kVp, c, v);
    ladder::value<F, true>(s, S::kRRp, c, t);
    phases::sub(t, j, t);
    phases::add(v, v, u);
    phases::sub(t, u, t);
    st(s, S::kJ + c, j);
    st(s, S::kAX + c, t);
    phases::sub(v, t, u);
    st(s, S::kVX + c, u);
  }
};

// The doubling's first round's adds: A = X^2, B = Y^2, X + B and E = 3A
// (operands), Z3 = 2 Y Z.
template <class F>
struct Dbl1 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t a[kWords], b[kWords], x[kWords], yz[kWords], t[kWords],
        u[kWords];
    ladder::value<F, true>(s, S::kDAp, c, a);
    ladder::value<F, true>(s, S::kDBp, c, b);
    ladder::value<F, false>(s, S::kDYZp, c, yz);
    ld(s, S::kP1 + c, x);
    st(s, S::kDA + c, a);
    st(s, S::kDB + c, b);
    phases::add_lazy(x, b, u);
    st(s, S::kDXB + c, u);
    phases::add(a, a, t);
    phases::add_lazy(t, a, u);
    st(s, S::kDE3 + c, u);
    phases::add(yz, yz, u);
    st(s, S::kDbl + 2 * F::kE + c, u);
  }
};

// Its second: X3 = (F - 4T) + 4 (A + C), D - X3 with D = 2 (T - (A + C)),
// 8C.
template <class F>
struct Dbl2 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t a[kWords], cc[kWords], t[kWords], f[kWords], ac[kWords],
        d[kWords], u[kWords], w[kWords];
    ladder::value<F, true>(s, S::kDCp, c, cc);
    ladder::value<F, true>(s, S::kDTp, c, t);
    ladder::value<F, true>(s, S::kDFp, c, f);
    ld(s, S::kDA + c, a);
    phases::add(a, cc, ac);
    phases::sub(t, ac, u);
    phases::add(u, u, d);  // D
    phases::add(t, t, u);
    phases::add(u, u, u);
    phases::sub(f, u, f);  // F - 4T
    phases::add(ac, ac, u);
    phases::add(u, u, u);
    phases::add(f, u, w);  // X3
    st(s, S::kDbl + c, w);
    phases::sub(d, w, u);
    st(s, S::kDDX + c, u);
    phases::add(cc, cc, u);
    phases::add(u, u, u);
    phases::add(u, u, u);
    st(s, S::kDC8 + c, u);
  }
};

// Its third: Y3 = E (D - X3) - 8C.
template <class F>
struct Dbl3 {
  using S = Slots<F>;
  static FP384_FN void run(int c, uint32_t* s) {
    uint32_t u[kWords], v[kWords], w[kWords];
    ladder::value<F, false>(s, S::kDEDXp, c, u);
    ld(s, S::kDC8 + c, v);
    phases::sub(u, v, w);
    st(s, S::kDbl + F::kE + c, w);
  }
};

// Whether the add's operands are equal: H = 0 and R = 0, both finite.
template <class F>
FP384_FN bool doubles(const uint32_t* s) {
  using S = Slots<F>;
  const uint32_t inf = all<F>(s, S::kInf1) | all<F>(s, S::kInf2);
  return (all<F>(s, S::kHZero) & all<F>(s, S::kRZero) & ~inf) != 0;
}

// After round 5 (and the doubling), element k of 3 kE (X, Y, Z) of the
// result, into p1's: the addition's (Y3 = R (V - X3) - 2 S1 J), then the
// cascade from the flags.  The doubling's point is read where it did not
// run too, and then never picked.
template <class F>
struct Out : phases::Linear<3 * F::kE> {
  using S = Slots<F>;
  static FP384_FN void task(int k, uint32_t* s) {
    const int e = k / F::kE, c = k % F::kE;
    uint32_t w[kWords], t[kWords], u[kWords];
    if (e == 1) {
      ladder::value<F, false>(s, S::kRVXp, c, w);
      ladder::value<F, false>(s, S::kS1Jp, c, t);
      phases::add(t, t, u);
      phases::sub(w, u, w);
    } else {
      ld(s, e == 0 ? S::kAX + c : S::kAZ + c, w);
    }
    const uint32_t inf1 = all<F>(s, S::kInf1), inf2 = all<F>(s, S::kInf2);
    const uint32_t same_x = all<F>(s, S::kHZero) & ~inf1 & ~inf2;
    const uint32_t same_y = all<F>(s, S::kRZero);
    ld(s, S::kDbl + k, t);
    pick(same_x & same_y, t, w);
    infinity_element<F>(k, t);
    pick(same_x & ~same_y, t, w);
    ld(s, S::kP2 + k, t);
    pick(inf1, t, w);
    ld(s, S::kP1 + k, t);
    pick(inf2 & ~inf1, t, w);
    st(s, S::kP1 + k, w);
  }
};

// The phase of adds after round R (0-3, and the doubling's 5-7).
template <class F, int R>
using AddsAfter = typename std::tuple_element<
    (R < kAddRounds ? R : R - kDblRound + 4),
    std::tuple<ladder::PerComponent<F, Adds1<F>>,
               ladder::PerComponent<F, Adds2<F>>,
               ladder::PerComponent<F, Adds3<F>>,
               ladder::PerComponent<F, Adds4<F>>,
               ladder::PerComponent<F, Dbl1<F>>,
               ladder::PerComponent<F, Dbl2<F>>,
               ladder::PerComponent<F, Dbl3<F>>>>::type;

template <class F>
using AddPlan =
    phases::Plan<Round<F, 0>, AddsAfter<F, 0>, Round<F, 1>, AddsAfter<F, 1>,
                 Round<F, 2>, AddsAfter<F, 2>, Round<F, 3>, AddsAfter<F, 3>,
                 Round<F, 4>>;
template <class F>
using DblPlan = phases::Plan<Round<F, 5>, AddsAfter<F, 5>, Round<F, 6>,
                             AddsAfter<F, 6>, Round<F, 7>, AddsAfter<F, 7>>;

// One add on scratch area s, p1 and p2 in place, the sum into p1, by a
// runner of plans (the host's): the addition, the doubling where the
// operands are equal, the result.
template <class F, class Run>
FP384_FN bool add(const Run& run, const uint32_t* s) {
  bool ok = run(AddPlan<F>{});
  if (doubles<F>(s)) ok = run(DblPlan<F>{}) && ok;
  return run(phases::Plan<Out<F>>{}) && ok;
}

// --- masked_sum's tree over blocks ------------------------------------------
//
// masked_sum adds point k + half into point k at each level, so for a
// power of two b that divides half, the points whose index is congruent
// to g mod b form a closed subtree, whose root is point g after the level
// where half = b.  A stage of the sum runs on `blocks` blocks: block g
// sums the inputs g, g + blocks, g + 2 blocks, ... (its `leaves`) by the
// same levels, in the same order, and leaves partial g.  Stage 0's inputs
// are the leaves; stage s + 1's are stage s's partials, and its block g
// is the block of stage s that finishes last among those whose partial is
// congruent to g mod its blocks.  The last stage has one block and gives
// the sum.  Each block sums at most `most` inputs.

struct Stage {
  int width;   // inputs: the leaves, or the partials of the stage before
  int blocks;  // blocks, and the partials they leave
  int leaves;  // inputs a block sums: width / blocks
};

FP384_FN Stage stage(int width, int most) {
  const int blocks = width > most ? width / most : 1;
  return Stage{width, blocks, width / blocks};
}

// What the sum of `size` leaves needs besides its blocks: a counter for
// each block of every stage after the first (the blocks of the stage
// before that have finished it), a partial point for each block of every
// stage but the last; and the most adds a block runs at once.
struct Needs {
  int counters, partials, adds;
};

FP384_FN Needs needs(int size, int most) {
  Needs n{0, 0, 1};
  Stage st = stage(size, most);
  for (;;) {
    if (st.leaves / 2 > n.adds) n.adds = st.leaves / 2;
    if (st.blocks == 1) return n;
    n.partials += st.blocks;
    st = stage(st.blocks, most);
    n.counters += st.blocks;
  }
}

}  // namespace sum

// The number of leaves: n padded to a power of two (1 for n <= 1), as
// masked_sum pads with infinity.
FP384_FN int leaves(int64_t n) {
  int size = 1;
  while (size < n) size *= 2;
  return size;
}

}  // namespace jac
