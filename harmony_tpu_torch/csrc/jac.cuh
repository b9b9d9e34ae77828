// Jacobian points over Fp (G1) or Fp2 (the G2 twist), as plans of phases
// fixed at compile time (phases.cuh): the doubling and the addition of
// harmony_tpu/ops/curve.py and the add of its masked_sum, which
// g2_masked_sum.cu runs on one warp per add, and the step of its
// scalar_mul (namespace ladder), which scalar_mul.cu runs on one block per
// lane; the host test (tests/test_torch_scalar_mul_host.py) runs the same
// plans under g++.
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
// elements of their own and a linear phase forms the value from them.
//
// The masked sum's add: Fp2 products are Karatsuba (3 Montgomery
// products), squares the complex method (2), as in miller.cuh, their
// operands formed by the round's tasks; the doubling is 3 rounds of
// products (Fp2: 7, 6, 3 Montgomery products; Fp: 3, 3, 1), each followed
// by a phase of adds; the addition is 5 rounds (Fp2: 6, 12, 11, 8, 6; Fp:
// 3, 4, 4, 3, 2) with 3 phases of adds between them, then one phase that
// forms the result and its selects.  The ladder's step: see namespace
// ladder below.
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

// --- the fields ------------------------------------------------------------

FP384_FN void copy(const uint32_t a[kWords], uint32_t out[kWords]) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) out[j] = a[j];
}

struct Fp {
  static constexpr int kE = 1;    // elements of a value
  static constexpr int kMul = 1;  // Montgomery products of a product
  static constexpr int kSqr = 1;  // and of a square (its value)

  // The operands of Montgomery product h of the product of the values at
  // a and b; of the square of the value at a; of the square of a + b.
  static FP384_FN void mul_operands(const uint32_t* s, int a, int b, int,
                                    uint32_t x[kWords], uint32_t y[kWords]) {
    ld(s, a, x);
    ld(s, b, y);
  }
  static FP384_FN void sqr_operands(const uint32_t* s, int a, int,
                                    uint32_t x[kWords], uint32_t y[kWords]) {
    ld(s, a, x);
    copy(x, y);
  }
  static FP384_FN void sqr_sum_operands(const uint32_t* s, int a, int b, int,
                                        uint32_t x[kWords],
                                        uint32_t y[kWords]) {
    uint32_t u[kWords], v[kWords];
    ld(s, a, u);
    ld(s, b, v);
    phases::add(u, v, x);
    copy(x, y);
  }
  // Component c of a product's value from its products at r.
  static FP384_FN void mul_value(const uint32_t* s, int r, int,
                                 uint32_t out[kWords]) {
    ld(s, r, out);
  }
};

struct Fp2 {
  static constexpr int kE = 2;
  static constexpr int kMul = 3;  // Karatsuba: a0 b0, a1 b1, (a0 + a1)(b0 + b1)
  static constexpr int kSqr = 2;  // (a0 + a1)(a0 - a1), a0 (a1 + a1)

  static FP384_FN void mul_operands(const uint32_t* s, int a, int b, int h,
                                    uint32_t x[kWords], uint32_t y[kWords]) {
    phases::kara(s, a, h, x);
    phases::kara(s, b, h, y);
  }
  static FP384_FN void sqr_operands(const uint32_t* s, int a, int c,
                                    uint32_t x[kWords], uint32_t y[kWords]) {
    phases::csqr(s, a, c, x, y);
  }
  static FP384_FN void sqr_sum_operands(const uint32_t* s, int a, int b,
                                        int c, uint32_t x[kWords],
                                        uint32_t y[kWords]) {
    uint32_t u0[kWords], u1[kWords];
    phases::ld_add(s, a, b, u0);
    phases::ld_add(s, a + 1, b + 1, u1);
    phases::csqr(u0, u1, c, x, y);
  }
  static FP384_FN void mul_value(const uint32_t* s, int r, int c,
                                 uint32_t out[kWords]) {
    phases::combine(s, r, c, out);
  }
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

// Whether the value at e is 0, reading all of it.
template <class F>
FP384_FN bool is_zero(const uint32_t* s, int e) {
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < F::kE * kWords; ++j) any |= s[e * kWords + j];
  return any == 0;
}

// --- the parts of a phase ---------------------------------------------------
//
// A round of products is Round<P...>, each P a field product whose kTasks
// Montgomery products take consecutive tasks; a phase of adds is
// Linears<L...>, each L kTasks tasks of its own (usually one a component).
// Task k of either is found by its place in the list.

template <class F, int A, int B, int Out>
struct Mul {  // the products of A B into Out ... Out + kMul - 1
  static constexpr int kTasks = F::kMul;
  static FP384_FN int operands(int h, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    F::mul_operands(s, A, B, h, x, y);
    return Out + h;
  }
};

template <class F, int A, int Out>
struct Sqr {  // A^2 into Out
  static constexpr int kTasks = F::kSqr;
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    F::sqr_operands(s, A, c, x, y);
    return Out + c;
  }
};

template <class F, int A, int B, int Out>
struct SqrSum {  // (A + B)^2 into Out
  static constexpr int kTasks = F::kSqr;
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    F::sqr_sum_operands(s, A, B, c, x, y);
    return Out + c;
  }
};

template <class P>
FP384_FN void operands_if(int& k, int& out, const uint32_t* s,
                          uint32_t x[kWords], uint32_t y[kWords]) {
  if (k >= 0 && k < P::kTasks) out = P::operands(k, s, x, y);
  k -= P::kTasks;
}

template <class... Ps>
struct Round : phases::Products<(Ps::kTasks + ...)> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    int out = -1;
    (operands_if<Ps>(k, out, s, x, y), ...);
    return out;
  }
};

template <class L>
FP384_FN void task_if(int& k, uint32_t* s) {
  if (k >= 0 && k < L::kTasks) L::task(k, s);
  k -= L::kTasks;
}

template <class... Ls>
struct Linears : phases::Linear<(Ls::kTasks + ...)> {
  static FP384_FN void task(int k, uint32_t* s) { (task_if<Ls>(k, s), ...); }
};

template <class F, int R, int V>
struct Value {  // V = the product at R
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t w[kWords];
    F::mul_value(s, R, c, w);
    st(s, V + c, w);
  }
};

template <class F, int R, int V>
struct TwiceValue {  // V = 2 (the product at R)
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t w[kWords], r[kWords];
    F::mul_value(s, R, c, w);
    phases::add(w, w, r);
    st(s, V + c, r);
  }
};

template <class F, int A, int B, int V>
struct Sum {  // V = A + B
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords];
    phases::ld_add(s, A + c, B + c, r);
    st(s, V + c, r);
  }
};

template <class F, int A, int V>
struct Triple {  // V = 3 A
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t a[kWords], t[kWords], r[kWords];
    ld(s, A + c, a);
    phases::add(a, a, t);
    phases::add(t, a, r);
    st(s, V + c, r);
  }
};

// --- the doubling: dbl-2009-l (curve.py dbl), the point at In into Out ------
//
//   round  products                       then
//   1      A = X^2, B = Y^2, Y Z           X + B, E = 3A, Z3 = 2 Y Z
//   2      C = B^2, T = (X + B)^2, E^2     D = 2 (T - A - C), X3 = E^2 - 2D,
//                                          D - X3
//   3      E (D - X3)                      Y3 = E (D - X3) - 8C
//
// Intermediates from element T on.

template <class F, int T>
struct DblSlots {
  static constexpr int E = F::kE, M = F::kMul;
  static constexpr int kA = T, kB = kA + E, kYZ = kB + E, kXB = kYZ + M,
                       kE3 = kXB + E, kC = kE3 + E, kTs = kC + E,
                       kF = kTs + E, kDX = kF + E, kEDX = kDX + E,
                       kEnd = kEDX + M;
};

template <class F, class S, int OutX>
struct DblX3 {  // D = 2 ((T - A) - C), X3 = E^2 - 2D, D - X3
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t t[kWords], u[kWords], d[kWords], x3[kWords];
    phases::ld_sub(s, S::kTs + c, S::kA + c, t);
    ld(s, S::kC + c, u);
    phases::sub(t, u, t);
    phases::add(t, t, d);
    phases::add(d, d, u);
    ld(s, S::kF + c, t);
    phases::sub(t, u, x3);
    st(s, OutX + c, x3);
    phases::sub(d, x3, t);
    st(s, S::kDX + c, t);
  }
};

template <class F, class S, int OutY>
struct DblY3 {  // Y3 = E (D - X3) - 8C
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t w[kWords], t[kWords];
    ld(s, S::kC + c, t);
    phases::add(t, t, t);
    phases::add(t, t, t);
    phases::add(t, t, t);
    F::mul_value(s, S::kEDX, c, w);
    phases::sub(w, t, w);
    st(s, OutY + c, w);
  }
};

template <class F, int In, int Out, int T>
struct Dbl {
  using S = DblSlots<F, T>;
  static constexpr int E = F::kE;
  static constexpr int kEnd = S::kEnd;
  static constexpr int X = In, Y = In + E, Z = In + 2 * E;
  using P1 = Round<Sqr<F, X, S::kA>, Sqr<F, Y, S::kB>, Mul<F, Y, Z, S::kYZ>>;
  using L1 = Linears<Sum<F, X, S::kB, S::kXB>, Triple<F, S::kA, S::kE3>,
                     TwiceValue<F, S::kYZ, Out + 2 * E>>;
  using P2 = Round<Sqr<F, S::kB, S::kC>, Sqr<F, S::kXB, S::kTs>,
                   Sqr<F, S::kE3, S::kF>>;
  using L2 = Linears<DblX3<F, S, Out>>;
  using P3 = Round<Mul<F, S::kE3, S::kDX, S::kEDX>>;
  using L3 = Linears<DblY3<F, S, Out + E>>;
  using Plan = phases::Plan<P1, L1, P2, L2, P3, L3>;
};

// --- the addition: add-2007-bl (curve.py add), p1 at In1 and p2 at In2 ------
//
//   round  products                               then
//   1      Z1^2, Z2^2, (Z1 + Z2)^2                 -
//   2      U1 = X1 Z2^2, U2 = X2 Z1^2, Z2 Z2^2,    U1, Z2^3, Z1^3;
//          Z1 Z1^2                                 H = U2 - U1, 2H;
//                                                  (Z1 + Z2)^2 - Z1^2 - Z2^2
//   3      S1 = Y1 Z2^3, S2 = Y2 Z1^3, I = (2H)^2,  S1, R = 2 (S2 - S1), Z3
//          Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H
//   4      J = H I, V = U1 I, R^2                  X3 = R^2 - J - 2V, V - X3
//   5      R (V - X3), S1 J                        (AddOut) Y3 = R (V - X3)
//                                                  - 2 S1 J, the selects
//
// Intermediates from element T on; the formula's X3 and Z3 stay in kAX and
// kAZ, its Y3 is formed by AddOut.

template <class F, int T>
struct AddSlots {
  static constexpr int E = F::kE, M = F::kMul;
  static constexpr int kZ1Z1 = T, kZ2Z2 = kZ1Z1 + E, kZZ = kZ2Z2 + E,
                       kU1p = kZZ + E, kU2p = kU1p + M, kZ2Cp = kU2p + M,
                       kZ1Cp = kZ2Cp + M, kU1 = kZ1Cp + M, kZ2C = kU1 + E,
                       kZ1C = kZ2C + E, kH = kZ1C + E, kH2 = kH + E,
                       kZZ3 = kH2 + E, kS1p = kZZ3 + E, kS2p = kS1p + M,
                       kI = kS2p + M, kZ3p = kI + E, kS1 = kZ3p + M,
                       kR = kS1 + E, kAZ = kR + E, kJp = kAZ + E,
                       kVp = kJp + M, kRR = kVp + M, kJ = kRR + E,
                       kAX = kJ + E, kVX = kAX + E, kRVX = kVX + E,
                       kS1J = kRVX + M, kEnd = kS1J + M;
};

template <class F, class S>
struct AddH {  // H = U2 - U1, 2H
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t u1[kWords], u2[kWords], h[kWords];
    F::mul_value(s, S::kU1p, c, u1);
    F::mul_value(s, S::kU2p, c, u2);
    phases::sub(u2, u1, h);
    st(s, S::kH + c, h);
    phases::add(h, h, u1);
    st(s, S::kH2 + c, u1);
  }
};

template <class F, class S>
struct AddZZ {  // (Z1 + Z2)^2 - Z1^2 - Z2^2
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t t[kWords], u[kWords];
    phases::ld_sub(s, S::kZZ + c, S::kZ1Z1 + c, t);
    ld(s, S::kZ2Z2 + c, u);
    phases::sub(t, u, t);
    st(s, S::kZZ3 + c, t);
  }
};

template <class F, class S>
struct AddR {  // R = 2 (S2 - S1)
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t s1[kWords], s2[kWords], r[kWords];
    F::mul_value(s, S::kS1p, c, s1);
    F::mul_value(s, S::kS2p, c, s2);
    phases::sub(s2, s1, r);
    phases::add(r, r, s1);
    st(s, S::kR + c, s1);
  }
};

template <class F, class S>
struct AddX3 {  // J, V, X3 = (R^2 - J) - 2V, V - X3
  static constexpr int kTasks = F::kE;
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t j[kWords], v[kWords], t[kWords], u[kWords];
    F::mul_value(s, S::kJp, c, j);
    F::mul_value(s, S::kVp, c, v);
    st(s, S::kJ + c, j);
    ld(s, S::kRR + c, t);
    phases::sub(t, j, t);
    phases::add(v, v, u);
    phases::sub(t, u, t);
    st(s, S::kAX + c, t);
    phases::sub(v, t, u);
    st(s, S::kVX + c, u);
  }
};

template <class F, int In1, int In2, int T>
struct AddCore {
  using S = AddSlots<F, T>;
  static constexpr int E = F::kE;
  static constexpr int kEnd = S::kEnd;
  static constexpr int X1 = In1, Y1 = In1 + E, Z1 = In1 + 2 * E;
  static constexpr int X2 = In2, Y2 = In2 + E, Z2 = In2 + 2 * E;
  using P1 = Round<Sqr<F, Z1, S::kZ1Z1>, Sqr<F, Z2, S::kZ2Z2>,
                   SqrSum<F, Z1, Z2, S::kZZ>>;
  using P2 = Round<Mul<F, X1, S::kZ2Z2, S::kU1p>, Mul<F, X2, S::kZ1Z1, S::kU2p>,
                   Mul<F, Z2, S::kZ2Z2, S::kZ2Cp>,
                   Mul<F, Z1, S::kZ1Z1, S::kZ1Cp>>;
  using L2 = Linears<Value<F, S::kU1p, S::kU1>, Value<F, S::kZ2Cp, S::kZ2C>,
                     Value<F, S::kZ1Cp, S::kZ1C>, AddH<F, S>, AddZZ<F, S>>;
  using P3 = Round<Mul<F, Y1, S::kZ2C, S::kS1p>, Mul<F, Y2, S::kZ1C, S::kS2p>,
                   Sqr<F, S::kH2, S::kI>, Mul<F, S::kZZ3, S::kH, S::kZ3p>>;
  using L3 = Linears<Value<F, S::kS1p, S::kS1>, AddR<F, S>,
                     Value<F, S::kZ3p, S::kAZ>>;
  using P4 = Round<Mul<F, S::kH, S::kI, S::kJp>, Mul<F, S::kU1, S::kI, S::kVp>,
                   Sqr<F, S::kR, S::kRR>>;
  using L4 = Linears<AddX3<F, S>>;
  using P5 = Round<Mul<F, S::kR, S::kVX, S::kRVX>,
                   Mul<F, S::kS1, S::kJ, S::kS1J>>;
  using Plan = phases::Plan<P1, P2, L2, P3, L3, P4, L4, P5>;
};

// What decides the add's result: infinite operands, equal X of finite
// points (H = 0) and equal Y (R = 0, not gated by finiteness, as curve.py's).
struct Flags {
  bool inf1, inf2, same_x, same_y;
};

template <class F, int In1, int In2, int T>
FP384_FN Flags flags(const uint32_t* s) {
  using S = AddSlots<F, T>;
  Flags f;
  f.inf1 = is_zero<F>(s, In1 + 2 * F::kE);
  f.inf2 = is_zero<F>(s, In2 + 2 * F::kE);
  f.same_x = is_zero<F>(s, S::kH) && !f.inf1 && !f.inf2;
  f.same_y = is_zero<F>(s, S::kR);
  return f;
}

// The add's result, element k of 3 kE (X, Y, Z), into Out: the formula's
// point; the doubling's at DblAt where both X and Y are equal (DblAt >= 0,
// curve.py add with handle_equal=True); then the cascade.  With Bit >= 0,
// word 0 of element Bit is a mask of the step's bit, and the result is
// the add's where it is all ones and p1 (the doubled accumulator) where it
// is 0: scalar_mul's select.  Every task forms its element from the same
// loads and masks, whatever the flags and the bit.
template <class F, int In1, int In2, int T, int Out, int DblAt, int Bit>
struct AddOut : phases::Linear<3 * F::kE> {
  using S = AddSlots<F, T>;
  static FP384_FN void task(int k, uint32_t* s) {
    const int e = k / F::kE, c = k % F::kE;
    const Flags f = flags<F, In1, In2, T>(s);
    uint32_t w[kWords], t[kWords], u[kWords];
    if (e == 0) {
      ld(s, S::kAX + c, w);
    } else if (e == 1) {  // R (V - X3) - 2 S1 J
      F::mul_value(s, S::kRVX, c, w);
      F::mul_value(s, S::kS1J, c, t);
      phases::add(t, t, u);
      phases::sub(w, u, w);
    } else {
      ld(s, S::kAZ + c, w);
    }
    if constexpr (DblAt >= 0) {
      ld(s, DblAt + k, t);
      pick(mask(f.same_x && f.same_y), t, w);
    }
    infinity_element<F>(k, t);
    pick(mask(f.same_x && !f.same_y), t, w);
    ld(s, In2 + k, t);
    pick(mask(f.inf1), t, w);
    ld(s, In1 + k, t);
    pick(mask(f.inf2 && !f.inf1), t, w);
    if constexpr (Bit >= 0) {
      const uint32_t bit = s[Bit * kWords];
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) w[j] = (w[j] & bit) | (t[j] & ~bit);
    }
    st(s, Out + k, w);
  }
};

// --- scalar_mul's ladder: a step in six rounds of uniform products ---------
//
// The step computes acc = 2 acc, then acc + pt where the bit is set: the
// same field values as dbl-2009-l, add-2007-bl and the select cascade
// above, on a plan of its own, so that the card runs every round of
// products through one copy of the product code (scalar_mul.cu):
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
//    (AddOut's, from flags the phases of adds wrote once) into acc: 12
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
// addition's (Y3 = R (V - X3) - 2 S1 J), then AddOut's cascade from the
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

// --- masked_sum's add: p1 + p2 with the doubling where they are equal -------
//
// One add's scratch area: p1, p2, the result, the doubling of p1, the
// doubling's and the addition's intermediates.  The caller puts p1 and
// p2 in place and takes the result from kOut.

template <class F>
struct SumAdd {
  static constexpr int E = F::kE;
  static constexpr int kIn1 = 0, kIn2 = 3 * E, kOut = 6 * E, kDbl = 9 * E,
                       kT = 12 * E;
  using Dbl = jac::Dbl<F, kIn1, kDbl, kT>;
  using Add = AddCore<F, kIn1, kIn2, Dbl::kEnd>;
  using Out = AddOut<F, kIn1, kIn2, Dbl::kEnd, kOut, kDbl, -1>;
  using OutPlan = phases::Plan<Out>;
  static constexpr int kScratch = Add::kEnd;
};

// Runs the add on scratch area s: the formula, the doubling only where the
// operands are equal (every thread that runs the plans reads the same
// flags), then the result.
template <class F, class Run>
FP384_FN bool sum_add(const Run& run, const uint32_t* s) {
  using A = SumAdd<F>;
  bool ok = run(typename A::Add::Plan{});
  const Flags f = flags<F, A::kIn1, A::kIn2, A::Dbl::kEnd>(s);
  if (f.same_x && f.same_y) ok = run(typename A::Dbl::Plan{}) && ok;
  return run(typename A::OutPlan{}) && ok;
}

// The number of leaves: n padded to a power of two (1 for n <= 1), as
// masked_sum pads with infinity.
FP384_FN int leaves(int64_t n) {
  int size = 1;
  while (size < n) size *= 2;
  return size;
}

}  // namespace jac
