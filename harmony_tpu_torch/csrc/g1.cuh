// The masked sum of G1 points and its affine form, one lane's plan: the
// arithmetic of g1_masked_sum.cu, and, as plain C++, of its host test
// (tests/test_torch_g1_host.py).
//
// It computes harmony_tpu/ops/curve.py masked_sum over Fp, then to_affine.
// A Jacobian point's limbs depend on the formula that made it, so this
// keeps the reference's: the add-2007-bl addition with the doubling
// fallback (curve.py add, handle_equal=True), dbl-2009-l for the doubling,
// and the same select cascade, in the same order.  Inside a formula any
// arrangement of the same field values gives the same canonical words.
//
// A point is 36 words: X, Y, Z of 12 words each; infinity has Z = 0.  Two
// forms of the add live here.  add and dbl run the formulas one product
// after another through a Mul, mul(a, b, out) (the sequential plan, which
// the host test holds the kernel's form against).  The kernel's form,
// add_in_rounds, runs the same formulas as programs of rounds of
// independent products (below), each product into a slot of the add's
// scratch area, so that the groups of threads an add has run a round's
// products side by side.  The adds and subtractions are phases.cuh's: PTX
// carry chains on the card, fp384.cuh's under g++.

#pragma once

#include <cstdint>

#include "phases.cuh"

#if !defined(HARMONY_ONE_MONT_WORDS)
#error "build through harmony_tpu_torch/kernels/_build.py, which defines 1 R"
#endif

namespace g1 {

using fp384::kWords;
using phases::add;
using phases::sub;

constexpr int kPoint = 3 * kWords;

FP384_FN const uint32_t* X(const uint32_t* pt) { return pt; }
FP384_FN const uint32_t* Y(const uint32_t* pt) { return pt + kWords; }
FP384_FN const uint32_t* Z(const uint32_t* pt) { return pt + 2 * kWords; }

FP384_FN bool is_zero(const uint32_t* a) {
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) any |= a[j];
  return any == 0;
}

// A leaf of the tree, in place.  `on` is the mask's selection (mask == 1,
// no other value), a point the lane does not take becomes (1, 1, 0) in the
// Montgomery domain, as masked_sum's infinity and padding.  An affine
// input (x, y), with X and Y loaded, gets Z = 1, or Z = 0 where (x, y) =
// (0, 0): ops/curve.py affine_to_jacobian_g1.
FP384_FN void leaf(bool on, bool affine, uint32_t pt[kPoint]) {
  constexpr uint32_t one[kWords] = {HARMONY_ONE_MONT_WORDS};
  const bool finite = on && affine && !(is_zero(X(pt)) && is_zero(Y(pt)));
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    if (!on) {
      pt[j] = one[j];
      pt[kWords + j] = one[j];
    }
    if (!on || affine) pt[2 * kWords + j] = finite ? one[j] : 0u;
  }
}

// The doubling of the point at p (dbl-2009-l, a = 0), into out where
// `take`; every thread of the warp runs it or none does.
template <class Mul>
FP384_FN void dbl(const Mul& mul, const uint32_t* p, bool take,
                  uint32_t out[kPoint]) {
  uint32_t a[kWords], b[kWords], c[kWords], d[kWords], t[kWords];
  mul(X(p), X(p), a);  // A = X^2
  mul(Y(p), Y(p), b);  // B = Y^2
  mul(b, b, c);        // C = B^2
  add(X(p), b, t);
  mul(t, t, t);        // (X + B)^2
  sub(t, a, t);
  sub(t, c, t);
  add(t, t, d);        // D = 2((X + B)^2 - A - C)
  add(a, a, t);
  add(t, a, a);        // E = 3A
  mul(a, a, b);        // F = E^2
  add(d, d, t);
  sub(b, t, b);        // X3 = F - 2D
  sub(d, b, t);
  mul(a, t, t);        // E (D - X3)
  add(c, c, c);
  add(c, c, c);
  add(c, c, c);        // 8C
  sub(t, c, t);        // Y3 = E (D - X3) - 8C
  mul(Y(p), Z(p), c);
  add(c, c, c);        // Z3 = 2 Y Z
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    out[j] = take ? b[j] : out[j];
    out[kWords + j] = take ? t[j] : out[kWords + j];
    out[2 * kWords + j] = take ? c[j] : out[2 * kWords + j];
  }
}

// p1 + p2 (add-2007-bl) with curve.py add's selects: p1 infinite gives
// p2; else p2 infinite gives p1; else equal X and opposite Y gives
// (1, 1, 0); else equal X and Y gives dbl(p1); else the formula's point.
// any(c) is true on every thread of the warp if c is true on one.
template <class Mul, class Any>
FP384_FN void add(const Mul& mul, const Any& any, const uint32_t* p1,
                  const uint32_t* p2, uint32_t out[kPoint]) {
  constexpr uint32_t one[kWords] = {HARMONY_ONE_MONT_WORDS};
  uint32_t z1z1[kWords], z2z2[kWords], u1[kWords], s1[kWords], h[kWords],
      r[kWords], t[kWords];
  mul(Z(p1), Z(p1), z1z1);
  mul(Z(p2), Z(p2), z2z2);
  mul(X(p1), z2z2, u1);  // U1 = X1 Z2^2
  mul(X(p2), z1z1, t);   // U2 = X2 Z1^2
  sub(t, u1, h);         // H = U2 - U1
  mul(Z(p2), z2z2, t);
  mul(Y(p1), t, s1);     // S1 = Y1 Z2^3
  mul(Z(p1), z1z1, t);
  mul(Y(p2), t, r);      // S2 = Y2 Z1^3
  sub(r, s1, r);
  add(r, r, r);          // R = 2 (S2 - S1)
  add(Z(p1), Z(p2), t);
  mul(t, t, t);
  sub(t, z1z1, t);
  sub(t, z2z2, t);
  mul(t, h, out + 2 * kWords);  // Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H
  add(h, h, t);
  mul(t, t, t);          // I = (2H)^2
  mul(h, t, z1z1);       // J = H I
  mul(u1, t, z2z2);      // V = U1 I
  mul(r, r, t);
  sub(t, z1z1, t);
  add(z2z2, z2z2, u1);
  sub(t, u1, out);       // X3 = R^2 - J - 2V
  sub(z2z2, out, t);
  mul(r, t, t);          // R (V - X3)
  mul(s1, z1z1, u1);
  add(u1, u1, u1);
  sub(t, u1, out + kWords);  // Y3 = R (V - X3) - 2 S1 J

  const bool inf1 = is_zero(Z(p1)), inf2 = is_zero(Z(p2));
  const bool same_x = is_zero(h) && !inf1 && !inf2;
  const bool same_y = is_zero(r);  // not gated by finiteness, as curve.py's
  if (any(same_x && same_y)) dbl(mul, p1, same_x && same_y, out);
  const bool opposite = same_x && !same_y;
  FP384_UNROLL
  for (int j = 0; j < kPoint; ++j) {
    uint32_t w = opposite ? (j < 2 * kWords ? one[j % kWords] : 0u) : out[j];
    w = inf1 ? p2[j] : w;
    out[j] = inf2 && !inf1 ? p1[j] : w;
  }
}

// The affine (x, y) of the point at pt, given zi = Z^-1 (fp384::inv, with
// inv(0) = 0): (X zi^2, Y zi zi^2); infinity (Z = 0) gives (0, 0).
template <class Mul>
FP384_FN void affine(const Mul& mul, const uint32_t* pt,
                     const uint32_t zi[kWords], uint32_t out[2 * kWords]) {
  uint32_t zi2[kWords], t[kWords];
  mul(zi, zi, zi2);
  mul(Y(pt), zi, t);
  mul(X(pt), zi2, out);
  mul(t, zi2, out + kWords);
  const bool inf = is_zero(Z(pt));
  FP384_UNROLL
  for (int j = 0; j < 2 * kWords; ++j) out[j] = inf ? 0u : out[j];
}

// --- the kernel's form: programs of rounds of independent products ---------
//
// A program's products are numbered in the order of its rounds; round i
// is products [round_start(i), round_start(i + 1)), which read only the
// points and the slots of earlier rounds, and product j goes to slot
// product_slot(j) of the add's scratch area (kSlots elements of 12
// words).  Everything that is not a product (H, R, X3, the select
// cascade) is formed again by whoever needs it from the slots.
//
//   program    rounds of products
//   kAdd       Z1^2, Z2^2, (Z1 + Z2)^2 | U1 = X1 Z2^2, U2 = X2 Z1^2,
//              Z2 Z2^2, Z1 Z1^2 | S1 = Y1 Z2^3, S2 = Y2 Z1^3, I = (2H)^2,
//              Z3 = ((Z1 + Z2)^2 - Z1^2 - Z2^2) H | J = H I, V = U1 I,
//              R^2 | R (V - X3), S1 J: add-2007-bl's 16 products
//   kAddOnes   I, R^2 | J, V | R (V - X3), S1 J: the same where both Z are
//              1 (R in the Montgomery domain), level 1 of an affine table.
//              Products by 1 and 1^2 are the identity on canonical
//              residues, so U1 = X1, U2 = X2, S1 = Y1, S2 = Y2, and
//              (Z1 + Z2)^2 - Z1^2 - Z2^2 = 2 makes Z3 = H + H: the same
//              words.  A leaf there has Z = 1 or Z = 0, and one with Z = 0
//              on either side is replaced by the select cascade, so its
//              intermediates do not matter.
//   kDbl       A = X^2, B = Y^2, Y Z | C = B^2, (X + B)^2, F = E^2 |
//              E (D - X3): dbl-2009-l's 7 products, on the add's first
//              point, into slots the add no longer needs
//   kAffine    Z^-2, Y Z^-1 | X Z^-2, Y Z^-3, of the sum and Z^-1

enum Prog { kAdd, kAddOnes, kDbl, kAffine };

// the slots of the add; the doubling's and the affine form's reuse 0 .. 6
enum Slot {
  kZ1Z1, kZ2Z2, kZZ, kU1, kU2, kZ2Cube, kZ1Cube, kS1, kS2, kI, kZ3, kJ,
  kV, kRR, kRVX, kS1J, kSlots
};
enum DblSlot { kDA, kDB, kDYZ, kDC, kDXB, kDF, kDEX };

FP384_FN int rounds(int prog) {
  return prog == kAdd ? 5 : prog == kAffine ? 2 : 3;
}

FP384_FN int round_start(int prog, int i) {
  switch (prog) {
    case kAdd:
      return i == 0   ? 0
             : i == 1 ? 3
             : i == 2 ? 7
             : i == 3 ? 11
             : i == 4 ? 14
                      : 16;
    case kDbl:
      return i == 0 ? 0 : i == 1 ? 3 : i == 2 ? 6 : 7;
    default:  // kAddOnes: 2 a round; kAffine: the same
      return 2 * i;
  }
}

FP384_FN int product_slot(int prog, int j) {
  if (prog != kAddOnes) return j;
  return j == 0   ? kI
         : j == 1 ? kRR
         : j == 2 ? kJ
         : j == 3 ? kV
         : j == 4 ? kRVX
                  : kS1J;
}

// Element e of the scratch area sc, and 12 words into registers.
FP384_FN const uint32_t* el(const uint32_t* sc, int e) {
  return sc + kWords * e;
}

FP384_FN void load(const uint32_t* a, uint32_t w[kWords]) {
#if defined(__CUDA_ARCH__)
  const uint4* p = reinterpret_cast<const uint4*>(a);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 v = p[k];
    w[4 * k] = v.x; w[4 * k + 1] = v.y; w[4 * k + 2] = v.z; w[4 * k + 3] = v.w;
  }
#else
  for (int j = 0; j < kWords; ++j) w[j] = a[j];
#endif
}

FP384_FN void copy(const uint32_t a[kWords], uint32_t w[kWords]) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) w[j] = a[j];
}

FP384_FN bool equal(const uint32_t* a, const uint32_t* b) {
  uint32_t diff = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) diff |= a[j] ^ b[j];
  return diff == 0;
}

// U1, U2, S1, S2 of the add: slots, or X and Y where both Z are 1.
FP384_FN const uint32_t* u1(bool ones, const uint32_t* p1, const uint32_t* sc) {
  return ones ? X(p1) : el(sc, kU1);
}
FP384_FN const uint32_t* u2(bool ones, const uint32_t* p2, const uint32_t* sc) {
  return ones ? X(p2) : el(sc, kU2);
}
FP384_FN const uint32_t* s1(bool ones, const uint32_t* p1, const uint32_t* sc) {
  return ones ? Y(p1) : el(sc, kS1);
}
FP384_FN const uint32_t* s2(bool ones, const uint32_t* p2, const uint32_t* sc) {
  return ones ? Y(p2) : el(sc, kS2);
}

// a - b and 2 (a - b) of elements at a and b.
FP384_FN void diff(const uint32_t* a, const uint32_t* b, uint32_t out[kWords]) {
  uint32_t x[kWords], y[kWords];
  load(a, x);
  load(b, y);
  sub(x, y, out);
}

FP384_FN void twice_diff(const uint32_t* a, const uint32_t* b,
                         uint32_t out[kWords]) {
  uint32_t d[kWords];
  diff(a, b, d);
  add(d, d, out);
}

// X3 = R^2 - J - 2V of the add, from its slots.
FP384_FN void add_x3(const uint32_t* sc, uint32_t out[kWords]) {
  uint32_t t[kWords], v[kWords];
  diff(el(sc, kRR), el(sc, kJ), t);
  load(el(sc, kV), v);
  add(v, v, v);
  sub(t, v, out);
}

// D = 2 ((X + B)^2 - A - C) and X3 = F - 2D of the doubling.
FP384_FN void dbl_d(const uint32_t* sc, uint32_t out[kWords]) {
  uint32_t t[kWords], c[kWords];
  diff(el(sc, kDXB), el(sc, kDA), t);
  load(el(sc, kDC), c);
  sub(t, c, t);
  add(t, t, out);
}

FP384_FN void dbl_x3(const uint32_t* sc, const uint32_t d[kWords],
                     uint32_t out[kWords]) {
  uint32_t f[kWords], t[kWords];
  load(el(sc, kDF), f);
  add(d, d, t);
  sub(f, t, out);
}

// E = 3A of the doubling.
FP384_FN void dbl_e(const uint32_t* sc, uint32_t out[kWords]) {
  uint32_t a[kWords], t[kWords];
  load(el(sc, kDA), a);
  add(a, a, t);
  add(t, a, out);
}

// The operands of the product that goes to slot k of program prog: p1
// and p2 are the add's points (for kAffine, the sum and Z^-1), sc its
// scratch area.
FP384_FN void operands(int prog, int k, bool ones, const uint32_t* p1,
                       const uint32_t* p2, const uint32_t* sc,
                       uint32_t x[kWords], uint32_t y[kWords]) {
  uint32_t t[kWords];
  if (prog == kAffine) {
    switch (k) {
      case 0: load(p2, x); copy(x, y); return;               // Z^-2
      case 1: load(Y(p1), x); load(p2, y); return;           // Y Z^-1
      case 2: load(X(p1), x); load(el(sc, 0), y); return;    // X Z^-2
      default: load(el(sc, 1), x); load(el(sc, 0), y); return;  // Y Z^-3
    }
  }
  if (prog == kDbl) {
    switch (k) {
      case kDA: load(X(p1), x); copy(x, y); return;
      case kDB: load(Y(p1), x); copy(x, y); return;
      case kDYZ: load(Y(p1), x); load(Z(p1), y); return;
      case kDC: load(el(sc, kDB), x); copy(x, y); return;
      case kDXB:
        load(X(p1), t);
        load(el(sc, kDB), y);
        add(t, y, x);
        copy(x, y);
        return;
      case kDF: dbl_e(sc, x); copy(x, y); return;
      default: {  // E (D - X3)
        uint32_t d[kWords];
        dbl_e(sc, x);
        dbl_d(sc, d);
        dbl_x3(sc, d, t);
        sub(d, t, y);
        return;
      }
    }
  }
  switch (k) {
    case kZ1Z1: load(Z(p1), x); copy(x, y); return;
    case kZ2Z2: load(Z(p2), x); copy(x, y); return;
    case kZZ:
      load(Z(p1), t);
      load(Z(p2), y);
      add(t, y, x);
      copy(x, y);
      return;
    case kU1: load(X(p1), x); load(el(sc, kZ2Z2), y); return;
    case kU2: load(X(p2), x); load(el(sc, kZ1Z1), y); return;
    case kZ2Cube: load(Z(p2), x); load(el(sc, kZ2Z2), y); return;
    case kZ1Cube: load(Z(p1), x); load(el(sc, kZ1Z1), y); return;
    case kS1: load(Y(p1), x); load(el(sc, kZ2Cube), y); return;
    case kS2: load(Y(p2), x); load(el(sc, kZ1Cube), y); return;
    case kI:  // (2H)^2
      twice_diff(u2(ones, p2, sc), u1(ones, p1, sc), x);
      copy(x, y);
      return;
    case kZ3:  // ((Z1 + Z2)^2 - Z1^2 - Z2^2) H
      diff(el(sc, kZZ), el(sc, kZ1Z1), t);
      load(el(sc, kZ2Z2), y);
      sub(t, y, x);
      diff(el(sc, kU2), el(sc, kU1), y);
      return;
    case kJ:
      diff(u2(ones, p2, sc), u1(ones, p1, sc), x);
      load(el(sc, kI), y);
      return;
    case kV: load(u1(ones, p1, sc), x); load(el(sc, kI), y); return;
    case kRR:
      twice_diff(s2(ones, p2, sc), s1(ones, p1, sc), x);
      copy(x, y);
      return;
    case kRVX:  // R (V - X3)
      twice_diff(s2(ones, p2, sc), s1(ones, p1, sc), x);
      add_x3(sc, t);
      load(el(sc, kV), y);
      sub(y, t, y);
      return;
    default: load(s1(ones, p1, sc), x); load(el(sc, kJ), y); return;  // S1 J
  }
}

// What decides the add's result: infinite operands, equal X (of finite
// points) and equal Y (curve.py add's checks on H and R).
struct Flags {
  bool inf1, inf2, same_x, same_y;
};

FP384_FN Flags flags(bool ones, const uint32_t* p1, const uint32_t* p2,
                     const uint32_t* sc) {
  Flags f;
  f.inf1 = is_zero(Z(p1));
  f.inf2 = is_zero(Z(p2));
  f.same_x = equal(u1(ones, p1, sc), u2(ones, p2, sc)) && !f.inf1 && !f.inf2;
  f.same_y = equal(s1(ones, p1, sc), s2(ones, p2, sc));  // H, R = 0
  return f;
}

// Element e (X, Y, Z) of the add's result after its programs: the
// formula's point, or the doubling's where both X and Y are equal, then
// add's select cascade.
FP384_FN void result(int e, bool ones, const Flags& f, const uint32_t* p1,
                     const uint32_t* p2, const uint32_t* sc,
                     uint32_t out[kWords]) {
  constexpr uint32_t one[kWords] = {HARMONY_ONE_MONT_WORDS};
  uint32_t t[kWords], w[kWords];
  if (f.same_x && f.same_y) {  // the doubling's X3, Y3, Z3
    uint32_t d[kWords];
    if (e == 0) {
      dbl_d(sc, d);
      dbl_x3(sc, d, w);
    } else if (e == 1) {  // E (D - X3) - 8C
      load(el(sc, kDC), t);
      add(t, t, t);
      add(t, t, t);
      add(t, t, t);
      load(el(sc, kDEX), d);
      sub(d, t, w);
    } else {  // 2 Y Z
      load(el(sc, kDYZ), t);
      add(t, t, w);
    }
  } else if (e == 0) {
    add_x3(sc, w);
  } else if (e == 1) {  // R (V - X3) - 2 S1 J
    load(el(sc, kS1J), t);
    add(t, t, t);
    load(el(sc, kRVX), w);
    sub(w, t, w);
  } else if (ones) {  // H + H
    twice_diff(u2(ones, p2, sc), u1(ones, p1, sc), w);
  } else {
    load(el(sc, kZ3), w);
  }
  const bool opposite = f.same_x && !f.same_y;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    uint32_t v = opposite ? (e < 2 ? one[j] : 0u) : w[j];
    v = f.inf1 ? p2[kWords * e + j] : v;
    out[j] = f.inf2 && !f.inf1 ? p1[kWords * e + j] : v;
  }
}

// One add of the kernel's form: run(prog) runs a program's rounds on the
// add's groups (on the card every thread of the warp, the same rounds),
// any(c) is true on every thread of the warp if c is true on one.  `ones`
// where both leaves' Z are 1 or 0 (level 1 of an affine table).  Returns
// the flags; result() then gives each element.
template <class Run, class Any>
FP384_FN Flags add_in_rounds(const Run& run, const Any& any, bool ones,
                             const uint32_t* p1, const uint32_t* p2,
                             const uint32_t* sc) {
  run(ones ? kAddOnes : kAdd);
  const Flags f = flags(ones, p1, p2, sc);
  if (any(f.same_x && f.same_y)) run(kDbl);
  return f;
}

// The number of leaves: n padded to a power of two (1 for n <= 1), as
// masked_sum pads with infinity.
FP384_FN int leaves(int64_t n) {
  int size = 1;
  while (size < n) size *= 2;
  return size;
}

}  // namespace g1
