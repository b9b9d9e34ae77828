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
// A point is 36 words: X, Y, Z of 12 words each; infinity has Z = 0.  The
// products go through a Mul, mul(a, b, out), which leaves the Montgomery
// product in `out` of every thread that calls it: on the card a group of
// split::kGroup threads runs the split product and shares the result
// (g1_masked_sum.cu), under g++ one call of a host product.  Every thread
// of a group computes the same values.  The adds and subtractions are
// phases.cuh's: PTX carry chains on the card, fp384.cuh's under g++.
// Nothing here branches on the data around a product except dbl, which
// runs only where any(...) says that some add of the warp needs it, so
// that every thread of a warp reaches the same shuffles.

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

// The number of leaves: n padded to a power of two (1 for n <= 1), as
// masked_sum pads with infinity.
FP384_FN int leaves(int64_t n) {
  int size = 1;
  while (size < n) size *= 2;
  return size;
}

}  // namespace g1
