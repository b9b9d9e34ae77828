// The Miller loop of the optimal ate pairing over BLS12-381 for one lane,
// as plans of phases fixed at compile time (phases.cuh): run by
// miller_loop.cu on one block per lane and, as plain C++, by the host test
// of its plans (tests/test_torch_miller_host.py).
//
// The loop is the port's (ops/pairing.py miller_loop_reference) and the
// JAX package's: f_{|x|,Q}(P), conjugated, over |x|'s static schedule.
// Each doubling of the twist point T squares f and multiplies it by the
// tangent line at P; each addition of the affine Q multiplies f by the
// chord.  The steps are the port's _dbl_step (tangent line and
// dbl-2009-l) and _add_step (chord line and madd-2007-bl), the same
// values from the same inputs.  Every element is canonical, so each add,
// sub and product gives the plain version's limbs, whatever the formula:
// Fp2 products here are Karatsuba, squarings the complex method, f^2 the
// plain version's 36-product complex method, f times the line the
// 54-product Karatsuba-2/3/2 product with the line as a dense Fp12, and
// the tangent's c_v2 = 2 Y Z^3 yp is formed as (2 Y yp) Z^3.
//
// The schedule and the Montgomery form of 1 come from the generated header
// (kernels/_build.py params_header):
//   HARMONY_MILLER_DBL      per segment, the number of doublings
//   HARMONY_MILLER_ADD      per segment, 1 if an addition follows
//   HARMONY_ONE_MONT_WORDS  2^384 mod p as 12 words
//
// A doubling is one plan of 14 phases: f^2's and the step's phases side
// by side, the step's first products in f^2's round of products, then
// f times the line.  An addition is one plan of 13.  Within a phase, each
// kind of task has warps of its own (phases::Beside).  A lane's state
// stays in its scratch area for the whole loop (elements of 12 words); the
// doubling and the addition step share the region of a step's
// intermediates, and no plan reuses a region for another purpose, so only
// the order of phases orders reads and writes.

#pragma once

#include <cstdint>

#include "phases.cuh"

#if !defined(HARMONY_MILLER_DBL) || !defined(HARMONY_MILLER_ADD) || \
    !defined(HARMONY_ONE_MONT_WORDS)
#error "build through harmony_tpu_torch/kernels/_build.py, which defines the schedule"
#endif

namespace miller {

using fp12::ld;
using fp12::st;
using fp384::kWords;

// --- the lane's scratch area ------------------------------------------------

constexpr int kF = 0;      // 12: f
constexpr int kB = 12;     // 12: the line as a dense Fp12, zeros in 6 slots
constexpr int kX = 24;     // the twist point X, Y, Z (Fp2 each)
constexpr int kY = 26;
constexpr int kZ = 28;
constexpr int kXq = 30;    // affine Q: xq, then yq
constexpr int kYq = 32;
constexpr int kXp = 34;    // affine P: xp, then yp
constexpr int kYp = 35;
constexpr int kNxp = 36;   // -xp
constexpr int kNxp3 = 37;  // -3 xp
// f^2: the Fp6 operands a0 + a1 and a0 + v a1, and the Fp6 products'
// intermediates
constexpr int kSq1 = 38;   // 12
constexpr int kSqS = 50;   // 24
constexpr int kSqV = 74;   // 36
constexpr int kSqW = 110;  // 24
constexpr int kSqU = 134;  // 12
// f times the line: a0 + a1, b0 + b1, and the intermediates
constexpr int kMl1 = 146;  // 12
constexpr int kMlS = 158;  // 36
constexpr int kMlV = 194;  // 54
constexpr int kMlW = 248;  // 36
constexpr int kMlU = 284;  // 18
constexpr int kT = 302;    // 54: a step's intermediates
constexpr int kScratch = kT + 54;  // 356 elements, 17,088 B

// The line c_v2 v^2 + c_w w + c_wv w v as the dense Fp12 b (element
// 6 i12 + 2 i6 + i2, ops/pairing.py _sparse_line_to_fp12).
constexpr int kLineV2 = kB + 4;
constexpr int kLineW = kB + 6;
constexpr int kLineWV = kB + 8;

// --- products of Fp6 values -------------------------------------------------
//
// N6 Fp6 products by Karatsuba-3 over Fp2 and Karatsuba over Fp, as
// ops/towers.py fp6_mul: operand (side, f6) has its six elements from
// Operand::base(side, f6).  Fp2 operand g = 0..5 is x0, x1, x2, x1 + x2,
// x0 + x1, x0 + x2; Fp operand h = 0, 1, 2 of it is its two components and
// their sum; product (f6, g, h) goes to kV + 18 f6 + 3 g + h.
//
//   phase       tasks  writes
//   Sums        12 N6  kS: the Fp2 sums g = 3, 4, 5 [side][f6][g - 3][c]
//   Products    18 N6  kV: the Fp products
//   Fp2Combine  12 N6  kW: the Fp2 products [f6][g][c], by component
//   Fp6Combine  6 N6   kU: the Fp6 products [f6][element], by Fp2 index

template <int N6, class Operand, int kS, int kV, int kW, int kU>
struct Fp6Products {
  static FP384_FN int fp2(int side, int f6, int g) {
    return g < 3 ? Operand::base(side, f6) + 2 * g
                 : kS + ((side * N6 + f6) * 3 + g - 3) * 2;
  }

  struct Sums : phases::Linear<12 * N6> {
    static FP384_FN void task(int k, uint32_t* s) {
      const int c = k % 2, q = k / 2 % 3, so = k / 6;
      const int base = Operand::base(so / N6, so % N6);
      const int i = q == 0 ? 1 : 0, j = q == 1 ? 1 : 2;  // (1,2) (0,1) (0,2)
      uint32_t r[kWords];
      phases::ld_add(s, base + 2 * i + c, base + 2 * j + c, r);
      st(s, kS + k, r);
    }
  };

  struct Products : phases::Products<18 * N6> {
    static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                                 uint32_t y[kWords]) {
      const int f6 = k / 18, g = k % 18 / 3, h = k % 3;
      phases::kara(s, fp2(0, f6, g), h, x);
      phases::kara(s, fp2(1, f6, g), h, y);
      return kV + k;
    }
  };

  // component C of each Fp2 product (f6, g) = k
  template <int C>
  struct Fp2CombineC : phases::Linear<6 * N6> {
    static FP384_FN void task(int k, uint32_t* s) {
      uint32_t r[kWords];
      phases::combine(s, kV + 3 * k, C, r);
      st(s, kW + 2 * k + C, r);
    }
  };
  using Fp2Combine = phases::Beside<Fp2CombineC<0>, Fp2CombineC<1>>;

  // Fp2 coefficient J of each Fp6 product, from its Fp2 products v_g at
  // w + 2 g: c0 = v0 + xi (v12 - (v1 + v2)), c1 = (v01 - (v0 + v1)) + xi v2,
  // c2 = (v02 - (v0 + v2)) + v1
  template <int J>
  struct Fp6CombineJ : phases::Linear<2 * N6> {
    static FP384_FN void task(int k, uint32_t* s) {
      const int f6 = k / 2, c = k % 2, w = kW + 12 * f6;
      uint32_t t[kWords], z[kWords], r[kWords];
      if (J == 0) {
        uint32_t d0[kWords], d1[kWords];
        phases::ld_add(s, w + 2, w + 4, t);
        ld(s, w + 6, z);
        phases::sub(z, t, d0);
        phases::ld_add(s, w + 3, w + 5, t);
        ld(s, w + 7, z);
        phases::sub(z, t, d1);
        phases::xi_part(d0, d1, c, t);
        ld(s, w + c, z);
        phases::add(z, t, r);
      } else {
        constexpr int kOther = J == 1 ? 1 : 2, kCross = J == 1 ? 4 : 5;
        uint32_t d[kWords];
        phases::ld_add(s, w + c, w + 2 * kOther + c, t);
        ld(s, w + 2 * kCross + c, z);
        phases::sub(z, t, d);
        if (J == 1) {
          phases::xi(s, w + 4, c, z);
        } else {
          ld(s, w + 2 + c, z);
        }
        phases::add(d, z, r);
      }
      st(s, kU + 6 * f6 + 2 * J + c, r);
    }
  };
  using Fp6Combine =
      phases::Beside<Fp6CombineJ<0>, Fp6CombineJ<1>, Fp6CombineJ<2>>;
};

// v (y0, y1, y2) = (xi y2, y0, y1): element e of v y, for y at e0.  The
// phases that use it give e < 2 and e >= 2 warps of their own: the first
// two are adds, the other four loads.
FP384_FN void times_v(const uint32_t* s, int e0, int e, uint32_t out[kWords]) {
  if (e < 2) {
    phases::xi(s, e0 + 4, e, out);
  } else {
    ld(s, e0 + e - 2, out);
  }
}

// Elements [E0, E1) of an Fp6 value, a kind of task of their own.
template <class Task, int E0, int E1>
struct Elements : phases::Linear<E1 - E0> {
  static FP384_FN void task(int k, uint32_t* s) { Task::element(E0 + k, s); }
};

// The six element tasks of an Fp6 value that uses times_v, as two kinds.
template <class Task>
using TimesVKinds =
    phases::Beside<Elements<Task, 0, 2>, Elements<Task, 2, 6>>;

// --- f^2, the complex method (ops/towers.py fp12_sqr_reference) -------------
//
// (a0 + a1 w)^2 = ((a0 + a1)(a0 + v a1) - v0 - v v0) + 2 v0 w, v0 = a0 a1:
// two Fp6 products, 36 Fp products.
//
//   phase        tasks  writes
//   SqPre        12     kSq1: a0 + a1, a0 + v a1
//   Sq::Sums ... Fp6Combine, as above, into kSqS, kSqV, kSqW, kSqU
//   SqPost       12     f: (cross - v0) - v v0, v0 + v0

struct SqOperand {
  static FP384_FN int base(int side, int f6) {
    return (f6 == 0 ? kF : kSq1) + 6 * side;
  }
};
using Sq = Fp6Products<2, SqOperand, kSqS, kSqV, kSqW, kSqU>;

struct SqPreSum : phases::Linear<6> {  // a0 + a1
  static FP384_FN void task(int e, uint32_t* s) {
    uint32_t r[kWords];
    phases::ld_add(s, kF + e, kF + 6 + e, r);
    st(s, kSq1 + e, r);
  }
};

struct SqPreV {  // a0 + v a1
  static FP384_FN void element(int e, uint32_t* s) {
    uint32_t t[kWords], z[kWords], r[kWords];
    times_v(s, kF + 6, e, t);
    ld(s, kF + e, z);
    phases::add(z, t, r);
    st(s, kSq1 + 6 + e, r);
  }
};

struct SqPost0 {  // (cross - v0) - v v0
  static FP384_FN void element(int e, uint32_t* s) {
    uint32_t t[kWords], z[kWords], r[kWords];
    phases::ld_sub(s, kSqU + 6 + e, kSqU + e, z);
    times_v(s, kSqU, e, t);
    phases::sub(z, t, r);
    st(s, kF + e, r);
  }
};

struct SqPost1 : phases::Linear<6> {  // v0 + v0
  static FP384_FN void task(int e, uint32_t* s) {
    uint32_t r[kWords];
    phases::ld_add(s, kSqU + e, kSqU + e, r);
    st(s, kF + 6 + e, r);
  }
};

// --- f times the line (ops/towers.py fp12_mul_reference) --------------------
//
// Karatsuba-2 over Fp6: a0 b0, a1 b1, (a0 + a1)(b0 + b1), 54 Fp products;
// c0 = u0 + v u1, c1 = u2 - (u0 + u1).
//
//   phase        tasks  writes
//   MlPre        12     kMl1: a0 + a1, b0 + b1
//   Ml::Sums ... Fp6Combine, as above, into kMlS, kMlV, kMlW, kMlU
//   MlPost       12     f

struct MlOperand {
  static FP384_FN int base(int side, int f6) {
    return f6 < 2 ? (side ? kB : kF) + 6 * f6 : kMl1 + 6 * side;
  }
};
using Ml = Fp6Products<3, MlOperand, kMlS, kMlV, kMlW, kMlU>;

struct MlPre : phases::Linear<12> {
  static FP384_FN void task(int k, uint32_t* s) {
    const int in = k < 6 ? kF : kB, e = k % 6;
    uint32_t r[kWords];
    phases::ld_add(s, in + e, in + 6 + e, r);
    st(s, kMl1 + k, r);
  }
};

struct MlPost0 {  // u0 + v u1
  static FP384_FN void element(int e, uint32_t* s) {
    uint32_t t[kWords], z[kWords], r[kWords];
    times_v(s, kMlU + 6, e, t);
    ld(s, kMlU + e, z);
    phases::add(z, t, r);
    st(s, kF + e, r);
  }
};

struct MlPost1 : phases::Linear<6> {  // u2 - (u0 + u1)
  static FP384_FN void task(int e, uint32_t* s) {
    uint32_t t[kWords], z[kWords], r[kWords];
    phases::ld_add(s, kMlU + e, kMlU + 6 + e, t);
    ld(s, kMlU + 12 + e, z);
    phases::sub(z, t, r);
    st(s, kF + 6 + e, r);
  }
};

// --- init: f = 1, T = Q, -xp, -3 xp, the line's zeros; and conj -------------
//
// Before it, the kernel has loaded xp, yp at kXp and xq, yq at kXq.

struct Init : phases::Linear<26> {
  static FP384_FN void task(int k, uint32_t* s) {
    constexpr uint32_t one[kWords] = {HARMONY_ONE_MONT_WORDS};
    uint32_t r[kWords], t[kWords];
    if (k < 14) {  // f = 1, Z = 1 + 0 u
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) r[j] = k == 0 || k == 12 ? one[j] : 0u;
      st(s, k < 12 ? kF + k : kZ + k - 12, r);
    } else if (k < 18) {  // X, Y = xq, yq
      ld(s, kXq + k - 14, r);
      st(s, kX + k - 14, r);
    } else if (k < 20) {  // -xp, -3 xp
      ld(s, kXp, t);
      if (k == 19) {
        phases::add(t, t, r);
        phases::add(r, t, t);
      }
      phases::neg(t, r);
      st(s, k == 18 ? kNxp : kNxp3, r);
    } else {  // the line's empty slots: b0's v^0 and v^1, b1's v^2
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) r[j] = 0;
      st(s, kB + (k - 20 < 4 ? k - 20 : k - 14), r);
    }
  }
};

struct Conj : phases::Linear<6> {  // x < 0: negate f's w coefficient
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t x[kWords], r[kWords];
    ld(s, kF + 6 + k, x);
    phases::neg(x, r);
    st(s, kF + 6 + k, r);
  }
};

// --- the doubling step (ops/pairing.py _dbl_step) ---------------------------
//
// From T = (X, Y, Z), -3 xp and yp: the tangent line's c_v2 = 2 Y Z^3 yp,
// c_wv = -3 X^2 Z^2 xp, c_w = 3 X^3 - 2 Y^2 into b, and 2T into T by
// dbl-2009-l: with c = Y^4, t = (X + Y^2)^2, d = 2 (t - X^2 - c),
// e = 3 X^2: X3 = e^2 - 2 d, Y3 = e (d - X3) - 8 c, Z3 = 2 Y Z.
//
//   phase  tasks  writes
//   P0     11     X^2, Y^2, Z^2 (complex); Y Z (Karatsuba); Y yp
//   L0     4      e = 3 X^2, X + Y^2
//   P1     15     Z^2 Z, X^2 X, X^2 Z^2 (Karatsuba); c, t, e^2 (complex)
//   L2     12     Z^3, X^2 Z^2; X3 and d - X3; Z3 = 2 Y Z; c_w; 2 Y yp
//   P3     8      (2 Y yp) Z^3, e (d - X3) (Karatsuba); c_wv = X^2 Z^2 (-3 xp)
//   L4     4      c_v2; Y3 = e (d - X3) - 8 c
// Each phase is the listed kinds of task side by side.

constexpr int kDXsq = kT;        // 2: X^2
constexpr int kDYsq = kT + 2;    // 2: Y^2
constexpr int kDZsq = kT + 4;    // 2: Z^2
constexpr int kDYZ = kT + 6;     // 3: products of Y Z
constexpr int kDYyp = kT + 9;    // 2: Y yp
constexpr int kDZ3p = kT + 11;   // 3: products of Z^2 Z
constexpr int kDX3p = kT + 14;   // 3: products of X^2 X
constexpr int kDM1p = kT + 17;   // 3: products of X^2 Z^2
constexpr int kDC = kT + 20;     // 2: c = (Y^2)^2
constexpr int kDTsq = kT + 22;   // 2: t = (X + Y^2)^2
constexpr int kDEsq = kT + 24;   // 2: e^2
constexpr int kDZ3 = kT + 26;    // 2: Z^3
constexpr int kDM1 = kT + 28;    // 2: X^2 Z^2
constexpr int kDDmX3 = kT + 30;  // 2: d - X3
constexpr int kDYyp2 = kT + 32;  // 2: 2 Y yp
constexpr int kDM0p = kT + 34;   // 3: products of (2 Y yp) Z^3
constexpr int kDY3p = kT + 37;   // 3: products of e (d - X3)
constexpr int kDE = kT + 40;     // 2: e = 3 X^2
constexpr int kDXY2 = kT + 42;   // 2: X + Y^2

FP384_FN void times3(const uint32_t a[kWords], uint32_t out[kWords]) {
  uint32_t t[kWords];
  phases::add(a, a, t);
  phases::add(t, a, out);
}


struct DblSquares : phases::Products<6> {  // X^2, Y^2, Z^2
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kX + 2 * (k / 2), k % 2, x, y);
    return kDXsq + k;
  }
};

struct DblYZ : phases::Products<3> {
  static FP384_FN int operands(int h, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::kara(s, kY, h, x);
    phases::kara(s, kZ, h, y);
    return kDYZ + h;
  }
};

struct DblYyp : phases::Products<2> {
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    ld(s, kY + c, x);
    ld(s, kYp, y);
    return kDYyp + c;
  }
};

struct DblCubes : phases::Products<9> {  // Z^2 Z, X^2 X, X^2 Z^2
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int g = k / 3;
    phases::kara(s, g == 0 ? kDZsq : kDXsq, k % 3, x);
    phases::kara(s, g == 0 ? kZ : g == 1 ? kX : kDZsq, k % 3, y);
    return kDZ3p + k;
  }
};

struct DblPre1 : phases::Linear<4> {  // e = 3 X^2, X + Y^2
  static FP384_FN void task(int k, uint32_t* s) {
    const int c = k % 2;
    uint32_t r[kWords], t[kWords];
    if (k < 2) {
      ld(s, kDXsq + c, t);
      times3(t, r);
      st(s, kDE + c, r);
    } else {
      phases::ld_add(s, kX + c, kDYsq + c, r);
      st(s, kDXY2 + c, r);
    }
  }
};

struct DblC : phases::Products<2> {  // c = (Y^2)^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kDYsq, c, x, y);
    return kDC + c;
  }
};

struct DblT : phases::Products<2> {  // t = (X + Y^2)^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kDXY2, c, x, y);
    return kDTsq + c;
  }
};

struct DblE : phases::Products<2> {  // e^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kDE, c, x, y);
    return kDEsq + c;
  }
};

struct DblZ3M1 : phases::Linear<4> {  // Z^3, X^2 Z^2
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t r[kWords];
    phases::combine(s, k < 2 ? kDZ3p : kDM1p, k % 2, r);
    st(s, (k < 2 ? kDZ3 : kDM1) + k % 2, r);
  }
};

struct DblX3 : phases::Linear<2> {  // d = 2 ((t - X^2) - c), X3 = e^2 - 2 d
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    uint32_t d[kWords], d2[kWords], x3[kWords];
    phases::ld_sub(s, kDTsq + c, kDXsq + c, r);
    ld(s, kDC + c, u);
    phases::sub(r, u, t);
    phases::add(t, t, d);
    phases::add(d, d, d2);
    ld(s, kDEsq + c, u);
    phases::sub(u, d2, x3);
    st(s, kX + c, x3);
    phases::sub(d, x3, r);
    st(s, kDDmX3 + c, r);
  }
};

struct DblZ3 : phases::Linear<2> {  // Z3 = 2 Y Z
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords];
    phases::combine(s, kDYZ, c, t);
    phases::add(t, t, r);
    st(s, kZ + c, r);
  }
};

struct DblCw : phases::Linear<2> {  // c_w = 3 X^3 - 2 Y^2
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::combine(s, kDX3p, c, t);
    times3(t, u);
    phases::ld_add(s, kDYsq + c, kDYsq + c, t);
    phases::sub(u, t, r);
    st(s, kLineW + c, r);
  }
};

struct DblYyp2 : phases::Linear<2> {  // 2 Y yp
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords];
    phases::ld_add(s, kDYyp + c, kDYyp + c, r);
    st(s, kDYyp2 + c, r);
  }
};

struct DblM0 : phases::Products<3> {  // (2 Y yp) Z^3
  static FP384_FN int operands(int h, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::kara(s, kDYyp2, h, x);
    phases::kara(s, kDZ3, h, y);
    return kDM0p + h;
  }
};

struct DblY3p : phases::Products<3> {  // e (d - X3)
  static FP384_FN int operands(int h, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::kara(s, kDE, h, x);
    phases::kara(s, kDDmX3, h, y);
    return kDY3p + h;
  }
};

struct DblCwv : phases::Products<2> {  // c_wv = X^2 Z^2 (-3 xp)
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    ld(s, kDM1 + c, x);
    ld(s, kNxp3, y);
    return kLineWV + c;
  }
};

struct DblCv2 : phases::Linear<2> {  // c_v2 = (2 Y yp) Z^3
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords];
    phases::combine(s, kDM0p, c, r);
    st(s, kLineV2 + c, r);
  }
};

struct DblY3 : phases::Linear<2> {  // Y3 = e (d - X3) - 8 c
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::combine(s, kDY3p, c, t);
    phases::ld_add(s, kDC + c, kDC + c, u);
    phases::add(u, u, r);
    phases::add(r, r, u);
    phases::sub(t, u, r);
    st(s, kY + c, r);
  }
};

// --- the addition step (ops/pairing.py _add_step) ---------------------------
//
// From T = (X, Y, Z), the affine Q = (xq, yq), -xp and yp: with
// S2 = yq Z^3, U2 = xq Z^2, num = Y - S2, H = U2 - X, den = Z (-H), the
// chord's c_v2 = den yp, c_wv = num (-xp), c_w = xq num - yq den into b,
// and T + Q into T by madd-2007-bl: with r = 2 (S2 - Y), I = (2 H)^2,
// J = H I, V = X I: X3 = r^2 - J - 2 V, Y3 = r (V - X3) - 2 Y J,
// Z3 = (Z + H)^2 - Z^2 - H^2.
//
//   phase  tasks  writes
//   P0     2      Z^2 (complex)
//   P1     6      Z^2 Z, xq Z^2 (Karatsuba)
//   L2     4      Z^3, H = U2 - X
//   P3     12     yq Z^3, Z (-H) (Karatsuba); I, H^2, (Z + H)^2 (complex)
//   L4     6      den; num and r; Z3
//   P5     18     c_v2, c_wv; xq num, yq den, H I, X I (Karatsuba); r^2
//   L6     4      c_w; J, X3 and V - X3
//   P7     6      r (V - X3), Y J (Karatsuba)
//   L8     2      Y3

constexpr int kAZsq = kT;        // 2: Z^2
constexpr int kAZ3p = kT + 2;    // 3: products of Z^2 Z
constexpr int kAU2p = kT + 5;    // 3: products of xq Z^2
constexpr int kAZ3 = kT + 8;     // 2: Z^3
constexpr int kAH = kT + 10;     // 2: H
constexpr int kAS2p = kT + 12;   // 3: products of yq Z^3
constexpr int kADenp = kT + 15;  // 3: products of Z (-H)
constexpr int kAI = kT + 18;     // 2: I = (2 H)^2
constexpr int kAHsq = kT + 20;   // 2: H^2
constexpr int kAZH = kT + 22;    // 2: (Z + H)^2
constexpr int kADen = kT + 24;   // 2: den
constexpr int kANum = kT + 26;   // 2: num
constexpr int kAR = kT + 28;     // 2: r
constexpr int kAXNp = kT + 30;   // 3: products of xq num
constexpr int kAYDp = kT + 33;   // 3: products of yq den
constexpr int kAJp = kT + 36;    // 3: products of H I
constexpr int kAVp = kT + 39;    // 3: products of X I
constexpr int kARsq = kT + 42;   // 2: r^2
constexpr int kAJ = kT + 44;     // 2: J
constexpr int kAVmX3 = kT + 46;  // 2: V - X3
constexpr int kARVp = kT + 48;   // 3: products of r (V - X3)
constexpr int kAYJp = kT + 51;   // 3: products of Y J

struct AddP0 : phases::Products<2> {  // Z^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kZ, c, x, y);
    return kAZsq + c;
  }
};

struct AddP1 : phases::Products<6> {  // Z^2 Z, xq Z^2
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::kara(s, k < 3 ? kZ : kXq, k % 3, x);
    phases::kara(s, kAZsq, k % 3, y);
    return kAZ3p + k;
  }
};

struct AddZcube : phases::Linear<2> {  // Z^3
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords];
    phases::combine(s, kAZ3p, c, r);
    st(s, kAZ3 + c, r);
  }
};

struct AddH : phases::Linear<2> {  // H = U2 - X
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::combine(s, kAU2p, c, t);
    ld(s, kX + c, u);
    phases::sub(t, u, r);
    st(s, kAH + c, r);
  }
};

struct AddS2 : phases::Products<3> {  // yq Z^3
  static FP384_FN int operands(int h, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::kara(s, kYq, h, x);
    phases::kara(s, kAZ3, h, y);
    return kAS2p + h;
  }
};

struct AddDenP : phases::Products<3> {  // Z (-H)
  static FP384_FN int operands(int h, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    uint32_t a0[kWords], a1[kWords], t[kWords];
    ld(s, kAH, t);
    phases::neg(t, a0);
    ld(s, kAH + 1, t);
    phases::neg(t, a1);
    phases::kara(s, kZ, h, x);
    phases::kara(a0, a1, h, y);
    return kADenp + h;
  }
};

struct AddI : phases::Products<2> {  // I = (2 H)^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    uint32_t a0[kWords], a1[kWords];
    phases::ld_add(s, kAH, kAH, a0);
    phases::ld_add(s, kAH + 1, kAH + 1, a1);
    phases::csqr(a0, a1, c, x, y);
    return kAI + c;
  }
};

struct AddHsq : phases::Products<2> {  // H^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kAH, c, x, y);
    return kAHsq + c;
  }
};

struct AddZH : phases::Products<2> {  // (Z + H)^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    uint32_t a0[kWords], a1[kWords];
    phases::ld_add(s, kZ, kAH, a0);
    phases::ld_add(s, kZ + 1, kAH + 1, a1);
    phases::csqr(a0, a1, c, x, y);
    return kAZH + c;
  }
};

struct AddDen : phases::Linear<2> {
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords];
    phases::combine(s, kADenp, c, r);
    st(s, kADen + c, r);
  }
};

struct AddNumR : phases::Linear<2> {  // num = Y - S2, r = 2 (S2 - Y)
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::combine(s, kAS2p, c, t);
    ld(s, kY + c, u);
    phases::sub(u, t, r);
    st(s, kANum + c, r);
    phases::sub(t, u, r);
    phases::add(r, r, u);
    st(s, kAR + c, u);
  }
};

struct AddZ3 : phases::Linear<2> {  // Z3 = ((Z + H)^2 - Z^2) - H^2
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::ld_sub(s, kAZH + c, kAZsq + c, r);
    ld(s, kAHsq + c, u);
    phases::sub(r, u, t);
    st(s, kZ + c, t);
  }
};

struct AddLine : phases::Products<4> {  // c_v2 = den yp, c_wv = num (-xp)
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    ld(s, (k < 2 ? kADen : kANum) + k % 2, x);
    ld(s, k < 2 ? kYp : kNxp, y);
    return (k < 2 ? kLineV2 : kLineWV) + k % 2;
  }
};

struct AddKara : phases::Products<12> {  // xq num, yq den, H I, X I
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int g = k / 3, h = k % 3;
    phases::kara(s, g == 0 ? kXq : g == 1 ? kYq : g == 2 ? kAH : kX, h, x);
    phases::kara(s, g == 0 ? kANum : g == 1 ? kADen : kAI, h, y);
    return kAXNp + k;
  }
};

struct AddRsq : phases::Products<2> {  // r^2
  static FP384_FN int operands(int c, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::csqr(s, kAR, c, x, y);
    return kARsq + c;
  }
};

struct AddCw : phases::Linear<2> {  // c_w = xq num - yq den
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::combine(s, kAXNp, c, t);
    phases::combine(s, kAYDp, c, u);
    phases::sub(t, u, r);
    st(s, kLineW + c, r);
  }
};

struct AddX3 : phases::Linear<2> {  // J; X3 = (r^2 - J) - 2 V; V - X3
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords], j[kWords], v[kWords];
    phases::combine(s, kAJp, c, j);
    st(s, kAJ + c, j);
    phases::combine(s, kAVp, c, v);
    ld(s, kARsq + c, t);
    phases::sub(t, j, u);
    phases::add(v, v, t);
    phases::sub(u, t, r);
    st(s, kX + c, r);
    phases::sub(v, r, t);
    st(s, kAVmX3 + c, t);
  }
};

struct AddP7 : phases::Products<6> {  // r (V - X3), Y J
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    phases::kara(s, k < 3 ? kAR : kY, k % 3, x);
    phases::kara(s, k < 3 ? kAVmX3 : kAJ, k % 3, y);
    return kARVp + k;
  }
};

struct AddL8 : phases::Linear<2> {  // Y3 = r (V - X3) - 2 Y J
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t r[kWords], t[kWords], u[kWords];
    phases::combine(s, kARVp, c, t);
    phases::combine(s, kAYJp, c, u);
    phases::add(u, u, r);
    phases::sub(t, r, u);
    st(s, kY + c, u);
  }
};

// --- the plans --------------------------------------------------------------
//
// A doubling: f^2's phases beside the step's, the step's first products
// in f^2's round, then f times the line once the line and f^2 are done.
// Four rounds of products (47, 15, 8, 54) and ten phases of adds.
using Double = phases::Plan<
    phases::Beside<SqPreSum, TimesVKinds<SqPreV>>,
    Sq::Sums,
    phases::Beside<Sq::Products, DblSquares, DblYZ, DblYyp>,
    phases::Beside<Sq::Fp2Combine, DblPre1>,
    phases::Beside<DblCubes, DblC, DblT, DblE>,
    phases::Beside<Sq::Fp6Combine, DblZ3M1, DblX3, DblZ3, DblCw, DblYyp2>,
    phases::Beside<DblM0, DblY3p, DblCwv>,
    phases::Beside<TimesVKinds<SqPost0>, SqPost1, DblCv2, DblY3>,
    MlPre,
    Ml::Sums,
    Ml::Products,
    Ml::Fp2Combine,
    Ml::Fp6Combine,
    phases::Beside<TimesVKinds<MlPost0>, MlPost1>>;

// An addition: the step, then f times the chord, whose products share a
// round with the step's last and whose first combine shares Y3's phase.
// Five rounds of products (2, 6, 12, 18, 60) and eight phases of adds.
using Add = phases::Plan<
    AddP0,
    AddP1,
    phases::Beside<AddZcube, AddH>,
    phases::Beside<AddS2, AddDenP, AddI, AddHsq, AddZH>,
    phases::Beside<AddDen, AddNumR, AddZ3>,
    phases::Beside<AddLine, AddKara, AddRsq>,
    phases::Beside<AddCw, AddX3>,
    MlPre,
    Ml::Sums,
    phases::Beside<Ml::Products, AddP7>,
    phases::Beside<Ml::Fp2Combine, AddL8>,
    Ml::Fp6Combine,
    phases::Beside<TimesVKinds<MlPost0>, MlPost1>>;

using Start = phases::Plan<Init>;
using Finish = phases::Plan<Conj>;

constexpr int kThreads = phases::block_threads<Start, Double, Add, Finish>();
static_assert(kThreads <= 256, "one block of at most 8 warps per lane");

// --- the schedule -----------------------------------------------------------

// The doublings of |x|'s schedule, and which of them an addition follows
// (bit i: after doubling i).
constexpr int doublings() {
  constexpr int dbl[] = {HARMONY_MILLER_DBL};
  int n = 0;
  for (int d : dbl) n += d;
  return n;
}

constexpr uint64_t additions() {
  constexpr int dbl[] = {HARMONY_MILLER_DBL};
  constexpr int add[] = {HARMONY_MILLER_ADD};
  static_assert(sizeof(dbl) == sizeof(add), "one entry per segment");
  uint64_t mask = 0;
  int i = 0;
  for (int g = 0; g < static_cast<int>(sizeof(dbl) / sizeof(dbl[0])); ++g) {
    i += dbl[g];
    if (add[g]) mask |= uint64_t{1} << (i - 1);
  }
  return mask;
}

constexpr int kDoublings = doublings();
constexpr uint64_t kAdditions = additions();
static_assert(kDoublings >= 1 && kDoublings <= 64, "|x| has 64 bits");

// The whole loop on one lane whose P and Q are loaded: `run` runs a plan
// and returns false if the plan's tasks conflicted (the host test's
// runner; the card's never does).  One doubling body and one addition
// body, looped over the schedule at run time.
template <class Run>
FP384_FN bool loop(const Run& run) {
  bool ok = run(Start{});
  FP384_ROLLED
  for (int i = 0; i < kDoublings; ++i) {
    ok = run(Double{}) && ok;
    if (kAdditions >> i & 1u) ok = run(Add{}) && ok;
  }
  return run(Finish{}) && ok;
}

}  // namespace miller
