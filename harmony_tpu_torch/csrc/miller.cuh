// The Miller loop of the optimal ate pairing over BLS12-381 for one lane,
// written as phases of independent tasks over a scratch area, as fp12.cuh
// writes the Fp12 operations.  Shared by the CUDA kernel (miller_loop.cu)
// and, as plain C++, by the host test of its phase plans
// (tests/test_torch_miller_host.py).
//
// The loop is the port's (ops/pairing.py miller_loop_reference) and the
// JAX package's: f_{|x|,Q}(P), conjugated, over |x|'s static schedule.
// Each doubling of the twist point T squares f and multiplies it by the
// tangent line at P; each addition of the affine Q multiplies f by the
// chord.  The steps are the port's _dbl_step (tangent line and
// dbl-2009-l) and _add_step (chord line and madd-2007-bl), the same
// polynomials in the same inputs.  Every element is canonical, so each
// add, sub and product gives the plain version's limbs, whatever the
// formula: Fp2 products here are Karatsuba, squarings the complex method,
// and f^2 is the fp12_mul plan on (f, f).
//
// The schedule and the Montgomery form of 1 come from the generated header
// (kernels/_build.py params_header):
//   HARMONY_MILLER_DBL      per segment, the number of doublings
//   HARMONY_MILLER_ADD      per segment, 1 if an addition follows
//   HARMONY_ONE_MONT_WORDS  2^384 mod p as 12 words
//
// A lane's state stays in its scratch area for the whole loop:
//   [0, 162)    the fp12_mul plan's scratch: f at its operand a (which is
//               also its output), the second operand b (a copy of f, or
//               the line as a dense Fp12 with zeros in the empty slots),
//               and its intermediates, which a step uses for its own
//               between two products
//   [162, 176)  the twist point X, Y, Z, the affine Q and P, -xp, -3 xp
//
// A phase's tasks read only what earlier phases wrote and write disjoint
// elements.  In the phases of products every task ends in the same
// Montgomery product: it forms its two operands (loads and a few adds,
// which may differ from task to task), then all of a warp's threads
// multiply together.

#pragma once

#include <cstdint>

#include "fp12.cuh"

#if !defined(HARMONY_MILLER_DBL) || !defined(HARMONY_MILLER_ADD) || \
    !defined(HARMONY_ONE_MONT_WORDS)
#error "build through harmony_tpu_torch/kernels/_build.py, which defines the schedule"
#endif

namespace miller {

using fp12::ld;
using fp12::st;
using fp384::kWords;

// --- the lane's scratch area (in elements of 12 words) ----------------------

constexpr int kF = fp12::kMulA;      // 12: f, and the product's output
constexpr int kB = fp12::kMulB;      // 12: a copy of f, or the line
constexpr int kT = fp12::kMulS12;    // a step's intermediates, up to 162
constexpr int kX = fp12::kMulScratch;  // the twist point (Fp2 each)
constexpr int kY = kX + 2;
constexpr int kZ = kX + 4;
constexpr int kXq = kX + 6;   // affine Q: xq, then yq
constexpr int kYq = kX + 8;
constexpr int kXp = kX + 10;  // affine P: xp, then yp
constexpr int kYp = kX + 11;
constexpr int kNxp = kX + 12;   // -xp
constexpr int kNxp3 = kX + 13;  // -3 xp
constexpr int kScratch = kX + 14;  // 176 elements, 8,448 B

// The line c_v2 v^2 + c_w w + c_wv w v as the dense Fp12 operand b
// (element 6 i12 + 2 i6 + i2, ops/pairing.py _sparse_line_to_fp12).
constexpr int kLineV2 = kB + 4;
constexpr int kLineW = kB + 6;
constexpr int kLineWV = kB + 8;

// Which of b's elements a line leaves zero: task k of 6.
FP384_FN int line_zero(int k) { return kB + (k < 4 ? k : k + 6); }

// --- Fp2 helpers (components at elements i, i + 1) ---------------------------

FP384_FN void copy(const uint32_t a[kWords], uint32_t out[kWords]) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) out[j] = a[j];
}

FP384_FN void ld2(const uint32_t* s, int i, uint32_t a[2][kWords]) {
  ld(s, i, a[0]);
  ld(s, i + 1, a[1]);
}

FP384_FN void zero(uint32_t a[kWords]) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) a[j] = 0;
}

// 2 a, 3 a and 8 a by additions (ops/pairing.py _small).
FP384_FN void times2(const uint32_t a[kWords], uint32_t out[kWords]) {
  fp384::add(a, a, out);
}

FP384_FN void times3(const uint32_t a[kWords], uint32_t out[kWords]) {
  uint32_t t[kWords];
  fp384::add(a, a, t);
  fp384::add(t, a, out);
}

FP384_FN void times8(const uint32_t a[kWords], uint32_t out[kWords]) {
  uint32_t t[kWords], u[kWords];
  fp384::add(a, a, t);
  fp384::add(t, t, u);
  fp384::add(u, u, out);
}

// The operands of Fp product h of the Karatsuba product a b over Fp2:
// a0 b0, a1 b1, (a0 + a1)(b0 + b1).
FP384_FN void kara(const uint32_t a[2][kWords], const uint32_t b[2][kWords],
                   int h, uint32_t x[kWords], uint32_t y[kWords]) {
  if (h < 2) {
    copy(a[h], x);
    copy(b[h], y);
  } else {
    fp384::add(a[0], a[1], x);
    fp384::add(b[0], b[1], y);
  }
}

// The operands of component c of the complex squaring of a:
// c0 = (a0 + a1)(a0 - a1), c1 = a0 (a1 + a1).
FP384_FN void csqr(const uint32_t a[2][kWords], int c, uint32_t x[kWords],
                   uint32_t y[kWords]) {
  if (c == 0) {
    fp384::add(a[0], a[1], x);
    fp384::sub(a[0], a[1], y);
  } else {
    copy(a[0], x);
    fp384::add(a[1], a[1], y);
  }
}

// Component c of a Karatsuba product from its three Fp products at v:
// c0 = v0 - v1, c1 = v2 - (v0 + v1).
FP384_FN void combine(const uint32_t* s, int v, int c, uint32_t out[kWords]) {
  uint32_t v0[kWords], v1[kWords];
  ld(s, v, v0);
  ld(s, v + 1, v1);
  if (c == 0) {
    fp384::sub(v0, v1, out);
  } else {
    uint32_t t[kWords], v2[kWords];
    fp384::add(v0, v1, t);
    ld(s, v + 2, v2);
    fp384::sub(v2, t, out);
  }
}

// The Fp2 sum of the values at i and j, into a; an operand such as X + Y^2.
FP384_FN void ld2_add(const uint32_t* s, int i, int j, uint32_t a[2][kWords]) {
  for (int c = 0; c < 2; ++c) fp12::ld_add(s, i + c, j + c, a[c]);
}

// --- init: f = 1, T = Q, and the constants of P -----------------------------
//
// Before it, the kernel has loaded xp, yp at kXp and xq, yq at kXq.

constexpr int kInitTasks = 20;

FP384_FN void init_task(int k, uint32_t* s) {
  constexpr uint32_t one[kWords] = {HARMONY_ONE_MONT_WORDS};
  uint32_t r[kWords];
  if (k < 12 || k == 13) {  // f = 1, Z = 1 + 0 u
    if (k == 0) {
      copy(one, r);
    } else {
      zero(r);
    }
    st(s, k < 12 ? kF + k : kZ + 1, r);
  } else if (k == 12) {
    st(s, kZ, one);
  } else if (k < 18) {  // X, Y = xq, yq
    ld(s, kXq + k - 14, r);
    st(s, kX + k - 14, r);
  } else {  // -xp, -3 xp
    uint32_t xp[kWords], t[kWords];
    ld(s, kXp, xp);
    if (k == 18) {
      copy(xp, t);
    } else {
      times3(xp, t);
    }
    fp384::neg(t, r);
    st(s, k == 18 ? kNxp : kNxp3, r);
  }
}

// --- the doubling step (ops/pairing.py _dbl_step) ----------------------------
//
// From T = (X, Y, Z), -3 xp and yp: the tangent line's c_v2 = 2 Y Z^3 yp,
// c_wv = -3 X^2 Z^2 xp, c_w = 3 X^3 - 2 Y^2 into b, and 2T into T by
// dbl-2009-l: with c = Y^4, t = (X + Y^2)^2, d = 2 (t - X^2 - c),
// e = 3 X^2: X3 = e^2 - 2 d, Y3 = e (d - X3) - 8 c, Z3 = 2 Y Z.
//
//   phase  tasks  writes
//   0      9+6    X^2, Y^2, Z^2 (complex), Y Z (Karatsuba); b's zeros
//   1      15     Z^3 = Z^2 Z, X^3, X^2 Z^2 (Karatsuba); c, t, e^2 (complex)
//   2      10     Z^3, X^2 Z^2; X3 and d - X3; Z3 = 2 Y Z; c_w
//   3      8      (2 Y) Z^3, e (d - X3) (Karatsuba); c_wv = X^2 Z^2 (-3 xp)
//   4      2+2    c_v2 = (2 Y Z^3) yp; Y3 = e (d - X3) - 8 c

constexpr int kDblPhases = 5;
constexpr int kDXsq = kT;        // 2: X^2
constexpr int kDYsq = kT + 2;    // 2: Y^2
constexpr int kDZsq = kT + 4;    // 2: Z^2
constexpr int kDYZ = kT + 6;     // 3: products of Y Z
constexpr int kDZ3p = kT + 9;    // 3: products of Z^2 Z
constexpr int kDX3p = kT + 12;   // 3: products of X^2 X
constexpr int kDM1p = kT + 15;   // 3: products of X^2 Z^2
constexpr int kDC = kT + 18;     // 2: c = (Y^2)^2
constexpr int kDTsq = kT + 20;   // 2: t = (X + Y^2)^2
constexpr int kDEsq = kT + 22;   // 2: e^2
constexpr int kDZ3 = kT + 24;    // 2: Z^3
constexpr int kDM1 = kT + 26;    // 2: X^2 Z^2
constexpr int kDDmX3 = kT + 28;  // 2: d - X3
constexpr int kDM0p = kT + 30;   // 3: products of (2 Y) Z^3
constexpr int kDY3p = kT + 33;   // 3: products of e (d - X3)

FP384_FN int dbl_tasks(int phase) {
  switch (phase) {
    case 0: case 1: return 15;
    case 2: return 10;
    case 3: return 8;
    default: return 4;
  }
}

// e = 3 X^2, from X^2 at kDXsq.
FP384_FN void ld_e(const uint32_t* s, uint32_t e[2][kWords]) {
  uint32_t t[kWords];
  for (int c = 0; c < 2; ++c) {
    ld(s, kDXsq + c, t);
    times3(t, e[c]);
  }
}

// Task k of phase `phase`: a product task forms x and y and returns where
// their product goes; any other task does its work and returns -1.
FP384_FN int dbl_prepare(int phase, int k, uint32_t* s, uint32_t x[kWords],
                         uint32_t y[kWords]) {
  uint32_t a[2][kWords], b[2][kWords];
  switch (phase) {
    case 0:
      if (k < 6) {  // X^2, Y^2, Z^2
        ld2(s, kX + 2 * (k / 2), a);
        csqr(a, k % 2, x, y);
        return kDXsq + k;
      }
      if (k < 9) {  // Y Z
        ld2(s, kY, a);
        ld2(s, kZ, b);
        kara(a, b, k - 6, x, y);
        return kDYZ + k - 6;
      }
      zero(x);
      st(s, line_zero(k - 9), x);
      return -1;
    case 1:
      if (k < 9) {  // Z^2 Z, X^2 X, X^2 Z^2
        const int g = k / 3;
        ld2(s, g == 0 ? kDZsq : kDXsq, a);
        ld2(s, g == 0 ? kZ : g == 1 ? kX : kDZsq, b);
        kara(a, b, k % 3, x, y);
        return kDZ3p + k;
      }
      if (k < 11) {  // c = (Y^2)^2
        ld2(s, kDYsq, a);
      } else if (k < 13) {  // t = (X + Y^2)^2
        ld2_add(s, kX, kDYsq, a);
      } else {  // e^2
        ld_e(s, a);
      }
      csqr(a, (k - 9) % 2, x, y);
      return kDC + k - 9;
    case 2: {
      const int c = k % 2;
      uint32_t r[kWords], t[kWords], u[kWords];
      if (k < 4) {  // Z^3, X^2 Z^2
        combine(s, k < 2 ? kDZ3p : kDM1p, c, r);
        st(s, (k < 2 ? kDZ3 : kDM1) + c, r);
      } else if (k < 6) {  // d = 2 ((t - X^2) - c), X3 = e^2 - 2 d
        ld(s, kDTsq + c, t);
        ld(s, kDXsq + c, u);
        fp384::sub(t, u, r);
        ld(s, kDC + c, u);
        fp384::sub(r, u, t);
        uint32_t d[kWords], d2[kWords], x3[kWords];
        times2(t, d);
        times2(d, d2);
        ld(s, kDEsq + c, u);
        fp384::sub(u, d2, x3);
        st(s, kX + c, x3);
        fp384::sub(d, x3, r);
        st(s, kDDmX3 + c, r);
      } else if (k < 8) {  // Z3 = 2 Y Z
        combine(s, kDYZ, c, t);
        times2(t, r);
        st(s, kZ + c, r);
      } else {  // c_w = 3 X^3 - 2 Y^2
        uint32_t y2[kWords];
        combine(s, kDX3p, c, t);
        times3(t, u);
        ld(s, kDYsq + c, t);
        times2(t, y2);
        fp384::sub(u, y2, r);
        st(s, kLineW + c, r);
      }
      return -1;
    }
    case 3:
      if (k < 3) {  // (2 Y) Z^3
        ld2(s, kY, b);
        times2(b[0], a[0]);
        times2(b[1], a[1]);
        ld2(s, kDZ3, b);
        kara(a, b, k, x, y);
        return kDM0p + k;
      }
      if (k < 6) {  // e (d - X3)
        ld_e(s, a);
        ld2(s, kDDmX3, b);
        kara(a, b, k - 3, x, y);
        return kDY3p + k - 3;
      }
      ld(s, kDM1 + k - 6, x);  // c_wv = X^2 Z^2 (-3 xp)
      ld(s, kNxp3, y);
      return kLineWV + k - 6;
    default: {  // phase 4
      const int c = k % 2;
      if (k < 2) {  // c_v2 = (2 Y Z^3) yp
        combine(s, kDM0p, c, x);
        ld(s, kYp, y);
        return kLineV2 + c;
      }
      uint32_t r[kWords], t[kWords], u[kWords];  // Y3 = e (d - X3) - 8 c
      combine(s, kDY3p, c, t);
      ld(s, kDC + c, u);
      times8(u, r);
      fp384::sub(t, r, u);
      st(s, kY + c, u);
      return -1;
    }
  }
}

// --- the addition step (ops/pairing.py _add_step) ----------------------------
//
// From T = (X, Y, Z), the affine Q = (xq, yq), -xp and yp: with
// S2 = yq Z^3, U2 = xq Z^2, num = Y - S2, H = U2 - X, den = Z (-H), the
// chord's c_v2 = den yp, c_wv = num (-xp), c_w = xq num - yq den into b,
// and T + Q into T by madd-2007-bl: with r = 2 (S2 - Y), I = (2 H)^2,
// J = H I, V = X I: X3 = r^2 - J - 2 V, Y3 = r (V - X3) - 2 Y J,
// Z3 = (Z + H)^2 - Z^2 - H^2.
//
//   phase  tasks  writes
//   0      2+6    Z^2 (complex); b's zeros
//   1      6      Z^2 Z, xq Z^2 (Karatsuba)
//   2      4      Z^3, H = U2 - X
//   3      12     yq Z^3, Z (-H) (Karatsuba); I, H^2, (Z + H)^2 (complex)
//   4      6      den; num and r; Z3
//   5      18     c_v2, c_wv; xq num, yq den, H I, X I (Karatsuba); r^2
//   6      4      c_w; J, X3 and V - X3
//   7      6      r (V - X3), Y J (Karatsuba)
//   8      2      Y3

constexpr int kAddPhases = 9;
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

FP384_FN int add_tasks(int phase) {
  switch (phase) {
    case 0: return 8;
    case 2: case 6: return 4;
    case 3: return 12;
    case 5: return 18;
    case 8: return 2;
    default: return 6;
  }
}

FP384_FN int add_prepare(int phase, int k, uint32_t* s, uint32_t x[kWords],
                         uint32_t y[kWords]) {
  uint32_t a[2][kWords], b[2][kWords];
  switch (phase) {
    case 0:
      if (k < 2) {  // Z^2
        ld2(s, kZ, a);
        csqr(a, k, x, y);
        return kAZsq + k;
      }
      zero(x);
      st(s, line_zero(k - 2), x);
      return -1;
    case 1:  // Z^2 Z, xq Z^2
      ld2(s, k < 3 ? kZ : kXq, a);
      ld2(s, kAZsq, b);
      kara(a, b, k % 3, x, y);
      return kAZ3p + k;
    case 2: {
      const int c = k % 2;
      uint32_t r[kWords], t[kWords], u[kWords];
      if (k < 2) {  // Z^3
        combine(s, kAZ3p, c, r);
        st(s, kAZ3 + c, r);
      } else {  // H = U2 - X
        combine(s, kAU2p, c, t);
        ld(s, kX + c, u);
        fp384::sub(t, u, r);
        st(s, kAH + c, r);
      }
      return -1;
    }
    case 3:
      if (k < 3) {  // yq Z^3
        ld2(s, kYq, a);
        ld2(s, kAZ3, b);
        kara(a, b, k, x, y);
        return kAS2p + k;
      }
      if (k < 6) {  // Z (-H)
        ld2(s, kZ, a);
        for (int c = 0; c < 2; ++c) {
          ld(s, kAH + c, x);
          fp384::neg(x, b[c]);
        }
        kara(a, b, k - 3, x, y);
        return kADenp + k - 3;
      }
      ld2(s, kAH, b);
      if (k < 8) {  // I = (2 H)^2
        times2(b[0], a[0]);
        times2(b[1], a[1]);
      } else if (k < 10) {  // H^2
        copy(b[0], a[0]);
        copy(b[1], a[1]);
      } else {  // (Z + H)^2
        ld2_add(s, kZ, kAH, a);
      }
      csqr(a, k % 2, x, y);
      return kAI + k - 6;
    case 4: {
      const int c = k % 2;
      uint32_t r[kWords], t[kWords], u[kWords];
      if (k < 2) {  // den
        combine(s, kADenp, c, r);
        st(s, kADen + c, r);
      } else if (k < 4) {  // num = Y - S2, r = 2 (S2 - Y)
        combine(s, kAS2p, c, t);
        ld(s, kY + c, u);
        fp384::sub(u, t, r);
        st(s, kANum + c, r);
        fp384::sub(t, u, r);
        times2(r, u);
        st(s, kAR + c, u);
      } else {  // Z3 = ((Z + H)^2 - Z^2) - H^2
        ld(s, kAZH + c, t);
        ld(s, kAZsq + c, u);
        fp384::sub(t, u, r);
        ld(s, kAHsq + c, u);
        fp384::sub(r, u, t);
        st(s, kZ + c, t);
      }
      return -1;
    }
    case 5:
      if (k < 4) {  // c_v2 = den yp, c_wv = num (-xp)
        ld(s, (k < 2 ? kADen : kANum) + k % 2, x);
        ld(s, k < 2 ? kYp : kNxp, y);
        return (k < 2 ? kLineV2 : kLineWV) + k % 2;
      }
      if (k < 10 || k >= 12) {  // xq num, yq den, H I, X I
        const int g = (k < 10 ? k - 4 : k - 6) / 3;  // 0, 1; 2, 3
        const int h = (k < 10 ? k - 4 : k - 6) % 3;
        ld2(s, g == 0 ? kXq : g == 1 ? kYq : g == 2 ? kAH : kX, a);
        ld2(s, g == 0 ? kANum : g == 1 ? kADen : kAI, b);
        kara(a, b, h, x, y);
        return (g == 0 ? kAXNp : g == 1 ? kAYDp : g == 2 ? kAJp : kAVp) + h;
      }
      ld2(s, kAR, a);  // r^2
      csqr(a, k - 10, x, y);
      return kARsq + k - 10;
    case 6: {
      const int c = k % 2;
      uint32_t r[kWords], t[kWords], u[kWords];
      if (k < 2) {  // c_w = xq num - yq den
        combine(s, kAXNp, c, t);
        combine(s, kAYDp, c, u);
        fp384::sub(t, u, r);
        st(s, kLineW + c, r);
      } else {  // J; X3 = (r^2 - J) - 2 V; V - X3
        uint32_t j[kWords], v[kWords];
        combine(s, kAJp, c, j);
        st(s, kAJ + c, j);
        combine(s, kAVp, c, v);
        ld(s, kARsq + c, t);
        fp384::sub(t, j, u);
        times2(v, t);
        fp384::sub(u, t, r);
        st(s, kX + c, r);
        fp384::sub(v, r, t);
        st(s, kAVmX3 + c, t);
      }
      return -1;
    }
    case 7:  // r (V - X3), Y J
      ld2(s, k < 3 ? kAR : kY, a);
      ld2(s, k < 3 ? kAVmX3 : kAJ, b);
      kara(a, b, k % 3, x, y);
      return kARVp + k;
    default: {  // phase 8: Y3 = r (V - X3) - 2 Y J
      const int c = k % 2;
      uint32_t r[kWords], t[kWords], u[kWords];
      combine(s, kARVp, c, t);
      combine(s, kAYJp, c, u);
      times2(u, r);
      fp384::sub(t, r, u);
      st(s, kY + c, u);
      return -1;
    }
  }
}

// --- the loop as a sequence of operations -----------------------------------
//
// Each doubling is kCopy (b = f), kMul (f = f f), kDbl (T = 2T, b = the
// tangent), kMul (f = f b); each addition is kAdd (T = T + Q, b = the
// chord), kMul.  kInit comes before them, kConj (f = conj(f), for x < 0)
// after.

enum Op : int { kInit, kCopy, kMul, kDbl, kAdd, kConj };

// The number of operations between kInit and kConj.
FP384_FN int steps() {
  constexpr int dbl[] = {HARMONY_MILLER_DBL};
  constexpr int add[] = {HARMONY_MILLER_ADD};
  static_assert(sizeof(dbl) == sizeof(add), "one entry per segment");
  int n = 0;
  FP384_UNROLL
  for (int g = 0; g < static_cast<int>(sizeof(dbl) / sizeof(dbl[0])); ++g) {
    n += 4 * dbl[g] + 2 * add[g];
  }
  return n;
}

// Operation i of the steps() between kInit and kConj.
FP384_FN int step_op(int i) {
  constexpr int dbl[] = {HARMONY_MILLER_DBL};
  constexpr int add[] = {HARMONY_MILLER_ADD};
  FP384_UNROLL
  for (int g = 0; g < static_cast<int>(sizeof(dbl) / sizeof(dbl[0])); ++g) {
    if (i < 4 * dbl[g]) {
      const int j = i % 4;
      return j == 0 ? kCopy : j == 2 ? kDbl : kMul;
    }
    i -= 4 * dbl[g];
    if (add[g]) {
      if (i < 2) return i == 0 ? kAdd : kMul;
      i -= 2;
    }
  }
  return -1;
}

FP384_FN int op_phases(int op) {
  switch (op) {
    case kMul: return fp12::kMulPhases;
    case kDbl: return kDblPhases;
    case kAdd: return kAddPhases;
    default: return 1;
  }
}

FP384_FN int op_tasks(int op, int phase) {
  switch (op) {
    case kInit: return kInitTasks;
    case kCopy: return fp12::kElems;
    case kMul: return fp12::mul_tasks(phase);
    case kDbl: return dbl_tasks(phase);
    case kAdd: return add_tasks(phase);
    default: return 6;  // kConj
  }
}

// Task k of phase `phase` of operation `op`.  The two steps' products are
// made at one place, after the operands are formed, so that a warp's
// threads multiply together.
FP384_FN void op_task(int op, int phase, int k, uint32_t* s) {
  uint32_t x[kWords], y[kWords];
  int out = -1;
  switch (op) {
    case kInit:
      init_task(k, s);
      break;
    case kCopy:
      ld(s, kF + k, x);
      st(s, kB + k, x);
      break;
    case kMul:
      fp12::mul_task(phase, k, s);
      break;
    case kDbl:
      out = dbl_prepare(phase, k, s, x, y);
      break;
    case kAdd:
      out = add_prepare(phase, k, s, x, y);
      break;
    default:  // kConj: negate f's w coefficient
      ld(s, kF + 6 + k, x);
      fp384::neg(x, y);
      st(s, kF + 6 + k, y);
      break;
  }
  if (out >= 0) {
    uint32_t r[kWords];
    fp384::mont_mul(x, y, r);
    st(s, out, r);
  }
}

}  // namespace miller
