// Whole Fp12 operations of the BLS12-381 tower for one lane, written as
// phases of independent tasks over a scratch area, shared by the CUDA
// kernels (fp12_mul.cu, fp12_cyclo_sqr.cu) and, as plain C++, by the host
// test of their arithmetic and phase plans (tests/test_torch_fp12_host.py).
//
// The tower is the port's (ops/towers.py) and the JAX package's:
//   Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi) with xi = u + 1,
//   Fp12 = Fp6[w]/(w^2 - v).
// An Fp12 value is 12 Fp elements, element 6 i12 + 2 i6 + i2 being the
// coefficient of w^i12 v^i6 u^i2: the order of the (..., 2, 3, 2, 32)
// limb tensors.  Every element here is canonical (< p) and 12 words of 32
// bits (fp384.cuh), so each add, sub and product is the canonical residue
// of the plain version's, and the outputs are its limbs, bit for bit.
//
// A phase's tasks read only what earlier phases wrote and write disjoint
// elements, so they may run in any order or at once: the kernels give the
// tasks of a phase to the 32 threads of a warp and end each phase with
// __syncwarp(); the host test runs them in a loop, forward and in reverse.
// The scratch area holds elements 12 words apart; a later phase reuses the
// elements that no later phase reads.

#pragma once

#include <cstdint>

#include "fp384.cuh"

namespace fp12 {

using fp384::kWords;

constexpr int kElems = 12;  // Fp elements per Fp12 value

// Element i of the scratch area s into registers, and back.  On the card
// s is 16-byte aligned shared memory, and elements 48 bytes apart are read
// 16 bytes a thread without bank conflicts.
FP384_FN void ld(const uint32_t* s, int i, uint32_t w[kWords]) {
#if defined(__CUDA_ARCH__)
  const uint4* p = reinterpret_cast<const uint4*>(s + kWords * i);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 x = p[k];
    w[4 * k] = x.x; w[4 * k + 1] = x.y; w[4 * k + 2] = x.z; w[4 * k + 3] = x.w;
  }
#else
  for (int j = 0; j < kWords; ++j) w[j] = s[kWords * i + j];
#endif
}

FP384_FN void st(uint32_t* s, int i, const uint32_t w[kWords]) {
#if defined(__CUDA_ARCH__)
  uint4* p = reinterpret_cast<uint4*>(s + kWords * i);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    p[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  }
#else
  for (int j = 0; j < kWords; ++j) s[kWords * i + j] = w[j];
#endif
}

// out = s[x] + s[y], and out = s[x] - s[y]
FP384_FN void ld_add(const uint32_t* s, int x, int y, uint32_t out[kWords]) {
  uint32_t a[kWords], b[kWords];
  ld(s, x, a);
  ld(s, y, b);
  fp384::add(a, b, out);
}

FP384_FN void ld_sub(const uint32_t* s, int x, int y, uint32_t out[kWords]) {
  uint32_t a[kWords], b[kWords];
  ld(s, x, a);
  ld(s, y, b);
  fp384::sub(a, b, out);
}

// Component c of xi y = (y0 - y1) + (y0 + y1) u.
FP384_FN void xi_part(const uint32_t y0[kWords], const uint32_t y1[kWords],
                      int c, uint32_t out[kWords]) {
  if (c == 0) {
    fp384::sub(y0, y1, out);
  } else {
    fp384::add(y0, y1, out);
  }
}

// --- fp12_mul --------------------------------------------------------------
//
// ops/towers.py fp12_mul_reference (harmony_tpu/ops/towers.py fp12_mul):
// Karatsuba-2 over Fp6 makes three Fp6 products of the operand pairs
// f = 0, 1, 2: (a0, b0), (a1, b1), (a0 + a1, b0 + b1).  Karatsuba-3 makes
// six Fp2 products of each, g = 0..5: x0, x1, x2, x1 + x2, x0 + x1, x0 + x2
// against the same of y.  Karatsuba over Fp makes three Fp products of
// each, h = 0, 1, 2: x0 y0, x1 y1, (x0 + x1)(y0 + y1).  54 products in all,
// product (f, g, h) at index 18 f + 3 g + h.
//
//   phase  tasks  writes
//   0      12     S12: a0 + a1, b0 + b1 (the Fp6 operands f = 2)
//   1      36     S6:  the Fp2 pre-adds of each Fp6 operand (g = 3, 4, 5)
//   2      36     S2:  x0 + x1 of each Fp2 operand (h = 2)
//   3      54     V:   the 54 Montgomery products
//   4      36     W:   the 18 Fp2 products, c0 = v0 - v1, c1 = v2 - v0 - v1
//   5      18     U:   the 3 Fp6 products from their 6 Fp2 products each
//   6      12     Out: c0 = u0 + v u1 (w^2 = v), c1 = u2 - u0 - u1
//
// The squaring fp12_sqr is this product on (a, a): the limbs are the same
// as the plain version's complex method, since both are canonical.

constexpr int kMulPhases = 7;
constexpr int kMulA = 0;     // 12: input a
constexpr int kMulB = 12;    // 12: input b
constexpr int kMulS12 = 24;  // 12: [side][element of the Fp6]
constexpr int kMulS6 = 36;   // 36: [side][f][sum][component]
constexpr int kMulS2 = 72;   // 36: [side][f][g]
constexpr int kMulV = 108;   // 54: [f][g][h]
constexpr int kMulW = kMulS6;  // 36: [f][g][component], after phase 3
constexpr int kMulU = kMulS2;  // 18: [f][coefficient][component]
constexpr int kMulOut = kMulA;  // 12, after phase 3
constexpr int kMulScratch = 162;  // elements

FP384_FN int mul_tasks(int phase) {
  switch (phase) {
    case 0: case 6: return 12;
    case 3: return 54;
    case 5: return 18;
    default: return 36;
  }
}

// Scratch index of element e (0..5) of the Fp6 operand f of side 0 (a) or
// 1 (b).
FP384_FN int mul_fp6(int side, int f, int e) {
  return f < 2 ? (side ? kMulB : kMulA) + 6 * f + e : kMulS12 + 6 * side + e;
}

// Component c of the Fp2 operand g of Fp6 operand f.
FP384_FN int mul_fp2(int side, int f, int g, int c) {
  return g < 3 ? mul_fp6(side, f, 2 * g + c)
               : kMulS6 + ((side * 3 + f) * 3 + g - 3) * 2 + c;
}

// The Fp operand h of Fp2 operand (f, g).
FP384_FN int mul_fp(int side, int f, int g, int h) {
  return h < 2 ? mul_fp2(side, f, g, h) : kMulS2 + side * 18 + f * 6 + g;
}

FP384_FN void mul_task(int phase, int k, uint32_t* s) {
  uint32_t r[kWords];
  switch (phase) {
    case 0: {  // a0 + a1, b0 + b1
      const int side = k / 6, e = k % 6, in = side ? kMulB : kMulA;
      ld_add(s, in + e, in + 6 + e, r);
      st(s, kMulS12 + k, r);
      break;
    }
    case 1: {  // x1 + x2, x0 + x1, x0 + x2 of each Fp6 operand
      constexpr int kPairs[3][2] = {{1, 2}, {0, 1}, {0, 2}};
      const int c = k % 2, sum = k / 2 % 3, f = k / 6 % 3, side = k / 18;
      ld_add(s, mul_fp6(side, f, 2 * kPairs[sum][0] + c),
             mul_fp6(side, f, 2 * kPairs[sum][1] + c), r);
      st(s, kMulS6 + k, r);
      break;
    }
    case 2: {  // x0 + x1 of each Fp2 operand
      const int side = k / 18, f = k % 18 / 6, g = k % 6;
      ld_add(s, mul_fp2(side, f, g, 0), mul_fp2(side, f, g, 1), r);
      st(s, kMulS2 + k, r);
      break;
    }
    case 3: {
      const int f = k / 18, g = k % 18 / 3, h = k % 3;
      uint32_t x[kWords], y[kWords];
      ld(s, mul_fp(0, f, g, h), x);
      ld(s, mul_fp(1, f, g, h), y);
      fp384::mont_mul(x, y, r);
      st(s, kMulV + k, r);
      break;
    }
    case 4: {  // fp2_mul: c0 = v0 - v1, c1 = v2 - (v0 + v1)
      const int v = kMulV + 3 * (k / 2);
      if (k % 2 == 0) {
        ld_sub(s, v, v + 1, r);
      } else {
        uint32_t t[kWords], z[kWords];
        ld_add(s, v, v + 1, t);
        ld(s, v + 2, z);
        fp384::sub(z, t, r);
      }
      st(s, kMulW + k, r);
      break;
    }
    case 5: {  // fp6_mul's post-combine; W[f] holds v0, v1, v2, v12, v01, v02
      const int f = k / 6, j = k / 2 % 3, c = k % 2;
      const int w = kMulW + 12 * f;  // Fp2 product g, component c: w + 2 g + c
      uint32_t t[kWords], z[kWords];
      if (j == 0) {  // c0 = v0 + xi (v12 - (v1 + v2))
        uint32_t d[2][kWords];
        for (int cc = 0; cc < 2; ++cc) {
          ld_add(s, w + 2 + cc, w + 4 + cc, t);
          ld(s, w + 6 + cc, z);
          fp384::sub(z, t, d[cc]);
        }
        xi_part(d[0], d[1], c, t);
        ld(s, w + c, z);
        fp384::add(z, t, r);
      } else {  // c1 = (v01 - (v0 + v1)) + xi v2, c2 = (v02 - (v0 + v2)) + v1
        const int other = j == 1 ? 1 : 2, cross = j == 1 ? 4 : 5;
        uint32_t d[kWords];
        ld_add(s, w + c, w + 2 * other + c, t);
        ld(s, w + 2 * cross + c, z);
        fp384::sub(z, t, d);
        if (j == 1) {
          uint32_t y0[kWords], y1[kWords];
          ld(s, w + 4, y0);
          ld(s, w + 5, y1);
          xi_part(y0, y1, c, z);
        } else {
          ld(s, w + 2 + c, z);
        }
        fp384::add(d, z, r);
      }
      st(s, kMulU + k, r);
      break;
    }
    case 6: {  // c0 = u0 + v u1, v (y0, y1, y2) = (xi y2, y0, y1); c1 = u2 - (u0 + u1)
      const int e = k % 6, c = k % 2;
      uint32_t t[kWords], z[kWords];
      if (k < 6) {
        if (e < 2) {
          uint32_t y0[kWords], y1[kWords];
          ld(s, kMulU + 6 + 4, y0);
          ld(s, kMulU + 6 + 5, y1);
          xi_part(y0, y1, c, t);
        } else {
          ld(s, kMulU + 6 + e - 2, t);
        }
        ld(s, kMulU + e, z);
        fp384::add(z, t, r);
      } else {
        ld_add(s, kMulU + e, kMulU + 6 + e, t);
        ld(s, kMulU + 12 + e, z);
        fp384::sub(z, t, r);
      }
      st(s, kMulOut + k, r);
      break;
    }
  }
}

// --- fp12_cyclo_sqr --------------------------------------------------------
//
// ops/towers.py fp12_cyclo_sqr_reference (harmony_tpu/ops/towers.py
// fp12_cyclo_sqr), the Granger-Scott squaring, the same polynomial: with
// the Fp2 coefficients c0..c5 (c_k at Fp2 index k, so c0, c1, c2 are the
// v-coefficients of w^0 and c3, c4, c5 those of w^1), nine Fp2 squarings
// of c4, c0, c4 + c0, c3, c2, c3 + c2, c5, c1, c5 + c1 (each (x0 + x1)
// (x0 - x1) + 2 x0 x1 u: 18 Fp products), then t0..t8 and z0..z5.  Round r
// of a run of squarings reads the value in buffer r % 2 and writes the
// next into the other.
//
//   phase  tasks  writes
//   0      18     Sq: the 18 products, pre-adds done in registers
//   1      12     the next value: z0 = 3 t0 - 2 c0 ... z5 = 3 t7 + 2 c5

constexpr int kCycloPhases = 2;
constexpr int kCycloSq = 24;       // 18: [squaring][component]
constexpr int kCycloScratch = 42;  // elements: two values and Sq

FP384_FN int cyclo_tasks(int phase) { return phase == 0 ? 18 : 12; }

// Where round r's input lies (round n's is the result of n squarings).
FP384_FN int cyclo_value(int round) { return (round % 2) * kElems; }

FP384_FN void cyclo_task(int phase, int k, int round, uint32_t* s) {
  const int in = cyclo_value(round);
  uint32_t r[kWords];
  if (phase == 0) {
    // squaring q = k / 2 of Fp2 coefficient pair (c4, c0), (c3, c2) or
    // (c5, c1): the first, the second, or their sum
    const int q = k / 2, c = k % 2;
    constexpr int kPairs[3][2] = {{4, 0}, {3, 2}, {5, 1}};
    const int* pair = kPairs[q / 3];
    uint32_t x0[kWords], x1[kWords], t[kWords], z[kWords];
    if (q % 3 < 2) {
      ld(s, in + 2 * pair[q % 3], x0);
      ld(s, in + 2 * pair[q % 3] + 1, x1);
    } else {
      ld_add(s, in + 2 * pair[0], in + 2 * pair[1], x0);
      ld_add(s, in + 2 * pair[0] + 1, in + 2 * pair[1] + 1, x1);
    }
    if (c == 0) {  // (x0 + x1)(x0 - x1)
      fp384::add(x0, x1, t);
      fp384::sub(x0, x1, z);
      fp384::mont_mul(t, z, r);
    } else {  // x0 (x1 + x1)
      fp384::add(x1, x1, t);
      fp384::mont_mul(x0, t, r);
    }
    st(s, kCycloSq + k, r);
    return;
  }
  // z_i, component c, from its t and c_i; Fp2 squaring q, component cc,
  // is element kCycloSq + 2 q + cc
  const int i = k / 2, c = k % 2;
  uint32_t t[kWords], a[kWords], b[kWords];
  if (i < 3) {
    // t0 = xi sq(c4) + sq(c0), t2 = xi sq(c2) + sq(c3),
    // t4 = xi sq(c5) + sq(c1): squarings (0, 1), (4, 3), (6, 7)
    constexpr int kXi[3] = {0, 4, 6}, kPlus[3] = {1, 3, 7};
    uint32_t y0[kWords], y1[kWords];
    ld(s, kCycloSq + 2 * kXi[i], y0);
    ld(s, kCycloSq + 2 * kXi[i] + 1, y1);
    xi_part(y0, y1, c, a);
    ld(s, kCycloSq + 2 * kPlus[i] + c, b);
    fp384::add(a, b, t);
  } else {
    // t8 = xi (sq(c5 + c1) - (sq(c5) + sq(c1))),
    // t6 = sq(c4 + c0) - (sq(c4) + sq(c0)), t7 = sq(c3 + c2) - (sq(c3) + sq(c2)):
    // squarings q, q + 1, q + 2 for q = 6, 0, 3
    constexpr int kFirst[3] = {6, 0, 3};
    const int sq = kCycloSq + 2 * kFirst[i - 3];
    uint32_t d[2][kWords];
    for (int cc = 0; cc < 2; ++cc) {
      if (i > 3 && cc != c) continue;  // t6, t7: component c alone
      ld_add(s, sq + cc, sq + 2 + cc, a);
      ld(s, sq + 4 + cc, b);
      fp384::sub(b, a, d[cc]);
    }
    if (i == 3) {
      xi_part(d[0], d[1], c, t);
    } else {
      for (int w = 0; w < kWords; ++w) t[w] = d[c][w];
    }
  }
  // z = (t - c_i) + (t - c_i) + t for i < 3, (t + c_i) + (t + c_i) + t after
  ld(s, in + k, a);
  if (i < 3) {
    fp384::sub(t, a, b);
  } else {
    fp384::add(t, a, b);
  }
  fp384::add(b, b, a);
  fp384::add(a, t, r);
  st(s, cyclo_value(round + 1) + k, r);
}

}  // namespace fp12
