// Plans of phases (phases.cuh) for products over the tower: batches of
// Fp6 products, and the dense Fp12 product, shared by the Miller loop
// (miller.cuh), the Fp12 product kernel (fp12_mul.cu) and the final
// exponentiation (final_exp.cuh).
//
// The tower is the port's (ops/towers.py): Fp2 = Fp[u]/(u^2 + 1),
// Fp6 = Fp2[v]/(v^3 - xi) with xi = u + 1, Fp12 = Fp6[w]/(w^2 - v); an
// Fp12 value is 12 scratch elements, element 6 i12 + 2 i6 + i2 the
// coefficient of w^i12 v^i6 u^i2.  Every element is canonical, so each
// product is the canonical residue of the plain version's, whatever the
// formula.

#pragma once

#include <cstdint>

#include "phases.cuh"

namespace fp12_plans {

using fp12::ld;
using fp12::st;
using fp384::kWords;

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

// --- the Fp12 product (ops/towers.py fp12_mul_reference) --------------------
//
// out = a b for the Fp12 values at kA and kB, by Karatsuba-2 over Fp6:
// a0 b0, a1 b1, (a0 + a1)(b0 + b1), 54 Fp products in one round;
// c0 = u0 + v u1, c1 = u2 - (u0 + u1).  Its intermediates take the 156
// elements from kScratch on; out may be a or b (only Post writes it, and
// it reads only the intermediates).
//
//   phase        tasks  writes
//   Pre          12     a0 + a1, b0 + b1
//   Sums ... Fp6Combine, as Fp6Products with N6 = 3
//   Post         12     out

template <int kA, int kB, int kOut, int kScratch>
struct Fp12Product {
  static constexpr int k1 = kScratch;  // 12: a0 + a1, b0 + b1
  static constexpr int kS = k1 + 12;   // 36
  static constexpr int kV = kS + 36;   // 54
  static constexpr int kW = kV + 54;   // 36
  static constexpr int kU = kW + 36;   // 18
  static constexpr int kEnd = kU + 18;

  struct Operand {
    static FP384_FN int base(int side, int f6) {
      return f6 < 2 ? (side ? kB : kA) + 6 * f6 : k1 + 6 * side;
    }
  };
  using Fp6 = Fp6Products<3, Operand, kS, kV, kW, kU>;
  using Sums = typename Fp6::Sums;
  using Products = typename Fp6::Products;
  using Fp2Combine = typename Fp6::Fp2Combine;
  using Fp6Combine = typename Fp6::Fp6Combine;

  struct Pre : phases::Linear<12> {
    static FP384_FN void task(int k, uint32_t* s) {
      const int in = k < 6 ? kA : kB, e = k % 6;
      uint32_t r[kWords];
      phases::ld_add(s, in + e, in + 6 + e, r);
      st(s, k1 + k, r);
    }
  };

  struct Post0 {  // u0 + v u1
    static FP384_FN void element(int e, uint32_t* s) {
      uint32_t t[kWords], z[kWords], r[kWords];
      times_v(s, kU + 6, e, t);
      ld(s, kU + e, z);
      phases::add(z, t, r);
      st(s, kOut + e, r);
    }
  };

  struct Post1 : phases::Linear<6> {  // u2 - (u0 + u1)
    static FP384_FN void task(int e, uint32_t* s) {
      uint32_t t[kWords], z[kWords], r[kWords];
      phases::ld_add(s, kU + e, kU + 6 + e, t);
      ld(s, kU + 12 + e, z);
      phases::sub(z, t, r);
      st(s, kOut + 6 + e, r);
    }
  };
  using Post = phases::Beside<TimesVKinds<Post0>, Post1>;

  // The product alone, six phases, one round of products.
  using Plan =
      phases::Plan<Pre, Sums, Products, Fp2Combine, Fp6Combine, Post>;
};

}  // namespace fp12_plans
