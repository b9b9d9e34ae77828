// The Granger-Scott cyclotomic squaring of one lane's Fp12 value as a
// plan of phases (phases.cuh), run by fp12_cyclo_sqr.cu on the card and,
// as plain C++, by the host test of its plan (tests/test_torch_fp12_host.py).
//
// ops/towers.py fp12_cyclo_sqr_reference (harmony_tpu/ops/towers.py
// fp12_cyclo_sqr), the same polynomial: with the Fp2 coefficients c0..c5
// of the value (c_k at Fp2 index k: c0, c1, c2 are the v-coefficients of
// w^0 and c3, c4, c5 those of w^1), nine Fp2 squarings (each
// (x0 + x1)(x0 - x1) + 2 x0 x1 u, two Fp products) of the pairs
// j = 0, 1, 2: (c4, c0), (c3, c2), (c5, c1), of each first, second and
// their sum; then t0..t8 and z0..z5.  Every element is canonical, so the
// outputs are the plain version's limbs, bit for bit, on any input.
//
//   phase    tasks  writes
//   Sums     6      c4 + c0, c3 + c2, c5 + c1
//   Squares  18     the 18 products (one product site), by component
//   Next     12     z_i = 3 t - 2 c_i from t0, t2, t4 = xi sq(.) + sq(.)
//                   (i < 3), or 3 t + 2 c_i from t8 = xi D_2, t6 = D_0,
//                   t7 = D_1, D_j = sq(first + second) - (sq(first) +
//                   sq(second)); each task forms its own t and writes the
//                   element it read, so the value is squared in place
// Each kind of task has warps of its own (phases::Beside).  SquareLazy
// is the same squaring with the products' operands not reduced.
//
// The scratch area (elements of 12 words): the value, the sums and the
// products, 36 elements, 1,728 B.

#pragma once

#include <cstdint>

#include "phases.cuh"

namespace cyclo {

using fp12::ld;
using fp12::st;
using fp384::kWords;

constexpr int kV = 0;      // 12: the value, squared in place
constexpr int kSum = 12;   // 6: [pair][component]
constexpr int kSq = 18;    // 18: [pair][first, second, sum][component]
constexpr int kScratch = 36;

// The Fp2 index of pair j's first and second coefficient.
FP384_FN int first(int j) { return j == 0 ? 4 : j == 1 ? 3 : 5; }
FP384_FN int second(int j) { return j == 0 ? 0 : j == 1 ? 2 : 1; }

struct Sums : phases::Linear<6> {
  static FP384_FN void task(int k, uint32_t* s) {
    const int j = k / 2, c = k % 2;
    uint32_t r[kWords];
    phases::ld_add(s, kV + 2 * first(j) + c, kV + 2 * second(j) + c, r);
    st(s, kSum + k, r);
  }
};

// Component C of the nine squarings q = 3 j + m: of pair j's first (m = 0),
// second (1) and sum (2).
template <int C>
struct SquaresC : phases::Products<9> {
  static FP384_FN int operands(int q, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int j = q / 3, m = q % 3;
    const int e = m == 0 ? kV + 2 * first(j)
                : m == 1 ? kV + 2 * second(j) : kSum + 2 * j;
    phases::csqr(s, e, C, x, y);
    return kSq + 2 * q + C;
  }
};

// z = (t - c_i) + (t - c_i) + t for i < 3, (t + c_i) + (t + c_i) + t
// after, from t and the element k = 2 i + c it replaces.
FP384_FN void next(uint32_t* s, int k, const uint32_t t[kWords]) {
  uint32_t a[kWords], b[kWords], r[kWords];
  ld(s, kV + k, a);
  if (k < 6) {
    phases::sub(t, a, b);
  } else {
    phases::add(t, a, b);
  }
  phases::add(b, b, a);
  phases::add(a, t, r);
  st(s, kV + k, r);
}

// D_j, component c: sq(first + second) - (sq(first) + sq(second)).
FP384_FN void cross(const uint32_t* s, int j, int c, uint32_t out[kWords]) {
  const int sq = kSq + 6 * j + c;  // first; second +2, sum +4
  uint32_t a[kWords], b[kWords];
  phases::ld_add(s, sq, sq + 2, a);
  ld(s, sq + 4, b);
  phases::sub(b, a, out);
}

// z0, z1, z2 from t0 = xi sq(c4) + sq(c0), t2 = xi sq(c2) + sq(c3),
// t4 = xi sq(c5) + sq(c1)
struct NextLow : phases::Linear<6> {
  static FP384_FN void task(int k, uint32_t* s) {
    const int j = k / 2, c = k % 2;
    uint32_t a[kWords], b[kWords], t[kWords];
    phases::xi(s, kSq + 6 * j + (j == 1 ? 2 : 0), c, a);
    ld(s, kSq + 6 * j + (j == 1 ? 0 : 2) + c, b);
    phases::add(a, b, t);
    next(s, k, t);
  }
};

struct NextT8 : phases::Linear<2> {  // z3 from t8 = xi D_2
  static FP384_FN void task(int c, uint32_t* s) {
    uint32_t d0[kWords], d1[kWords], t[kWords];
    cross(s, 2, 0, d0);
    cross(s, 2, 1, d1);
    phases::xi_part(d0, d1, c, t);
    next(s, 6 + c, t);
  }
};

struct NextHigh : phases::Linear<4> {  // z4, z5 from t6 = D_0, t7 = D_1
  static FP384_FN void task(int k, uint32_t* s) {
    uint32_t t[kWords];
    cross(s, k / 2, k % 2, t);
    next(s, 8 + k, t);
  }
};

// One squaring.
using Next = phases::Beside<NextLow, NextT8, NextHigh>;
using Square =
    phases::Plan<Sums, phases::Beside<SquaresC<0>, SquaresC<1>>, Next>;
constexpr int kThreads = phases::block_threads<Square>();

// The same squaring with the products' operands not reduced
// (final_exp.cuh runs it): (x0 + x1, x0 - x1 + p) and (x0, x1 + x1), each
// below 2p, which the Montgomery product takes and still gives canonical
// results, so the products, and all that follows, are the same words.
template <int C>
struct SquaresLazyC : phases::Products<9> {
  static FP384_FN int operands(int q, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    const int j = q / 3, m = q % 3;
    const int e = m == 0 ? kV + 2 * first(j)
                : m == 1 ? kV + 2 * second(j) : kSum + 2 * j;
    phases::csqr_lazy(s, e, C, x, y);
    return kSq + 2 * q + C;
  }
};
using SquaresLazy = phases::Beside<SquaresLazyC<0>, SquaresLazyC<1>>;
using SquareLazy = phases::Plan<Sums, SquaresLazy, Next>;

}  // namespace cyclo
