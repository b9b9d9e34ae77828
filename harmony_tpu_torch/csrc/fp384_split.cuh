// The Montgomery product a b 2^-384 mod p of fp384.cuh, split over a group
// of kGroup threads, so that one product's dependent chain is shorter than
// one thread's 12 x 12-word CIOS.  Used by the phase runner of the tower
// kernels (phases.cuh) and, as plain C++, by the host tests
// (tests/test_torch_fp12_host.py, tests/test_torch_miller_host.py).
//
// The algorithm is fp384::mont_mul's CIOS, with the accumulator t held in
// carry-save form: thread r of the group keeps words 3r, 3r + 1, 3r + 2 of
// t as a low word and a small carry into the word above (t is the sum of
// lo_J 2^(32 J) and hi_J 2^(32 J + 32)).  Iteration i:
//   1. each thread adds a_i b_J to its words: x_J = lo_J + a_i b_J;
//   2. thread 0 forms m = x_0 (-p^-1) mod 2^32, and the group takes it;
//   3. each thread adds m p_J: y_J = (x_J mod 2^32) + m p_J, and the
//      division by 2^32 moves word J + 1 down to J: the low word of y_{J+1}
//      plus the high halves of x_J and y_J and hi_J.  The word that crosses
//      from thread r + 1 to thread r is the only one exchanged.
// Every sum fits in 64 bits: x_J, y_J <= 2^64 - 2^32, and the new word is
// at most 3 (2^32 - 1) + hi_J < 2^34, so hi stays <= 3.  The value is
// t's, so t < 2p after each iteration as in the one-thread CIOS.  At the
// end each thread folds its carries into 3 words and one carry out, thread
// 0 gathers the other threads' 12 values, ripples the carries and
// subtracts p once if t >= p: fp384::mont_mul's canonical output.
//
// The product is written as steps: thread r of step s reads what the
// exchange after step s - 1 gave it, updates its registers (Part), and
// returns the one word it shows in step s; source(s, r) says whose word it
// gets.  On the card the exchange is __shfl_sync within the group and the
// steps are unrolled, so every index into a register array is a constant;
// under g++ the test runs the threads of each step one after another and
// the exchange is an array.  The critical path of an iteration is one
// word product, m, one shuffle and one word product; the one-thread CIOS
// ripples a carry through all 12 words of each half.

#pragma once

#include <cstdint>

#include "fp384.cuh"

namespace split {

using fp384::kWords;

constexpr int kGroup = 4;                 // threads per product
constexpr int kPart = kWords / kGroup;    // words per thread
constexpr int kGather = (kGroup - 1) * (kPart + 1);  // values thread 0 takes
constexpr int kSteps = 2 * kWords + kGather;         // exchanges
static_assert(kPart * kGroup == kWords, "the words split evenly");

// One thread's registers during a product.
struct Part {
  uint32_t b[kPart], p[kPart];    // the thread's words of b and p
  uint32_t lo[kPart], hi[kPart];  // t, carry-save
  uint64_t x[kPart];              // t + a_i b, between steps 2i and 2i + 1
  uint32_t ylo[kPart];            // low words of y, between 2i + 1 and 2i + 2
  uint64_t u[kPart];              // high halves and carries, the same
  uint32_t own[kPart + 1];        // the thread's 3 words and carry out
  uint32_t got[kWords + kGroup];  // thread 0: all 12 words, then 4 carries
};

// Word j of thread r's part of v; r is known only at run time, so the
// word is chosen by selects, never by an index into a register array.
FP384_FN uint32_t word_of(const uint32_t v[kWords], int r, int j) {
  uint32_t w = v[j];
  FP384_UNROLL
  for (int q = 1; q < kGroup; ++q) w = r == q ? v[kPart * q + j] : w;
  return w;
}

// Thread r's registers before step 0, for the product a b.
FP384_FN void start(int r, const uint32_t b[kWords], Part& st) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  FP384_UNROLL
  for (int j = 0; j < kPart; ++j) {
    st.b[j] = word_of(b, r, j);
    st.p[j] = word_of(p, r, j);
    st.lo[j] = 0;
    st.hi[j] = 0;
  }
  FP384_UNROLL
  for (int j = 0; j < kWords + kGroup; ++j) st.got[j] = 0;
}

// Whose word thread r takes in the exchange after step s: m from thread
// 0; the word above from thread r + 1 (thread kGroup - 1 ignores it: the
// word above t's top is 0); then, one value at a time, thread 1's,
// 2's and 3's words and carries to thread 0.
FP384_FN int source(int s, int r) {
  if (s < 2 * kWords) return s % 2 == 0 ? 0 : (r + 1) % kGroup;
  return 1 + (s - 2 * kWords) / (kPart + 1);
}

// The end of iteration i: the division by 2^32, with `above` the low word
// of y at the first word of thread r + 1.
FP384_FN void shift(int r, Part& st, uint32_t above) {
  FP384_UNROLL
  for (int j = 0; j < kPart; ++j) {
    const uint32_t next =
        j + 1 < kPart ? st.ylo[j + 1] : (r == kGroup - 1 ? 0u : above);
    const uint64_t v = static_cast<uint64_t>(next) + st.u[j];
    st.lo[j] = static_cast<uint32_t>(v);
    st.hi[j] = static_cast<uint32_t>(v >> 32);
  }
}

// Step s of thread r (a is the whole multiplicand; `in` is what the
// exchange after step s - 1 gave r).  Returns the word r shows in step s.
FP384_FN uint32_t step(int s, int r, const uint32_t a[kWords], Part& st,
                       uint32_t in) {
  if (s < 2 * kWords) {
    const int i = s / 2;
    if (s % 2 == 0) {  // finish iteration i - 1; t + a_i b; offer m
      if (i > 0) shift(r, st, in);
      FP384_UNROLL
      for (int j = 0; j < kPart; ++j) {
        st.x[j] = static_cast<uint64_t>(st.lo[j]) +
                  static_cast<uint64_t>(a[i]) * st.b[j];
      }
      return static_cast<uint32_t>(st.x[0]) * fp384::kPInv;
    }
    FP384_UNROLL  // in is m: y = low half of x + m p
    for (int j = 0; j < kPart; ++j) {
      const uint64_t y = static_cast<uint64_t>(static_cast<uint32_t>(st.x[j])) +
                         static_cast<uint64_t>(in) * st.p[j];
      st.ylo[j] = static_cast<uint32_t>(y);
      st.u[j] = (st.x[j] >> 32) + (y >> 32) + st.hi[j];
    }
    return st.ylo[0];
  }
  const int q = s - 2 * kWords;
  if (q == 0) {  // finish the last iteration; fold the carries into own
    shift(r, st, in);
    uint64_t c = 0;
    FP384_UNROLL
    for (int j = 0; j < kPart; ++j) {
      c += static_cast<uint64_t>(st.lo[j]) + (j > 0 ? st.hi[j - 1] : 0u);
      st.own[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    st.own[kPart] = static_cast<uint32_t>(c) + st.hi[kPart - 1];
  } else {
    const int prev = q - 1;
    const int from = 1 + prev / (kPart + 1), v = prev % (kPart + 1);
    const int at = v < kPart ? kPart * from + v : kWords + from;
    st.got[at] = in;  // meaningful in thread 0 only
  }
  return st.own[q % (kPart + 1)];
}

// After the last exchange: thread 0 records what it got, ripples the
// carries over the 12 words and subtracts p if t >= p.  Only thread 0's
// out is the product.
FP384_FN void finish(Part& st, uint32_t in, uint32_t out[kWords]) {
  st.got[kWords + kGroup - 1] = in;
  FP384_UNROLL
  for (int j = 0; j < kPart; ++j) st.got[j] = st.own[j];
  st.got[kWords] = st.own[kPart];
  uint32_t t[kWords];
  uint64_t c = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += st.got[j];
    if (j % kPart == 0 && j > 0) c += st.got[kWords + j / kPart - 1];
    t[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  fp384::cond_sub_p(t, out);
}

#if defined(__CUDACC__)
// The product on the card: a group is kGroup consecutive lanes of a warp,
// and its lane r = lane % kGroup calls this with the group's a and b;
// lane 0's out is a b 2^-384 mod p.  Every lane of the warp must call it.
__device__ __forceinline__ void mont_mul(int r, const uint32_t a[kWords],
                                         const uint32_t b[kWords],
                                         uint32_t out[kWords]) {
  Part st;
  start(r, b, st);
  uint32_t in = 0;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const uint32_t v = step(s, r, a, st, in);
    in = __shfl_sync(0xffffffffu, v, source(s, r), kGroup);
  }
  finish(st, in, out);
}
#endif  // __CUDACC__

}  // namespace split
