// Plans of phases, fixed at compile time, and the block that runs them on
// the card: the frame of the Miller-loop and cyclotomic-squaring kernels
// (miller.cuh, cyclo.cuh).  The host tests run the same plans with their
// own runner (tests/test_torch_fp12_host.py, tests/test_torch_miller_host.py).
//
// A phase is a type with
//   kTasks     the number of its tasks, which read only what earlier
//              phases wrote and write disjoint elements, so they may run
//              in any order or at once;
//   kProduct   true if every task ends in one Montgomery product:
//                int operands(int k, const uint32_t* s, uint32_t x[12],
//                             uint32_t y[12])
//              forms task k's operands from the scratch area s and returns
//              the element the product goes to (-1: store nothing); the
//              runner multiplies;
//              false if each task does its own adds and stores:
//                void task(int k, uint32_t* s).
// A plan, Plan<P0, P1, ...>, runs its phases in order; Beside<A, B, ...>
// runs the tasks of A, B, ... as one phase, so that independent work
// shares a round.  Every phase is a type, so every scratch index in it is
// a function of the task number alone, and the compiler sees each phase's
// code with its tables as constants: no register array is indexed at run
// time.
//
// Why the SM's integer pipes and not the tensor cores, TMA or wgmma: a
// lane moves a few KB once, and its work is 32-bit word products with
// carries in dependent rounds of 2 to 60 products, no matrix tile; the
// time is the chain of rounds, so a lane takes a block and each round as
// many threads as it has work.

#pragma once

#include <cstdint>

#include "fp12.cuh"
#include "fp384_split.cuh"

namespace phases {

using fp384::kWords;

// Bases of the phase types: N tasks of adds, or N products.
template <int N>
struct Linear {
  static constexpr bool kProduct = false;
  static constexpr int kTasks = N;
};

template <int N>
struct Products {
  static constexpr bool kProduct = true;
  static constexpr int kTasks = N;
};

// Task slots a warp holds: 32 tasks of adds, or 32 / kGroup products.
template <class Ph>
constexpr int warp_slots() {
  return Ph::kProduct ? 32 / split::kGroup : 32;
}

// Phases side by side, as one phase: each starts at a warp boundary, so
// that a warp runs one kind of task and its threads do not wait for each
// other's branches (a warp runs every branch its threads take).  Slots
// between two are gaps: a linear gap does nothing; a product gap forms
// some task's operands, and operands() returns -1 so that nothing is
// stored.
template <class A, class... Rest>
struct Beside;

template <class A>
struct Beside<A> : A {};

template <class A, class B, class... Rest>
struct Beside<A, B, Rest...> {
  using Next = Beside<B, Rest...>;
  static_assert(A::kProduct == Next::kProduct,
                "a phase's tasks are all products or none");
  static constexpr bool kProduct = A::kProduct;
  static constexpr int kSkip =
      (A::kTasks + warp_slots<A>() - 1) / warp_slots<A>() * warp_slots<A>();
  static constexpr int kTasks = kSkip + Next::kTasks;
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    if (k >= kSkip) return Next::operands(k - kSkip, s, x, y);
    const int out = A::operands(k < A::kTasks ? k : A::kTasks - 1, s, x, y);
    return k < A::kTasks ? out : -1;
  }
  static FP384_FN void task(int k, uint32_t* s) {
    if (k >= kSkip) {
      Next::task(k - kSkip, s);
    } else if (k < A::kTasks) {
      A::task(k, s);
    }
  }
};

template <class... Ph>
struct Plan {};

// The threads a phase occupies: a group of split::kGroup per product.
template <class Ph>
constexpr int threads() {
  return Ph::kProduct ? Ph::kTasks * split::kGroup : Ph::kTasks;
}

// The block size that runs every phase of the plans in one round, in
// whole warps.
template <class... Plans>
struct Threads;

template <class... Ph, class... Rest>
struct Threads<Plan<Ph...>, Rest...> {
  static constexpr int most() {
    int m = Threads<Rest...>::most();
    ((m = threads<Ph>() > m ? threads<Ph>() : m), ...);
    return m;
  }
};

template <>
struct Threads<> {
  static constexpr int most() { return 0; }
};

template <class... Plans>
constexpr int block_threads() {
  return (Threads<Plans...>::most() + 31) / 32 * 32;
}

// --- Fp arithmetic of the plans ---------------------------------------------
//
// fp384.cuh's add, sub and neg, the same canonical results: under g++
// those functions; on the card each 12-word carry or borrow chain is one
// run of PTX add.cc/addc.cc (sub.cc/subc.cc) instructions, which carry in
// the condition code (FP384_CHAIN) where fp384.cuh's 64-bit sums carry
// through shifts.  The G1 sum (g1.cuh) uses these too; fp12_mul.cu,
// fp_addsub.cu and mont_mul.cu keep fp384.cuh's.

// (a + b) mod p for canonical a, b.
FP384_FN void add(const uint32_t a[kWords], const uint32_t b[kWords],
                  uint32_t out[kWords]) {
#if defined(__CUDA_ARCH__)
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  uint32_t t[kWords], d[kWords], borrow;
  FP384_CHAIN("add.cc.u32", t[0], a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("addc.cc.u32", t[j], a[j], b[j]);
  }
  FP384_CHAIN("sub.cc.u32", d[0], t[0], p[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("subc.cc.u32", d[j], t[j], p[j]);
  }
  FP384_CHAIN("subc.u32", borrow, 0u, 0u);  // all ones iff a + b < p
#pragma unroll
  for (int j = 0; j < kWords; ++j) out[j] = borrow ? t[j] : d[j];
#else
  fp384::add(a, b, out);
#endif
}

// (a - b) mod p for canonical a, b.
FP384_FN void sub(const uint32_t a[kWords], const uint32_t b[kWords],
                  uint32_t out[kWords]) {
#if defined(__CUDA_ARCH__)
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  uint32_t d[kWords], borrow;
  FP384_CHAIN("sub.cc.u32", d[0], a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("subc.cc.u32", d[j], a[j], b[j]);
  }
  FP384_CHAIN("subc.u32", borrow, 0u, 0u);  // all ones iff a < b
  FP384_CHAIN("add.cc.u32", out[0], d[0], p[0] & borrow);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("addc.cc.u32", out[j], d[j], p[j] & borrow);
  }
#else
  fp384::sub(a, b, out);
#endif
}

// (-a) mod p for canonical a, with -0 = 0.
FP384_FN void neg(const uint32_t a[kWords], uint32_t out[kWords]) {
  const uint32_t zero[kWords] = {};
  sub(zero, a, out);
}

// s[x] + s[y], s[x] - s[y].
FP384_FN void ld_add(const uint32_t* s, int x, int y, uint32_t out[kWords]) {
  uint32_t a[kWords], b[kWords];
  fp12::ld(s, x, a);
  fp12::ld(s, y, b);
  add(a, b, out);
}

FP384_FN void ld_sub(const uint32_t* s, int x, int y, uint32_t out[kWords]) {
  uint32_t a[kWords], b[kWords];
  fp12::ld(s, x, a);
  fp12::ld(s, y, b);
  sub(a, b, out);
}

// Component c of xi y = (y0 - y1) + (y0 + y1) u.
FP384_FN void xi_part(const uint32_t y0[kWords], const uint32_t y1[kWords],
                      int c, uint32_t out[kWords]) {
  if (c == 0) {
    sub(y0, y1, out);
  } else {
    add(y0, y1, out);
  }
}

// Operands a product task often needs, from elements of s.

// Fp operand h of the Karatsuba product over Fp2 of the element pair at
// e: e, e + 1, and their sum for h = 2.
FP384_FN void kara(const uint32_t* s, int e, int h, uint32_t x[kWords]) {
  if (h < 2) {
    fp12::ld(s, e + h, x);
  } else {
    ld_add(s, e, e + 1, x);
  }
}

// The same, of an Fp2 value held in registers (a0, a1).
FP384_FN void kara(const uint32_t a0[kWords], const uint32_t a1[kWords], int h,
                   uint32_t x[kWords]) {
  if (h < 2) {
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) x[j] = h ? a1[j] : a0[j];
  } else {
    add(a0, a1, x);
  }
}

// The operands of component c of the complex squaring of (a0, a1):
// c0 = (a0 + a1)(a0 - a1), c1 = a0 (a1 + a1).
FP384_FN void csqr(const uint32_t a0[kWords], const uint32_t a1[kWords], int c,
                   uint32_t x[kWords], uint32_t y[kWords]) {
  if (c == 0) {
    add(a0, a1, x);
    sub(a0, a1, y);
  } else {
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) x[j] = a0[j];
    add(a1, a1, y);
  }
}

FP384_FN void csqr(const uint32_t* s, int e, int c, uint32_t x[kWords],
                   uint32_t y[kWords]) {
  uint32_t a0[kWords], a1[kWords];
  fp12::ld(s, e, a0);
  fp12::ld(s, e + 1, a1);
  csqr(a0, a1, c, x, y);
}

// Component c of a Karatsuba product over Fp2 from its three products at
// v: c0 = v0 - v1, c1 = v2 - (v0 + v1).
FP384_FN void combine(const uint32_t* s, int v, int c, uint32_t out[kWords]) {
  uint32_t v0[kWords], v1[kWords];
  fp12::ld(s, v, v0);
  fp12::ld(s, v + 1, v1);
  if (c == 0) {
    sub(v0, v1, out);
  } else {
    uint32_t t[kWords], v2[kWords];
    add(v0, v1, t);
    fp12::ld(s, v + 2, v2);
    sub(v2, t, out);
  }
}

// Component c of xi (y0 + y1 u) for the pair at e: y0 - y1, or y0 + y1.
FP384_FN void xi(const uint32_t* s, int e, int c, uint32_t out[kWords]) {
  if (c == 0) {
    ld_sub(s, e, e + 1, out);
  } else {
    ld_add(s, e, e + 1, out);
  }
}

#if defined(__CUDACC__)
// One lane's plans on one block, its scratch area in shared memory.
// Product phases give each task a group of split::kGroup threads, whole
// warps at a time (a warp past the last task skips the phase; a group
// past it in a busy warp multiplies the last task's operands again and
// stores nothing), so the shuffles of the split product see every lane
// of the warp.  Every phase ends with __syncthreads(), which every thread
// of the block reaches.
struct Block {
  uint32_t* s;

  template <class Ph>
  __device__ __forceinline__ void phase() const {
    const int t = threadIdx.x;
    if constexpr (Ph::kProduct) {
      constexpr int kBusy = (Ph::kTasks * split::kGroup + 31) / 32 * 32;
      if (t < kBusy) {
        const int g = t / split::kGroup;
        uint32_t x[kWords], y[kWords], r[kWords];
        const int out = Ph::operands(g < Ph::kTasks ? g : Ph::kTasks - 1, s,
                                     x, y);
        split::mont_mul(t % split::kGroup, x, y, r);
        if (t % split::kGroup == 0 && g < Ph::kTasks && out >= 0) {
          fp12::st(s, out, r);
        }
      }
    } else {
      if (t < Ph::kTasks) Ph::task(t, s);
    }
    __syncthreads();
  }

  template <class... Ph>
  __device__ __forceinline__ bool operator()(Plan<Ph...>) const {
    (phase<Ph>(), ...);
    return true;
  }
};
#endif  // __CUDACC__

}  // namespace phases
