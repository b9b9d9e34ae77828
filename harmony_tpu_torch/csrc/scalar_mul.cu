// Scalar multiplication in G1 and in the G2 twist, for Hopper (sm_90a):
// one block per lane runs the lane's whole double-and-add over an
// MSB-first bit string in one launch.  Two kernels of one template,
// scalar_mul_g1_kernel (over Fp: derive_pubkeys) and scalar_mul_g2_kernel
// (over Fp2: sign, clear_cofactor_g2).
//
// Replaces no TPU kernel.  It fuses the JAX package's
// harmony_tpu/ops/curve.py scalar_mul (a lax.scan over the bits of dbl,
// add(..., handle_equal=False) and a select by the bit), jnp code around
// the Pallas multiply that XLA fuses.  Run eagerly in PyTorch, each of a
// signature's 255 steps is 10 stacked product calls over Fp2 (4 for the
// doubling, 6 for the addition) and the adds and selects around them,
// each a few tensor ops.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate), per lane of L bits:
//   bytes: read the point (384 B over Fp, 768 B over Fp2) and the bits
//   (4 L B, or once for all lanes), write the result as big as the point;
//   operations: per step the doubling's and the addition's Montgomery
//   products of 576 IMAD, 23 over Fp and 59 over Fp2 (Karatsuba products,
//   complex squares): 255 steps of 59 are 8.7 M IMAD a signature (the
//   kernel makes 21 and 76 a step, jac.cuh's ladder).
// At 1 to 256 lanes both bounds are microseconds.  The cost is one lane's
// chain: L steps of 6 rounds of products, each followed by a phase of
// adds and a barrier.
//
// Design: the SM's integer pipes, shuffles and shared memory, on the plan
// of jac.cuh's namespace ladder.
//  - One block per lane, 32 threads over Fp and 64 over Fp2: a round's
//    Montgomery products (at most 5 and 16) each take a group of four
//    threads (the split product of fp384_split.cuh), so every round is
//    one pass.  The lane's accumulator, base point and intermediates stay
//    in shared memory (2,544 B over Fp, 6,672 B over Fp2) for all L steps.
//  - One copy of the product code: every product task loads its operands
//    from two elements and stores to a third, so the six rounds of a step
//    run through one site in a loop, each group reading its task from a
//    table in shared memory (ladder::Table, packed here at the start).  A
//    step's code is that site and its six phases of adds, once each: with
//    a copy of the product and of its operand code in every round, each
//    phase of a G2 step, the same code too, took 2-3.7 times G1's.
//  - A phase of adds runs one task per component, component c on warp c,
//    so that no branch on the component splits a warp; the selects one a
//    coordinate and component.  Over Fp the block is one warp and a phase
//    ends with __syncwarp(); over Fp2 with __syncthreads().
//  - Constant time (the bits are secret keys): every step runs the same
//    phases and products whatever its bit; thread 0 writes the bit as a
//    mask of all ones or zeros before the step, and the step's last phase
//    combines the add's result and the doubled accumulator by that mask.
//    No branch depends on a bit or on a value derived from one, no step is
//    skipped (leading zeros double the point at infinity, as the reference
//    does), and nothing is inverted: the output is Jacobian.  Each step
//    reads its bit from device memory one step ahead.
//  - One bit string for all lanes (clear_cofactor_g2's cofactor) is read
//    once, not once per lane: the lanes' stride into it is 0.
//
// Boundary format: points (lanes, 3, 32) over Fp or (lanes, 3, 2, 32)
// over Fp2, Jacobian, rows of 32 little-endian 12-bit limbs in int32,
// canonical and in the Montgomery domain; bits (lanes, L) or (L,) int32,
// MSB first, a step adding where its bit is 1 (other values do not add,
// as curve.py's bit == 1); out as points.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "jac.cuh"

namespace {

using fp384::kLimbs;
using fp384::kWords;
using jac::ladder::kRounds;
using jac::ladder::kStepRounds;

template <class F>
constexpr int kGroups = jac::Ladder<F>::kThreads / split::kGroup;

// A group's task of round r, packed: x | y << 10 | out << 20, out kNowhere
// for a group past the round's last task in a busy warp (it multiplies the
// last task's operands again and stores nothing: the shuffles of the
// split product need every lane of the warp), kSkip for every group of a
// warp past it (the warp skips the round).
constexpr uint32_t kNowhere = 1023, kSkip = 1u << 31;

template <class F>
constexpr uint32_t packed(int r, int g) {
  constexpr jac::ladder::Table t = jac::ladder::make_table<F>();
  constexpr int kGroupsPerWarp = 32 / split::kGroup;
  const int n = t.n[r];
  if (g / kGroupsPerWarp * kGroupsPerWarp >= n) return kSkip;
  const jac::ladder::Task& k = t.task[r][g < n ? g : n - 1];
  const uint32_t out = g < n ? static_cast<uint32_t>(k.out) : kNowhere;
  return static_cast<uint32_t>(k.x) | static_cast<uint32_t>(k.y) << 10 |
         out << 20;
}

static_assert(jac::Ladder<jac::Fp2>::kScratch < kNowhere,
              "every element has a 10-bit index");

// Entry I of the table, a constant of the class (nvcc evaluates the host
// constexpr function there, not in device code).
template <class F, int I>
struct Entry {
  static constexpr uint32_t kValue = packed<F>(I / kGroups<F>, I % kGroups<F>);
};

// The table, entry i by thread i mod kThreads.
template <class F, int... I>
__device__ __forceinline__ void fill(uint32_t* tab,
                                     std::integer_sequence<int, I...>) {
  constexpr int kThreads = jac::Ladder<F>::kThreads;
  const int t = threadIdx.x;
  ((t == I % kThreads ? (void)(tab[I] = Entry<F, I>::kValue) : (void)0), ...);
}

// The end of a phase: __syncwarp() where the block is one warp.
template <class F>
__device__ __forceinline__ void barrier() {
  if constexpr (jac::Ladder<F>::kThreads == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Round r of the table: the block's one product site.
template <class F>
__device__ __forceinline__ void products(const uint32_t* tab, uint32_t* s,
                                         int r) {
  const int t = threadIdx.x, q = t % split::kGroup;
  const uint32_t e = tab[r * kGroups<F> + t / split::kGroup];
  if (e & kSkip) return;  // the same for every group of the warp
  uint32_t x[kWords], y[kWords], z[kWords];
  fp12::ld(s, e & 1023, x);
  fp12::ld(s, (e >> 10) & 1023, y);
  split::mont_mul(q, x, y, z);
  const uint32_t out = (e >> 20) & 1023;
  if (q == 0 && out != kNowhere) fp12::st(s, out, z);
}

// A phase of adds: task j kE + c on lane j of warp c.
template <class F, class Ph>
__device__ __forceinline__ void adds(uint32_t* s) {
  const int c = threadIdx.x / 32, j = threadIdx.x % 32;
  if (c < F::kE && j < Ph::kTasks / F::kE) Ph::task(j * F::kE + c, s);
}

template <class F>
__device__ __forceinline__ void adds_after(int r, uint32_t* s) {
  using jac::ladder::AddsAfter;
  switch (r) {
    case 0: adds<F, AddsAfter<F, 0>>(s); break;
    case 1: adds<F, AddsAfter<F, 1>>(s); break;
    case 2: adds<F, AddsAfter<F, 2>>(s); break;
    case 3: adds<F, AddsAfter<F, 3>>(s); break;
    case 4: adds<F, AddsAfter<F, 4>>(s); break;
    default: adds<F, AddsAfter<F, 5>>(s); break;
  }
}

// The timed build (harmony_scalar_mul_g{1,2}_phases): block 0's thread 0
// reads clock64() after the barrier that ends each phase of a step and adds
// the cycles since the last reading to that phase's sum, over the whole
// ladder (the first phase's sum holds the loop's own work); the kernel
// also records each phase's kind and tasks, and the ladder's cycles and
// nanoseconds (%globaltimer), which give the SM clock.  clocks (int64,
// 4 + 2 kMaxPhases words): [0] phases a step, [1] steps, [2] cycles and
// [3] ns of the ladder, [4 + i] cycles of phase i, [4 + kMaxPhases + i]
// its tasks, plus 65536 for a round of products.
constexpr int kMaxPhases = 24;
static_assert(2 * kStepRounds <= kMaxPhases, "a step's phases fit");

struct Clock {
  unsigned long long* c;  // shared: cycles per phase, then the last reading

  __device__ __forceinline__ bool on() const {
    return c != nullptr && threadIdx.x == 0 && blockIdx.x == 0;
  }
  __device__ __forceinline__ void start() const {
    if (!on()) return;
    for (int i = 0; i < kMaxPhases; ++i) c[i] = 0;
    c[kMaxPhases] = clock64();
  }
  __device__ __forceinline__ void tick(int i) const {
    if (!on()) return;
    const unsigned long long now = clock64();
    c[i] += now - c[kMaxPhases];
    c[kMaxPhases] = now;
  }
};

__device__ __forceinline__ unsigned long long ns_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Phase I's tasks, plus 65536 for a round of products.
template <class F, int I>
constexpr int64_t phase_kind() {
  if constexpr (I % 2 == 0) {
    return jac::ladder::make_table<F>().n[I / 2] + 65536;
  } else {
    return jac::ladder::AddsAfter<F, I / 2>::kTasks;
  }
}

template <class F, int I>
struct Kind {
  static constexpr int64_t kValue = phase_kind<F, I>();
};

template <class F, int... I>
__device__ __forceinline__ void write_kinds(int64_t* kinds,
                                            std::integer_sequence<int, I...>) {
  ((kinds[I] = Kind<F, I>::kValue), ...);
}

template <class F, bool kTimed>
__device__ __forceinline__ void lane(uint32_t* s, uint32_t* tab,
                                     const int32_t* __restrict__ points,
                                     const int32_t* __restrict__ bits,
                                     int64_t n_bits, int shared,
                                     int32_t* __restrict__ out,
                                     unsigned long long* clk,
                                     int64_t* __restrict__ clocks) {
  using L = jac::Ladder<F>;
  using S = typename L::S;
  using jac::ladder::PerComponent;
  using jac::ladder::SetupValue;
  constexpr int kRows = 3 * F::kE;
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  fill<F>(tab, std::make_integer_sequence<int, kRounds * kGroups<F>>{});
  if (t < kRows) {
    uint32_t w[kWords];
    fp384::load_row(points + (lane * kRows + t) * kLimbs, w);
    fp12::st(s, L::kBase + t, w);
    jac::infinity_element<F>(t, w);
    fp12::st(s, L::kAcc + t, w);
  }
  const int32_t* mine = bits + (shared ? 0 : lane * n_bits);
  int32_t next = n_bits > 0 ? mine[0] : 0;
  __syncthreads();
  // the setup: 2 Z2 and Z2 = 0, Z2^2, Z2^3
  adds<F, PerComponent<F, jac::ladder::SetupW2<F>>>(s);
  barrier<F>();
  products<F>(tab, s, kStepRounds);
  barrier<F>();
  adds<F, PerComponent<F, SetupValue<F, S::kZ2Z2p, S::kZ2Z2, true>>>(s);
  barrier<F>();
  products<F>(tab, s, kStepRounds + 1);
  barrier<F>();
  adds<F, PerComponent<F, SetupValue<F, S::kZ2Cp, S::kZ2C, false>>>(s);
  barrier<F>();
  const Clock clock{kTimed ? clk : nullptr};
  unsigned long long ns0 = 0, cycles0 = 0;
  if (kTimed && clock.on()) {
    clock.start();
    cycles0 = clk[kMaxPhases];
    ns0 = ns_now();
  }
#pragma unroll 1
  for (int64_t i = 0; i < n_bits; ++i) {
    // the previous step's last phase, which read the mask, has ended
    if (t == 0) s[L::kBitWord] = jac::mask(next == 1);
    next = i + 1 < n_bits ? mine[i + 1] : 0;
#pragma unroll 1
    for (int r = 0; r < kStepRounds; ++r) {
      products<F>(tab, s, r);
      barrier<F>();
      if constexpr (kTimed) clock.tick(2 * r);
      adds_after<F>(r, s);
      barrier<F>();
      if constexpr (kTimed) clock.tick(2 * r + 1);
    }
  }
  if (kTimed && clock.on()) {
    clocks[0] = L::kPhases;
    clocks[1] = n_bits;
    clocks[2] = static_cast<int64_t>(clock64() - cycles0);
    clocks[3] = static_cast<int64_t>(ns_now() - ns0);
    for (int j = 0; j < kMaxPhases; ++j) {
      clocks[4 + j] = static_cast<int64_t>(clk[j]);
    }
    write_kinds<F>(clocks + 4 + kMaxPhases,
                   std::make_integer_sequence<int, L::kPhases>{});
  }
  if (t < kRows) {
    uint32_t w[kWords];
    fp12::ld(s, L::kAcc + t, w);
    fp384::store_row(w, out + (lane * kRows + t) * kLimbs);
  }
}

// One lane's shared memory: the scratch area and the table.
template <class F>
struct Shared {
  uint32_t s[jac::Ladder<F>::kScratch * kWords];
  uint32_t tab[kRounds * kGroups<F>];
};

__global__ void __launch_bounds__(jac::Ladder<jac::Fp>::kThreads)
scalar_mul_g1_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ bits,
                     int32_t* __restrict__ out, int64_t n_bits, int shared) {
  __shared__ __align__(16) Shared<jac::Fp> m;
  lane<jac::Fp, false>(m.s, m.tab, points, bits, n_bits, shared, out,
                       nullptr, nullptr);
}

__global__ void __launch_bounds__(jac::Ladder<jac::Fp2>::kThreads)
scalar_mul_g2_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ bits,
                     int32_t* __restrict__ out, int64_t n_bits, int shared) {
  __shared__ __align__(16) Shared<jac::Fp2> m;
  lane<jac::Fp2, false>(m.s, m.tab, points, bits, n_bits, shared, out,
                        nullptr, nullptr);
}

template <class F>
__global__ void __launch_bounds__(jac::Ladder<F>::kThreads)
scalar_mul_phases_kernel(const int32_t* __restrict__ points,
                         const int32_t* __restrict__ bits,
                         int64_t* __restrict__ clocks,
                         int32_t* __restrict__ out, int64_t n_bits,
                         int shared) {
  __shared__ __align__(16) Shared<F> m;
  __shared__ unsigned long long clk[kMaxPhases + 1];
  lane<F, true>(m.s, m.tab, points, bits, n_bits, shared, out, clk, clocks);
}

template <class F, class Kernel, class... Clocks>
int launch(Kernel kernel, const void* points, const void* bits, void* out,
           int64_t lanes, int64_t n_bits, int32_t shared, void* stream,
           Clocks... clocks) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff || n_bits < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned int>(lanes), jac::Ladder<F>::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(points), static_cast<const int32_t*>(bits),
      static_cast<int64_t*>(clocks)..., static_cast<int32_t*>(out), n_bits,
      shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C ABI for ctypes.  points and out are (lanes, 3, 32) for G1 and (lanes,
// 3, 2, 32) for G2; bits is (lanes, n_bits), or (n_bits,) for every lane
// where shared is 1; all int32, contiguous, 16-byte aligned (points,
// out), on the current device; lanes < 2^31.  stream is a cudaStream_t.
// The launch is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_scalar_mul_g1(const void* points, const void* bits,
                                     void* out, int64_t lanes, int64_t n_bits,
                                     int32_t shared, void* stream) {
  return launch<jac::Fp>(scalar_mul_g1_kernel, points, bits, out, lanes,
                         n_bits, shared, stream);
}

extern "C" int harmony_scalar_mul_g2(const void* points, const void* bits,
                                     void* out, int64_t lanes, int64_t n_bits,
                                     int32_t shared, void* stream) {
  return launch<jac::Fp2>(scalar_mul_g2_kernel, points, bits, out, lanes,
                          n_bits, shared, stream);
}

// The timed build of each (see Clock): the same arguments, and clocks, an
// int64 buffer of 52 words on the device, which block 0 fills.
extern "C" int harmony_scalar_mul_g1_phases(const void* points,
                                            const void* bits, void* clocks,
                                            void* out, int64_t lanes,
                                            int64_t n_bits, int32_t shared,
                                            void* stream) {
  return launch<jac::Fp>(scalar_mul_phases_kernel<jac::Fp>, points, bits,
                         out, lanes, n_bits, shared, stream, clocks);
}

extern "C" int harmony_scalar_mul_g2_phases(const void* points,
                                            const void* bits, void* clocks,
                                            void* out, int64_t lanes,
                                            int64_t n_bits, int32_t shared,
                                            void* stream) {
  return launch<jac::Fp2>(scalar_mul_phases_kernel<jac::Fp2>, points, bits,
                          out, lanes, n_bits, shared, stream, clocks);
}
