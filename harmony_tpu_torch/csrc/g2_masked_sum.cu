// The masked sum of G2 points (the twist, over Fp2), for Hopper (sm_90a):
// select the points whose mask word is 1, pad them to a power of two with
// infinity and sum them as a tree, in one launch over as many blocks as
// the tree's wide levels fill.  The signatures' aggregate of ops/bls.py
// aggregate_sigs.
//
// Replaces no TPU kernel.  It fuses the JAX package's
// harmony_tpu/ops/curve.py masked_sum over FP2_OPS (a select by the mask,
// padding, and log2(n) levels of the Jacobian add with its doubling
// fallback, jnp code around the Pallas multiply that XLA fuses), as
// harmony_tpu/ops/bls.py aggregate_sigs calls it.  Run eagerly in
// PyTorch, a sum of 200 signatures is 8 levels of adds, each 10 stacked
// product calls over Fp2 (the add's 6 and the doubling's 4, which the
// plain add always computes) and the adds and selects around them.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate), for n points:
//   bytes: read the points (768 B each) and the mask words, write the sum
//   (768 B);
//   operations: Montgomery products of 576 IMAD, for each add of two
//   finite points 43 (Karatsuba products, complex squares), 30 where one
//   has Z = 1 and 16 where both have, and 16 more for a doubling (13 where
//   Z = 1); none for an add with infinity.
// At 200 points both bounds are microseconds.  The cost is the chain of
// the tree: log2(n) levels of adds, each add 5 rounds of products with a
// phase of adds after each of the first four, and the result.
//
// Design: the SM's integer pipes, shuffles and shared memory, on the plans
// of jac.cuh's namespace sum.
//  - The tree over blocks (jac::sum::Stage): masked_sum adds point
//    k + half into point k, so the leaves congruent to g mod b form a
//    closed subtree for any power of two b that divides the level's half.
//    Block g of the first stage sums the leaves g, g + b, ... (4 at most)
//    by the reference's levels, in its order, and writes its partial to a
//    workspace in device memory; of the blocks whose partials are
//    congruent mod the next stage's count, the last to finish (a
//    __threadfence(), then an atomicAdd on the group's counter) sums
//    them in the next stage, and so on until one block writes the sum.
//    Every level is one pass of adds on one block: 8 levels in series at
//    200 points (64 blocks, 16, 4, then one), 10 at 1,024 (256, 64, 16,
//    4, one), where one block took 19 and 130 passes.  A block that is
//    not last ends: no block waits for another, so the order in which
//    the card runs them does not matter.
//  - Why 4 leaves a block, not the 16 (8 adds) that would make two stages
//    at 200 points: 8 adds on one SM share its integer pipes, and their
//    rounds of products took 1.33 us against 1.0 with 2 adds; a handoff
//    costs about 1.3 us.  Timed in one call on an H100 80GB HBM3 at 700 W,
//    device ms at 200 and 1,024 points: 16 leaves 0.084, 0.101; 8 leaves
//    0.067, 0.085; 4 leaves 0.063, 0.087-0.088.
//  - The counters must be 0 at every launch, and a launch must not see
//    another's, on any stream: the wrapper allocates a workspace per call
//    and the C entry zeroes its counters with cudaMemsetAsync on the
//    launch's stream, which orders it before the kernel (no kernel of
//    this library, no ATen op).  A cooperative launch with a grid-wide
//    barrier would need no counters but would hold every block until the
//    slowest, where here only the last of a group goes on.
//  - An add on two warps (16 groups of four threads, the split product of
//    fp384_split.cuh), its scratch area in shared memory (144 elements of
//    48 B), 2 adds a block (128 threads, 14,340 B of static shared memory):
//    each round of products is one pass, through one product site that
//    reads each group's task from a table in shared memory
//    (jac::sum::make_table, packed here as scalar_mul.cu packs the
//    ladder's); a phase of adds runs component c on warp c.  The result
//    stays in its add's p1, and the next level's add k takes p2 from add
//    k + half's.  __syncthreads() ends every phase.
//  - Where an add's operands are equal (a signature twice: public data),
//    the block runs the doubling's three rounds after round 5 for the
//    adds that need it (__syncthreads_or decides, so every thread reaches
//    the same barriers).
//
// Boundary format: points (n, 3, 2, 32), Jacobian, rows of 32
// little-endian 12-bit limbs in int32, canonical and in the Montgomery
// domain; mask (n,) int32 (1 selects); out (3, 2, 32).

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "jac.cuh"

namespace {

using fp384::kLimbs;
using fp384::kWords;
using F = jac::Fp2;
using S = jac::sum::Slots<F>;
using jac::sum::kRounds;

constexpr int kPoint = 3 * F::kE;             // elements of a point
constexpr int kPointWords = kPoint * kWords;  // 72
constexpr int kGroups = jac::ladder::kMostTasks;       // an add's groups
constexpr int kAddThreads = kGroups * split::kGroup;   // 64: two warps
constexpr int kLeaves = jac::sum::kBlockLeaves;        // a block's inputs
constexpr int kThreads = kLeaves / 2 * kAddThreads;    // 128
constexpr int kMaxPoints = 1024;
// The workspace: the counters (zeroed at each launch; 85 at 1,024
// points), then the partials, kPointWords each.
constexpr int kCounterWords = 128;

// A group's task of round r, packed: x | y << 10 | out << 20, out kNowhere
// for a group past the round's last task in a busy warp (it multiplies the
// last task's operands again and stores nothing: the shuffles of the
// split product need every lane of the warp), kSkip for every group of a
// warp past it (the warp skips the round).
constexpr uint32_t kNowhere = 1023, kSkip = 1u << 31;

constexpr uint32_t packed(int r, int g) {
  constexpr jac::ladder::Table t = jac::sum::make_table<F>();
  constexpr int kGroupsPerWarp = 32 / split::kGroup;
  const int n = t.n[r];
  if (g / kGroupsPerWarp * kGroupsPerWarp >= n) return kSkip;
  const jac::ladder::Task& k = t.task[r][g < n ? g : n - 1];
  const uint32_t out = g < n ? static_cast<uint32_t>(k.out) : kNowhere;
  return static_cast<uint32_t>(k.x) | static_cast<uint32_t>(k.y) << 10 |
         out << 20;
}

static_assert(S::kEnd < kNowhere, "every element has a 10-bit index");

// Entry I of the table, a constant of the class (nvcc evaluates the host
// constexpr function there, not in device code).
template <int I>
struct Entry {
  static constexpr uint32_t kValue = packed(I / kGroups, I % kGroups);
};

// The table, entry i by thread i mod kAddThreads (every block has one add
// at least).
template <int... I>
__device__ __forceinline__ void fill(uint32_t* tab,
                                     std::integer_sequence<int, I...>) {
  const int t = threadIdx.x;
  ((t == I % kAddThreads ? (void)(tab[I] = Entry<I>::kValue) : (void)0),
   ...);
}

// Round r of the table on an add's scratch area s, u its thread: the
// block's one product site.
__device__ __forceinline__ void products(const uint32_t* tab, uint32_t* s,
                                         int r, int u) {
  const uint32_t e = tab[r * kGroups + u / split::kGroup];
  if (e & kSkip) return;  // the same for every group of the warp
  const int q = u % split::kGroup;
  uint32_t x[kWords], y[kWords], z[kWords];
  fp12::ld(s, e & 1023, x);
  fp12::ld(s, (e >> 10) & 1023, y);
  split::mont_mul(q, x, y, z);
  const uint32_t out = (e >> 20) & 1023;
  if (q == 0 && out != kNowhere) fp12::st(s, out, z);
}

// A phase of adds: task j kE + c on lane j of the add's warp c.
template <class Ph>
__device__ __forceinline__ void adds(uint32_t* s, int u) {
  const int c = u / 32, j = u % 32;
  if (j < Ph::kTasks / F::kE) Ph::task(j * F::kE + c, s);
}

__device__ __forceinline__ void adds_after(int r, uint32_t* s, int u) {
  using jac::sum::AddsAfter;
  switch (r) {
    case 0: adds<AddsAfter<F, 0>>(s, u); break;
    case 1: adds<AddsAfter<F, 1>>(s, u); break;
    case 2: adds<AddsAfter<F, 2>>(s, u); break;
    case 3: adds<AddsAfter<F, 3>>(s, u); break;
    case 5: adds<AddsAfter<F, 5>>(s, u); break;
    case 6: adds<AddsAfter<F, 6>>(s, u); break;
    default: adds<AddsAfter<F, 7>>(s, u); break;
  }
}

// The timed build (harmony_g2_masked_sum_phases): thread 0 of each block
// reads clock64() after the barriers that end each part of its adds and
// adds the cycles since its last reading to that part's sum; the block
// that writes the sum records its own: clocks (int64, 4 + kParts words):
// [0] the levels it ran, [1] its stages, [2] its cycles and [3] its ns
// (%globaltimer) from its start to the sum, [4 + i] the cycles of part i:
enum Part {
  kLoad,       // the first level's operands (the leaves or the partials)
  kCopy,       // p2 from the level before
  kRound1,     // round r's products at kRound1 + 2 (r - 1), its adds after
  kDouble = kRound1 + 2 * jac::sum::kAddRounds - 1,  // the doubling
  kResult,     // the result's phase
  kHandoff,    // the partial stored, the fence and the counter
  kParts
};

struct Clock {
  unsigned long long* c;  // shared: cycles per part, then the last reading

  __device__ __forceinline__ bool on() const {
    return c != nullptr && threadIdx.x == 0;
  }
  __device__ __forceinline__ void start() const {
    if (!on()) return;
    for (int i = 0; i < kParts; ++i) c[i] = 0;
    c[kParts] = clock64();
  }
  __device__ __forceinline__ void tick(int i) const {
    if (!on()) return;
    const unsigned long long now = clock64();
    c[i] += now - c[kParts];
    c[kParts] = now;
  }
};

__device__ __forceinline__ unsigned long long ns_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One level's adds on the block: add a runs where `on`; every thread
// reaches every barrier.
__device__ __forceinline__ void level(bool on, uint32_t* s, int u,
                                      const uint32_t* tab,
                                      const Clock& clock) {
  bool dbl = false;
#pragma unroll 1
  for (int r = 0; r < jac::sum::kAddRounds; ++r) {
    if (on) products(tab, s, r, u);
    if (r == 3) {  // the flags are final: does any add double?
      dbl = __syncthreads_or(on && jac::sum::doubles<F>(s));
    } else {
      __syncthreads();
    }
    clock.tick(kRound1 + 2 * r);
    if (r + 1 < jac::sum::kAddRounds) {
      if (on) adds_after(r, s, u);
      __syncthreads();
      clock.tick(kRound1 + 2 * r + 1);
    }
  }
  if (dbl) {
    const bool mine = on && jac::sum::doubles<F>(s);
#pragma unroll 1
    for (int r = jac::sum::kDblRound; r < kRounds; ++r) {
      if (mine) products(tab, s, r, u);
      __syncthreads();
      if (mine) adds_after(r, s, u);
      __syncthreads();
    }
    clock.tick(kDouble);
  }
  if (on) adds<jac::sum::Out<F>>(s, u);
  __syncthreads();
  clock.tick(kResult);
}

// Element e of leaf i: the point where i < n and its mask word is 1, else
// element e of (1, 1, 0).
__device__ __forceinline__ void leaf(const int32_t* __restrict__ points,
                                     const int32_t* __restrict__ mask,
                                     int64_t n, int i, int e,
                                     uint32_t w[kWords]) {
  if (i < n && mask[i] == 1) {
    fp384::load_row(points + (static_cast<int64_t>(i) * kPoint + e) * kLimbs,
                    w);
  } else {
    jac::infinity_element<F>(e, w);
  }
}

// A block's shared memory: its adds' scratch areas, the table, and
// whether it goes on to the next stage.
struct Shared {
  uint32_t s[kLeaves / 2][S::kEnd * kWords];
  uint32_t tab[kRounds * kGroups];
  int last;
};

template <bool kTimed>
__device__ __forceinline__ void masked_sum(
    Shared& m, unsigned long long* clk, const int32_t* __restrict__ points,
    const int32_t* __restrict__ mask, uint32_t* __restrict__ ws,
    int64_t* __restrict__ clocks, int32_t* __restrict__ out, int64_t n) {
  const int t = threadIdx.x, a = t / kAddThreads, u = t % kAddThreads;
  uint32_t* s = m.s[a];
  const int size = jac::leaves(n);
  if (size == 1) {  // no add: the one leaf
    if (t < kPoint) {
      uint32_t w[kWords];
      leaf(points, mask, n, 0, t, w);
      fp384::store_row(w, out + t * kLimbs);
    }
    return;
  }
  fill(m.tab, std::make_integer_sequence<int, kRounds * kGroups>{});
  uint32_t* counters = ws;
  uint32_t* partials = ws + kCounterWords;
  const Clock clock{kTimed ? clk : nullptr};
  unsigned long long ns0 = 0, cycles0 = 0;
  if (kTimed && clock.on()) {
    clock.start();
    cycles0 = clk[kParts];
    ns0 = ns_now();
  }
  jac::sum::Stage st = jac::sum::stage(size, kLeaves);
  // the block's group, where its stage's inputs and partials are (in
  // partials), its stage's counters, the stages and levels it ran
  int g = blockIdx.x, in = 0, at = 0, counter = 0, stages = 0, levels = 0;
  __syncthreads();  // the table
#pragma unroll 1
  for (;;) {
    const int half0 = st.leaves / 2;
    if (a < half0) {  // inputs g + m blocks, m = a and a + half0
      if (stages == 0) {
        if (u < 2 * kPoint) {
          const int which = u / kPoint, e = u % kPoint;
          uint32_t w[kWords];
          leaf(points, mask, n, g + (a + which * half0) * st.blocks, e, w);
          fp12::st(s, (which ? S::kP2 : S::kP1) + e, w);
        }
      } else {  // written by other blocks: past L1
        for (int i = u; i < 2 * kPointWords; i += kAddThreads) {
          const int which = i / kPointWords, o = i % kPointWords;
          const int j = g + (a + which * half0) * st.blocks;
          s[(which ? S::kP2 : S::kP1) * kWords + o] =
              __ldcg(partials + (in + j) * kPointWords + o);
        }
      }
    }
    __syncthreads();
    clock.tick(kLoad);
#pragma unroll 1
    for (int half = half0; half >= 1; half /= 2) {
      const bool on = a < half;
      if (half < half0) {  // p2: add a + half's result
        if (on) {
          for (int i = u; i < kPointWords; i += kAddThreads) {
            s[S::kP2 * kWords + i] = m.s[a + half][S::kP1 * kWords + i];
          }
        }
        __syncthreads();
        clock.tick(kCopy);
      }
      level(on, s, u, m.tab, clock);
      ++levels;
    }
    ++stages;
    if (st.blocks == 1) {  // the last stage: the sum
      if (t < kPoint) {
        uint32_t w[kWords];
        fp12::ld(m.s[0], S::kP1 + t, w);
        fp384::store_row(w, out + t * kLimbs);
      }
      if (kTimed && clock.on()) {
        clocks[0] = levels;
        clocks[1] = stages;
        clocks[2] = static_cast<int64_t>(clock64() - cycles0);
        clocks[3] = static_cast<int64_t>(ns_now() - ns0);
        for (int i = 0; i < kParts; ++i) {
          clocks[4 + i] = static_cast<int64_t>(clk[i]);
        }
      }
      return;
    }
    // the block's partial; the last block of its group goes on
    for (int i = t; i < kPointWords; i += blockDim.x) {
      __stcg(partials + (at + g) * kPointWords + i,
             m.s[0][S::kP1 * kWords + i]);
    }
    __threadfence();
    __syncthreads();
    const jac::sum::Stage next = jac::sum::stage(st.blocks, kLeaves);
    const int group = g % next.blocks;
    if (t == 0) {
      m.last = atomicAdd(counters + counter + group, 1u) ==
               static_cast<unsigned>(next.leaves - 1);
    }
    __syncthreads();
    if (!m.last) return;
    __threadfence();
    clock.tick(kHandoff);
    in = at;
    at += st.blocks;
    counter += next.blocks;
    st = next;
    g = group;
  }
}

__global__ void __launch_bounds__(kThreads)
g2_masked_sum_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ mask,
                     uint32_t* __restrict__ ws, int32_t* __restrict__ out,
                     int64_t n) {
  __shared__ __align__(16) Shared m;
  masked_sum<false>(m, nullptr, points, mask, ws, nullptr, out, n);
}

__global__ void __launch_bounds__(kThreads)
g2_masked_sum_phases_kernel(const int32_t* __restrict__ points,
                            const int32_t* __restrict__ mask,
                            uint32_t* __restrict__ ws,
                            int64_t* __restrict__ clocks,
                            int32_t* __restrict__ out, int64_t n) {
  __shared__ __align__(16) Shared m;
  __shared__ unsigned long long clk[kParts + 1];
  masked_sum<true>(m, clk, points, mask, ws, clocks, out, n);
}

template <class Kernel, class... Clocks>
int launch(Kernel kernel, const void* points, const void* mask,
           void* workspace, void* out, int64_t lanes, int64_t n,
           int64_t workspace_words, void* stream, Clocks... clocks) {
  if (lanes != 1 || n < 0 || n > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int size = jac::leaves(n);
  const jac::sum::Needs need = jac::sum::needs(size, kLeaves);
  if (need.counters > kCounterWords ||
      workspace_words <
          kCounterWords + static_cast<int64_t>(need.partials) * kPointWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(workspace, 0, kCounterWords * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<jac::sum::stage(size, kLeaves).blocks, need.adds * kAddThreads,
           0, st>>>(static_cast<const int32_t*>(points),
                    static_cast<const int32_t*>(mask),
                    static_cast<uint32_t*>(workspace),
                    static_cast<int64_t*>(clocks)...,
                    static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

static_assert(kThreads == kLeaves / 2 * kAddThreads, "2 adds a block");

}  // namespace

// C ABI for ctypes.  points is (n, 3, 2, 32), mask (n,), out (3, 2, 32);
// all int32, contiguous, 16-byte aligned (points, out), on the current
// device; lanes must be 1 (one sum a launch), n <= 1024.  workspace is
// workspace_words int32 words on the same device, at least 128 + 72 for
// each partial (24,608 cover n <= 1024), used by this launch alone.
// stream is a cudaStream_t.  The launch (a memset of the counters, then
// the kernel) is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_g2_masked_sum(const void* points, const void* mask,
                                     void* workspace, void* out,
                                     int64_t lanes, int64_t n,
                                     int64_t workspace_words, void* stream) {
  return launch(g2_masked_sum_kernel, points, mask, workspace, out, lanes, n,
                workspace_words, stream);
}

// The timed build (see Clock): the same arguments, and clocks, an int64
// buffer of 4 + kParts (18) words on the device, which the block that
// writes the sum fills.
extern "C" int harmony_g2_masked_sum_phases(const void* points,
                                            const void* mask, void* workspace,
                                            void* clocks, void* out,
                                            int64_t lanes, int64_t n,
                                            int64_t workspace_words,
                                            void* stream) {
  return launch(g2_masked_sum_phases_kernel, points, mask, workspace, out,
                lanes, n, workspace_words, stream, clocks);
}
