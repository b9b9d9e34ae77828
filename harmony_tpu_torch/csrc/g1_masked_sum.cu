// The masked sum of G1 points and its affine form, for Hopper (sm_90a):
// one block per lane of the mask selects the lane's points, pads them to
// a power of two with infinity, sums them as a tree and makes the sum
// affine, in one launch.
//
// Replaces no TPU kernel.  It fuses the JAX package's
// harmony_tpu/ops/curve.py masked_sum (a select by the mask, padding, and
// log2(n) levels of the Jacobian add, jnp code around the Pallas multiply
// that XLA fuses) and to_affine (one Fermat inversion and four products).
// Run eagerly in PyTorch, one quorum check's sum at bucket 256 was 216
// fp_addsub and 80 mont_mul launches, 633 other tensor ops and one
// fp_inv launch.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate), per lane of n points:
//   bytes: read the points (256 B affine, 384 B Jacobian each) and the
//   mask words, write the sum (384 B) and its affine form (256 B);
//   operations: Montgomery products of 576 IMAD, for each add of two
//   finite points 16, 11 where one has Z = 1 and 6 where both have (an
//   affine leaf, or one passed up against infinity); the inversion's
//   batches and 4 products for the affine form.
// At 1 to 256 lanes both bounds are microseconds or less.  The cost is
// one lane's dependent chain: log2(n) levels of adds (rounds of products
// with the adds between them, and a barrier), then the inversion on one
// thread.
//
// Design: the SM's integer pipes, shuffles, votes and shared memory.
//  - One block per lane: the lane's points, selected and padded, sit in
//    shared memory (144 B each; 147,456 B at bucket 1024, above the 48 KB
//    default, so the entry point raises the kernel's dynamic shared memory
//    limit first).  Each level adds point k + half into point k, in place.
//  - Each add of a level takes G = 1, 2 or 4 groups of split::kGroup
//    threads, as many as the level leaves idle (4 groups once the adds
//    fit), inside one warp.  It runs g1.cuh's program of add-2007-bl in
//    rounds of independent products (16 products in 5 rounds; 6 in 3 on
//    the first level of an affine table, whose Z are 1), the products of a
//    round G at a time, each on one group by the split product of
//    fp384_split.cuh, whose threads store their words of it into the add's
//    scratch area in shared memory; __syncwarp() ends each round.  Up to
//    512 threads (128 groups; 256 above bucket 512, for shared memory), so
//    bucket 256's first level is one pass of 6 products a group, its
//    second 9 rounds, and every later level 5.  A warp with no add left
//    in a pass skips it; a group past the last add in a busy warp adds two
//    points at infinity and stores nothing.  Where some add of a warp has
//    equal operands, the warp runs the doubling's 7 products in 3 rounds.
//  - The affine form: the first four threads invert Z (fp384::inv4,
//    batched binary GCD steps), then the first warp makes the four
//    products in two rounds.
//
// Boundary format: points (n, C, 32), one table for every lane, with C = 3
// (Jacobian: masked_sum's own form) or 2 (affine, (0, 0) for infinity: the
// resident key table); mask (n, lanes) int32; out (lanes, 3, 32) and
// affine (lanes, 2, 32): rows of 32 little-endian 12-bit limbs in int32,
// canonical and in the Montgomery domain.  Without an affine buffer the
// kernel stops at the sum and inverts nothing.

#include <cstdint>

#include <cuda_runtime.h>

#include "g1.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPoints = 1024;
constexpr int kGroupsPerWarp = 32 / split::kGroup;
constexpr int kLimbs = fp384::kLimbs;
constexpr int kAddWords = g1::kSlots * fp384::kWords;  // an add's scratch
using fp384::kWords;
using g1::kPoint;

// Runs a program's rounds (g1.cuh) on an add's groups: group q of G, lane
// r of its group.  Every lane of the warp calls it with the same G.
struct Rounds {
  int groups, q, r;
  bool ones;
  const uint32_t *p1, *p2;
  uint32_t* sc;

  __device__ __forceinline__ void operator()(int prog) const {
    const int n = g1::rounds(prog);
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const int lo = g1::round_start(prog, i);
      const int hi = g1::round_start(prog, i + 1);
#pragma unroll 1
      for (int j0 = lo; j0 < hi; j0 += groups) {
        const bool mine = j0 + q < hi;  // else the round's first again
        const int k = g1::product_slot(prog, mine ? j0 + q : lo);
        uint32_t x[kWords], y[kWords], z[kWords];
        g1::operands(prog, k, ones, p1, p2, sc, x, y);
        split::mont_mul(r, x, y, z);
        if (mine && r == 0) fp12::st(sc, k, z);
      }
      __syncwarp();
    }
  }
};

struct WarpAny {
  __device__ __forceinline__ bool operator()(bool c) const {
    return __any_sync(0xffffffffu, c);
  }
};

// The threads of a block: 4 groups an add of the first level, in whole
// warps, at most 512 (256 above bucket 512, so that the adds' scratch
// and the leaves fit in shared memory).
int block_threads(int64_t n) {
  const int size = g1::leaves(n);
  const int most = size > 512 ? 256 : kMaxThreads;
  const int want = size / 2 * 4 * split::kGroup;
  return want <= 32 ? 32 : (want < most ? want : most);
}

// The shared memory of a lane of n points: the padded leaves, a point at
// infinity of zero words for the idle groups, a scratch area for each
// group (the most adds one pass can hold), and Z^-1.
int shared_words(int64_t n) {
  return (g1::leaves(n) + 1) * kPoint +
         block_threads(n) / split::kGroup * kAddWords + kWords;
}

__global__ void __launch_bounds__(kMaxThreads)
g1_masked_sum_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int32_t* __restrict__ affine,
                     int64_t n, int coords, int64_t lanes) {
  extern __shared__ __align__(16) uint32_t s[];
  const int size = g1::leaves(n);
  const int groups = blockDim.x / split::kGroup;
  uint32_t* zero = s + size * kPoint;
  uint32_t* scratch = zero + kPoint;
  uint32_t* zi = scratch + groups * kAddWords;
  const int64_t lane = blockIdx.x;
  const int t = threadIdx.x;

  // the leaves: the lane's selected points, infinity elsewhere
  for (int i = t; i < size; i += blockDim.x) {
    uint32_t pt[kPoint];
    const bool on = i < n && mask[i * lanes + lane] == 1;
    if (on) {
      const int32_t* src = points + i * coords * kLimbs;
      fp384::load_row(src, pt);
      fp384::load_row(src + kLimbs, pt + kWords);
      if (coords == 3) fp384::load_row(src + 2 * kLimbs, pt + 2 * kWords);
    }
    g1::leaf(on, coords == 2, pt);
#pragma unroll
    for (int j = 0; j < kPoint; ++j) s[i * kPoint + j] = pt[j];
  }
  for (int j = t; j < kPoint; j += blockDim.x) zero[j] = 0;
  __syncthreads();

  // the tree: point k + half into point k, G groups an add
  const int g = t / split::kGroup, r = t % split::kGroup;
  for (int half = size / 2; half >= 1; half /= 2) {
    int G = 1;
    while (G < 4 && half * 2 * G <= groups) G *= 2;
    const int at_once = groups / G;  // adds a pass
    const int a = g / G;             // the thread's add in a pass
    const int u = g % G * split::kGroup + r;  // its place in the add
    const int warp_first = t / 32 * kGroupsPerWarp / G;
    const bool ones = coords == 2 && half == size / 2;
    for (int base = 0; base < half; base += at_once) {
      if (base + warp_first >= half) continue;  // the whole warp is idle
      const int k = base + a;
      const bool on = k < half;
      const uint32_t* p1 = on ? s + k * kPoint : zero;
      const uint32_t* p2 = on ? s + (k + half) * kPoint : zero;
      uint32_t* sc = scratch + a * kAddWords;
      const g1::Flags f = g1::add_in_rounds(
          Rounds{G, g % G, r, ones, p1, p2, sc}, WarpAny{}, ones, p1, p2, sc);
      uint32_t w[kWords];
      if (u < 3) g1::result(u, ones, f, p1, p2, sc, w);
      __syncwarp();  // the add has read point k before it is written
      if (on && u < 3) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) s[k * kPoint + u * kWords + j] = w[j];
      }
    }
    __syncthreads();
  }

  // the sum, and its affine form where it is asked for
  if (t < 3) fp384::store_row(s + t * kWords, out + (lane * 3 + t) * kLimbs);
  if (affine != nullptr && t < 32) {
    if (t < 4) {
      uint32_t z[kWords], w[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) z[j] = s[2 * kWords + j];
      fp384::inv4(t, 0xfu, z, w);
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) zi[j] = w[j];
      }
    }
    __syncwarp();
    // two groups a copy: the first warp's four copies are the same
    uint32_t* sc = scratch + g / 2 * kAddWords;
    Rounds{2, g % 2, r, false, s, zi, sc}(g1::kAffine);
    if (t < 2) {
      const bool inf = g1::is_zero(g1::Z(s));
      uint32_t w[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) {
        w[j] = inf ? 0u : sc[(2 + t) * kWords + j];
      }
      fp384::store_row(w, affine + (lane * 2 + t) * kLimbs);
    }
  }
}

}  // namespace

// C ABI for ctypes.  points is (n, C, 32) with C = coords (3 Jacobian, 2
// affine); mask is (n, lanes); out (lanes, 3, 32) and affine (lanes, 2,
// 32), or a null affine for the sum alone; all int32, contiguous, 16-byte
// aligned, on the current device; n <= 1024 and lanes < 2^31.  stream is a
// cudaStream_t.  The launch is asynchronous; the return value is
// cudaGetLastError().
extern "C" int harmony_g1_masked_sum(const void* points, const void* mask,
                                     void* out, int64_t lanes, void* affine,
                                     int64_t n, int32_t coords,
                                     void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff || n < 0 || n > kMaxPoints ||
      (coords != 2 && coords != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = shared_words(n) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {  // above the default limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        g1_masked_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g1_masked_sum_kernel<<<static_cast<unsigned int>(lanes), block_threads(n),
                         bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(points), static_cast<const int32_t*>(mask),
      static_cast<int32_t*>(out), static_cast<int32_t*>(affine), n, coords,
      lanes);
  return static_cast<int>(cudaGetLastError());
}
