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
//   steps and 4 products for the affine form.
// At 1 to 256 lanes both bounds are microseconds or less.  The cost is
// one lane's dependent chain: log2(n) levels of 16 products each (plus
// the adds and a block barrier), then the inversion on one thread.
//
// Design: the SM's integer pipes, shuffles and shared memory.
//  - One block per lane: the lane's points, selected and padded, sit in
//    shared memory (144 B each; 147,456 B at bucket 1024, above the 48 KB
//    default, so the entry point raises the kernel's dynamic shared memory
//    limit first).  Each level adds point k + half into point k, in place.
//  - Each add of a level takes a group of split::kGroup threads, which run
//    the add-2007-bl formula of g1.cuh with each product split over the
//    group (fp384_split.cuh) and shared back by four-lane shuffles; up to
//    64 groups (256 threads), so bucket 256's first level is two rounds,
//    bucket 1024's eight.  A warp with no add left in a round skips it; a
//    group past the last add in a busy warp adds two points at infinity
//    and stores nothing.  Adds whose operands are equal double, and the
//    doubling runs only in warps where some add needs it.
//  - The affine form: thread 0 inverts Z (fp384::inv, the binary extended
//    GCD), then the first warp makes the four products.
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

constexpr int kMaxThreads = 256;
constexpr int kMaxPoints = 1024;
constexpr int kGroupsPerWarp = 32 / split::kGroup;
constexpr int kLimbs = fp384::kLimbs;
using fp384::kWords;
using g1::kPoint;

// The Montgomery product on a group of split::kGroup lanes: every lane of
// the warp calls it; each lane of the group gets the product.
struct GroupMul {
  int r;  // the lane's place in its group

  __device__ __forceinline__ void operator()(const uint32_t* a,
                                             const uint32_t* b,
                                             uint32_t* out) const {
    uint32_t t[kWords];
    split::mont_mul(r, a, b, t);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      out[j] = __shfl_sync(0xffffffffu, t[j], 0, split::kGroup);
    }
  }
};

struct WarpAny {
  __device__ __forceinline__ bool operator()(bool c) const {
    return __any_sync(0xffffffffu, c);
  }
};

// The shared memory of a lane of n points: the padded leaves, a point at
// infinity of zero words for the idle groups, and Z^-1.
int shared_words(int64_t n) { return (g1::leaves(n) + 1) * kPoint + kWords; }

// The threads of a block: a group per add of the first level, in whole
// warps, at most kMaxThreads.
int block_threads(int64_t n) {
  const int want = g1::leaves(n) / 2 * split::kGroup;
  return want <= 32 ? 32 : (want < kMaxThreads ? want : kMaxThreads);
}

__global__ void __launch_bounds__(kMaxThreads)
g1_masked_sum_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int32_t* __restrict__ affine,
                     int64_t n, int coords, int64_t lanes) {
  extern __shared__ __align__(16) uint32_t s[];
  const int size = g1::leaves(n);
  uint32_t* zero = s + size * kPoint;
  uint32_t* zi = zero + kPoint;
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

  // the tree: point k + half into point k
  const int groups = blockDim.x / split::kGroup;
  const int g = t / split::kGroup, r = t % split::kGroup;
  const int warp_first = t / 32 * kGroupsPerWarp;
  for (int half = size / 2; half >= 1; half /= 2) {
    for (int base = 0; base < half; base += groups) {
      if (base + warp_first >= half) continue;  // the whole warp is idle
      const int k = base + g;
      const bool on = k < half;
      uint32_t sum[kPoint];
      g1::add(GroupMul{r}, WarpAny{}, on ? s + k * kPoint : zero,
              on ? s + (k + half) * kPoint : zero, sum);
      __syncwarp();  // the group has read point k before any lane writes it
      if (on) {
#pragma unroll
        for (int j = 0; j < kPoint; ++j) {
          if (j % split::kGroup == r) s[k * kPoint + j] = sum[j];
        }
      }
    }
    __syncthreads();
  }

  // the sum, and its affine form where it is asked for
  if (t < 3) fp384::store_row(s + t * kWords, out + (lane * 3 + t) * kLimbs);
  if (affine != nullptr && t < 32) {
    if (t == 0) {
      uint32_t z[kWords], w[kWords];
#pragma unroll
      for (int j = 0; j < kWords; ++j) z[j] = s[2 * kWords + j];
      fp384::inv(z, w);
#pragma unroll
      for (int j = 0; j < kWords; ++j) zi[j] = w[j];
    }
    __syncwarp();
    uint32_t xy[2 * kWords];
    g1::affine(GroupMul{r}, s, zi, xy);
    if (t == 0) {
      fp384::store_row(xy, affine + lane * 2 * kLimbs);
      fp384::store_row(xy + kWords, affine + (lane * 2 + 1) * kLimbs);
    }
  }
}

}  // namespace

// C ABI for ctypes.  points is (n, C, 32) with C = coords (3 Jacobian, 2
// affine); mask is (n, lanes); out (lanes, 3, 32) and affine (lanes, 2,
// 32), or a null affine for the sum alone; all int32, contiguous, 16-byte
// aligned, on the current device; n <= 1024 and lanes < 2^31.  stream is a cudaStream_t.  The launch is asynchronous;
// the return value is cudaGetLastError().
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
