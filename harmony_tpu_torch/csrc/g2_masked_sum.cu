// The masked sum of G2 points (the twist, over Fp2), for Hopper (sm_90a):
// one block selects the points whose mask word is 1, pads them to a power
// of two with infinity and sums them as a tree, in one launch.  The
// signatures' aggregate of ops/bls.py aggregate_sigs.
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
// the tree: log2(n) levels, each as many passes of adds as the level has
// adds over the block's warps, each add 5 rounds of products (7 passes of
// a warp's 8 groups) with phases of adds between them.
//
// Design: the SM's integer pipes, shuffles and shared memory, on the
// plans of jac.cuh.
//  - One warp per add, up to 16 warps (8 above 512 points): the add's
//    rounds of products 8 at a time, each on a group of four threads (the
//    split product of fp384_split.cuh), its phases of adds a task a
//    thread, __syncwarp() after each phase.  Where the add's operands are
//    equal (a signature twice) the warp runs the doubling too; then one
//    phase forms the result with curve.py add's selects.
//  - Shared memory: each warp's add has its scratch area (113 elements of
//    48 B: the two points, the result, the doubling and the
//    intermediates).  The points of a lane do not fit: 1024 G2 points are
//    288 KB against the 227 KB a block may have.  So the first level
//    reads its operands straight from device memory (selected by the
//    mask, infinity past n), and only its results, half the leaves (at
//    most 512, 147,456 B), stay in shared memory, each later level adding
//    point k + half into point k in place.  At 1024 points 8 warps keep
//    the block at 190,848 B; above the default 48 KB, so the entry point
//    raises the kernel's dynamic shared memory limit first.
//
// Boundary format: points (n, 3, 2, 32), Jacobian, rows of 32
// little-endian 12-bit limbs in int32, canonical and in the Montgomery
// domain; mask (n,) int32 (1 selects); out (3, 2, 32).

#include <cstdint>

#include <cuda_runtime.h>

#include "jac.cuh"

namespace {

using fp384::kLimbs;
using fp384::kWords;
using Add = jac::SumAdd<jac::Fp2>;

constexpr int kMaxThreads = 512;
constexpr int kMaxPoints = 1024;
constexpr int kGroupsPerWarp = 32 / split::kGroup;
constexpr int kPoint = 3 * jac::Fp2::kE;  // elements of a point

// Runs plans of phases on one warp's add: a product phase's tasks
// kGroupsPerWarp at a time, each on a group of split::kGroup threads (a
// group past the last task multiplies the last task's operands again and
// stores nothing, so the shuffles see the whole warp); a phase of adds a
// task a thread.  __syncwarp() ends every phase.
struct Warp {
  uint32_t* s;
  int lane;

  template <class Ph>
  __device__ __forceinline__ void phase() const {
    if constexpr (Ph::kProduct) {
      const int g = lane / split::kGroup, r = lane % split::kGroup;
#pragma unroll 1
      for (int k0 = 0; k0 < Ph::kTasks; k0 += kGroupsPerWarp) {
        const int k = k0 + g;
        const bool mine = k < Ph::kTasks;
        uint32_t x[kWords], y[kWords], z[kWords];
        const int out = Ph::operands(mine ? k : Ph::kTasks - 1, s, x, y);
        split::mont_mul(r, x, y, z);
        if (mine && r == 0 && out >= 0) fp12::st(s, out, z);
      }
    } else {
#pragma unroll 1
      for (int k = lane; k < Ph::kTasks; k += 32) Ph::task(k, s);
    }
    __syncwarp();
  }

  template <class... Ph>
  __device__ __forceinline__ bool operator()(phases::Plan<Ph...>) const {
    (phase<Ph>(), ...);
    return true;
  }
};

// The warps of a block for n points: one per add of the first level, at
// most 16 (8 above 512 points, for shared memory).
int block_warps(int64_t n) {
  const int adds = jac::leaves(n) / 2;
  const int most = jac::leaves(n) > 512 ? 8 : kMaxThreads / 32;
  return adds < 1 ? 1 : (adds < most ? adds : most);
}

// The shared memory of n points: the first level's sums, and each warp's
// scratch area.
int shared_words(int64_t n) {
  const int kept = jac::leaves(n) > 1 ? jac::leaves(n) / 2 : 1;
  return (kept * kPoint + block_warps(n) * Add::kScratch) * kWords;
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
    jac::infinity_element<jac::Fp2>(e, w);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
g2_masked_sum_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ mask,
                     int32_t* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int size = jac::leaves(n);
  const int warps = blockDim.x / 32;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  uint32_t* kept = sm;  // the first level's sums, point k at k * kPoint
  uint32_t* s = sm + (size > 1 ? size / 2 : 1) * kPoint * kWords +
                warp * Add::kScratch * kWords;
  constexpr int kPointWords = kPoint * kWords;

  if (size == 1) {  // no add: the one leaf
    if (t < kPoint) {
      uint32_t w[kWords];
      leaf(points, mask, n, 0, t, w);
      fp384::store_row(w, out + t * kLimbs);
    }
    return;
  }
  for (int half = size / 2; half >= 1; half /= 2) {
#pragma unroll 1
    for (int k = warp; k < half; k += warps) {
      if (half == size / 2) {  // leaves k and k + half from device memory
        if (lane < 2 * kPoint) {
          const int which = lane / kPoint, e = lane % kPoint;
          uint32_t w[kWords];
          leaf(points, mask, n, k + which * half, e, w);
          fp12::st(s, (which ? Add::kIn2 : Add::kIn1) + e, w);
        }
      } else {  // points k and k + half of the level before
        for (int j = lane; j < 2 * kPointWords; j += 32) {
          const int which = j / kPointWords, o = j % kPointWords;
          s[(which ? Add::kIn2 : Add::kIn1) * kWords + o] =
              kept[(k + which * half) * kPointWords + o];
        }
      }
      __syncwarp();
      jac::sum_add<jac::Fp2>(Warp{s, lane}, s);
      for (int j = lane; j < kPointWords; j += 32) {
        kept[k * kPointWords + j] = s[Add::kOut * kWords + j];
      }
      __syncwarp();
    }
    __syncthreads();
  }
  if (t < kPoint) {
    uint32_t w[kWords];
    fp12::ld(kept, t, w);
    fp384::store_row(w, out + t * kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  points is (n, 3, 2, 32), mask (n,), out (3, 2, 32);
// all int32, contiguous, 16-byte aligned (points, out), on the current
// device; lanes must be 1 (one sum a launch), n <= 1024.  stream is a
// cudaStream_t.  The launch is asynchronous; the return value is
// cudaGetLastError().
extern "C" int harmony_g2_masked_sum(const void* points, const void* mask,
                                     void* out, int64_t lanes, int64_t n,
                                     void* stream) {
  if (lanes != 1 || n < 0 || n > kMaxPoints) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = shared_words(n) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {  // above the default limit: opt in
    const cudaError_t err = cudaFuncSetAttribute(
        g2_masked_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  g2_masked_sum_kernel<<<1, block_warps(n) * 32, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(points), static_cast<const int32_t*>(mask),
      static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
