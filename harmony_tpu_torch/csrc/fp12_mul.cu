// Batched Fp12 products over the BLS12-381 tower, for Hopper (sm_90a).
// One block computes one lane's product a b in one launch; fp12_sqr is the
// same kernel on (a, a).
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/towers.py
// fp12_mul (and fp12_sqr) is jnp code around the Pallas multiply, fused by
// XLA: Karatsuba pre-adds, one stacked 54-product Montgomery multiply, and
// post-combines.  Run eagerly in PyTorch, that was 31 fp_addsub launches,
// one mont_mul launch and the stacks and copies between them.  Here the
// whole product is one launch, and its intermediates never leave the SM.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate):
//   bytes: 4,608 B per lane (read a and b, 1,536 B each; write 1,536 B);
//   operations: 54 Montgomery products of 288 32x32->64-bit word
//   products, 2 IMAD each: 31,104 IMAD per lane (the ~200 adds and subs
//   are a few per cent more).
// At the path's 1 to 128 lanes both bounds are well under a microsecond;
// the launch and one lane's dependent chain are the cost.  The tensor
// cores, TMA and wgmma do not serve it: a lane moves 4.6 KB once, and its
// work is 32-bit word products with carries in one round of 54
// independent products between rounds of adds, no matrix tile.
//
// Design: the plan of fp12_plans.cuh Fp12Product, the Miller loop's f
// times the line, on the SM's integer pipes, shuffles and shared memory.
//  - One block per lane (224 threads, block_threads of the plan), so that
//    every phase is one round: the 54 products of the Karatsuba-2/3/2
//    product at once, each on a group of four threads by the split
//    Montgomery product (fp384_split.cuh), each add task on one thread.
//  - Six phases, each a type (phases.cuh), so every scratch index is a
//    constant and no register array is indexed at run time; the adds
//    chain their carries in PTX; __syncthreads() ends each phase.
//  - a, b and the intermediates sit in shared memory, 180 elements of 48
//    bytes (8,640 B).
// The squaring runs the product on (a, a) and not the 36-product complex
// method of the plain version: both give the canonical residue, so the
// limbs are the same, and one kernel serves both.
//
// Same boundary format as the Fp kernels: lanes of 12 rows of 32
// little-endian 12-bit limbs in int32 ((..., 2, 3, 2, 32)), canonical in
// and out; rows are unpacked to words only on load and store.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp12_plans.cuh"

namespace {

constexpr int kA = 0;   // 12: a, then the product
constexpr int kB = 12;  // 12: b
using Mul = fp12_plans::Fp12Product<kA, kB, kA, 24>;
constexpr int kScratch = Mul::kEnd;  // 180 elements
constexpr int kThreads = phases::block_threads<Mul::Plan>();
constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;

__global__ void __launch_bounds__(kThreads)
fp12_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s[kScratch * fp384::kWords];
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  uint32_t w[fp384::kWords];
  if (t < 2 * fp12::kElems) {
    const int32_t* src = t < fp12::kElems ? a : b;
    fp384::load_row(
        src + lane * kLaneLimbs + (t % fp12::kElems) * fp384::kLimbs, w);
    fp12::st(s, kA + t, w);  // b follows a
  }
  __syncthreads();
  phases::Block{s}(Mul::Plan{});
  if (t < fp12::kElems) {
    fp12::ld(s, kA + t, w);
    fp384::store_row(w, out + lane * kLaneLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  a, b and out are (lanes, 2, 3, 2, 32) int32,
// contiguous and 16-byte aligned, on the current device (a and b may be
// the same tensor); stream is a cudaStream_t.  One block per lane, so
// lanes < 2^31.  The launch is asynchronous; the return value is
// cudaGetLastError().
extern "C" int harmony_fp12_mul(const void* a, const void* b, void* out,
                                int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fp12_mul_kernel<<<static_cast<unsigned int>(lanes), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
