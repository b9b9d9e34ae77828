// Batched Fp12 products over the BLS12-381 tower, for Hopper (sm_90a).
// One warp computes one lane's product a b in one launch; fp12_sqr is the
// same kernel on (a, a).
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/towers.py
// fp12_mul (and fp12_sqr) is jnp code around the Pallas multiply, fused by
// XLA: Karatsuba pre-adds, one stacked 54-product Montgomery multiply, and
// post-combines.  Run eagerly in PyTorch, that was 31 fp_addsub launches,
// one mont_mul launch and the stacks and copies between them, and it made
// most of a quorum check's host dispatches.  Here the whole product is one
// launch, and its intermediates never leave the SM.
//
// Design.  The path calls this at 1 to 128 lanes, so one thread per lane
// would run 54 dependent 381-bit products in a row.  Instead a warp takes
// a lane and its threads share the independent work of each phase of the
// plan in fp12.cuh (12 to 54 tasks: an Fp add, sub or Montgomery product
// each, on 32-bit words of fp384.cuh), with the lane's intermediates in
// shared memory, 162 elements of 48 bytes (7,776 B), and __syncwarp()
// between phases.  Four lanes per block: 31 KB of static shared memory.
// The squaring runs the product on (a, a) and not the 36-product complex
// method of the plain version: both give the canonical residue, so the
// limbs are the same, and one kernel serves both.
//
// Same boundary format as the Fp kernels: lanes of 12 rows of 32
// little-endian 12-bit limbs in int32 ((..., 2, 3, 2, 32)), canonical in
// and out; rows are unpacked to words only on load and store.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate):
//   bytes: 4,608 B per lane (read a and b, 1,536 B each; write 1,536 B);
//   operations: 54 Montgomery products of 288 32x32->64-bit word
//   products, 2 IMAD each: 31,104 IMAD per lane (the ~200 adds and subs
//   are a few per cent more).
// At the path's 1 to 128 lanes both bounds are well under a microsecond;
// the launch and one warp's dependent chain (two rounds of products, each
// a 12-step CIOS, and six phases of adds) are the cost.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp12.cuh"

namespace {

constexpr int kLanesPerBlock = 4;
constexpr int kThreads = 32 * kLanesPerBlock;
constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;

__global__ void __launch_bounds__(kThreads)
fp12_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t lanes) {
  __shared__ __align__(16)
      uint32_t scratch[kLanesPerBlock][fp12::kMulScratch * fp384::kWords];
  const int t = threadIdx.x % 32;
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + threadIdx.x / 32;
  if (lane >= lanes) return;  // the whole warp
  uint32_t* s = scratch[threadIdx.x / 32];
  uint32_t w[fp384::kWords];
  if (t < 2 * fp12::kElems) {
    const int32_t* src = t < fp12::kElems ? a : b;
    fp384::load_row(src + lane * kLaneLimbs + (t % fp12::kElems) * fp384::kLimbs,
                    w);
    fp12::st(s, t < fp12::kElems ? fp12::kMulA + t : fp12::kMulB + t - 12, w);
  }
  __syncwarp();
#pragma unroll
  for (int phase = 0; phase < fp12::kMulPhases; ++phase) {
    for (int k = t; k < fp12::mul_tasks(phase); k += 32) {
      fp12::mul_task(phase, k, s);
    }
    __syncwarp();
  }
  if (t < fp12::kElems) {
    fp12::ld(s, fp12::kMulOut + t, w);
    fp384::store_row(w, out + lane * kLaneLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  a, b and out are (lanes, 2, 3, 2, 32) int32,
// contiguous and 16-byte aligned, on the current device (a and b may be
// the same tensor); stream is a cudaStream_t.  The launch is asynchronous;
// the return value is cudaGetLastError().
extern "C" int harmony_fp12_mul(const void* a, const void* b, void* out,
                                int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  const int64_t blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  fp12_mul_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
