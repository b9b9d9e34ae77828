// Runs of cyclotomic squarings over the BLS12-381 tower, for Hopper
// (sm_90a).  One warp squares one lane's Fp12 value n times in one launch.
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/towers.py
// fp12_cyclo_sqr (Granger-Scott: 9 Fp2 squarings, 18 Fp products, and the
// linear combinations z0..z5) is jnp code around the Pallas multiply, and
// harmony_tpu/ops/pairing.py runs it in a fori_loop inside a scan over
// |x|'s schedule, all fused by XLA.  Run eagerly in PyTorch, one squaring
// was 47 fp_addsub launches, one mont_mul launch and the stacks around
// them, and the final exponentiation makes 315 of them.  Here the loop is
// inside the kernel: one launch per run of squarings of the schedule
// (runs of 1, 2, 3, 9, 32 and 16), 30 launches in place of 315 squarings.
//
// Design.  The final exponentiation has one lane per quorum check, so the
// work of one squaring is spread over a warp: 18 product tasks (each with
// its own pre-adds), then 12 tasks that form z0..z5, as planned in
// fp12.cuh, with __syncwarp() between them.  The lane's value, the next
// one and the 18 products stay in shared memory (42 elements of 48 bytes,
// 2,016 B) for all n squarings; device memory is read once and written
// once.  It evaluates the plain version's polynomial (the same t0..t8 and
// z0..z5), so it agrees bit for bit on any input, unitary or not.
//
// Same boundary format as the Fp kernels: lanes of (2, 3, 2, 32) int32
// 12-bit limbs, canonical in and out.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s):
//   bytes: 3,072 B per lane whatever n (read 1,536 B, write 1,536 B);
//   operations: 18 Montgomery products of 576 IMAD per squaring, 10,368 n
//   IMAD per lane.
// At one lane both bounds are nanoseconds; the cost is the dependent chain
// of n squarings, each one round of products and one of adds on a warp.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp12.cuh"

namespace {

constexpr int kLanesPerBlock = 4;
constexpr int kThreads = 32 * kLanesPerBlock;
constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;

__global__ void __launch_bounds__(kThreads)
fp12_cyclo_sqr_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                      int64_t lanes, int n) {
  __shared__ __align__(16)
      uint32_t scratch[kLanesPerBlock][fp12::kCycloScratch * fp384::kWords];
  const int t = threadIdx.x % 32;
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + threadIdx.x / 32;
  if (lane >= lanes) return;  // the whole warp
  uint32_t* s = scratch[threadIdx.x / 32];
  uint32_t w[fp384::kWords];
  if (t < fp12::kElems) {
    fp384::load_row(a + lane * kLaneLimbs + t * fp384::kLimbs, w);
    fp12::st(s, fp12::cyclo_value(0) + t, w);
  }
  __syncwarp();
  for (int round = 0; round < n; ++round) {
#pragma unroll
    for (int phase = 0; phase < fp12::kCycloPhases; ++phase) {
      if (t < fp12::cyclo_tasks(phase)) fp12::cyclo_task(phase, t, round, s);
      __syncwarp();
    }
  }
  if (t < fp12::kElems) {
    fp12::ld(s, fp12::cyclo_value(n) + t, w);
    fp384::store_row(w, out + lane * kLaneLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  a and out are (lanes, 2, 3, 2, 32) int32, contiguous
// and 16-byte aligned, on the current device; n >= 0 is the number of
// squarings (0 copies a); stream is a cudaStream_t.  The launch is
// asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_fp12_cyclo_sqr(const void* a, void* out, int64_t lanes,
                                      int32_t n, void* stream) {
  if (lanes <= 0) return 0;
  const int64_t blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  fp12_cyclo_sqr_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), lanes, n);
  return static_cast<int>(cudaGetLastError());
}
