// Runs of cyclotomic squarings over the BLS12-381 tower, for Hopper
// (sm_90a).  One block squares one lane's Fp12 value n times in one
// launch.
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
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s):
//   bytes: 3,072 B per lane whatever n (read 1,536 B, write 1,536 B);
//   operations: 18 Montgomery products of 576 IMAD per squaring, 10,368 n
//   IMAD per lane.
// A quorum check squares one lane, so both bounds are nanoseconds.  The
// cost is the dependent chain of n squarings, each three phases
// (cyclo.cuh): the pre-adds, one round of 18 products, and one round of
// adds.  The tensor cores, TMA and wgmma do not serve it: a lane moves
// 3 KB once, and its work is 32-bit word products with carries in
// dependent rounds of 18, no matrix tile.
//
// Design: the SM's integer pipes, shuffles, shared memory and registers.
// One block of 128 threads takes a lane, so the card runs up to 132 lanes
// side by side; the value, its pre-adds and the products stay in shared
// memory (36 elements of 48 bytes, 1,728 B) for all n squarings, and
// device memory is read once and written once.  Each phase is a type
// (phases.cuh), so its scratch indices are constants and no register
// array is indexed at run time; each kind of task has warps of its own.
// The phase of products has one product site: each task forms its two
// operands, then every task's group of four threads runs the split
// Montgomery product of fp384_split.cuh together.  The adds chain their
// carries in PTX (phases.cuh).  __syncthreads() ends each phase.  It
// evaluates the plain version's polynomial, so it agrees bit for bit on
// any input, unitary or not.
//
// Same boundary format as the Fp kernels: lanes of (2, 3, 2, 32) int32
// 12-bit limbs, canonical in and out.

#include <cstdint>

#include <cuda_runtime.h>

#include "cyclo.cuh"

namespace {

constexpr int kThreads = cyclo::kThreads;
constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;

__global__ void __launch_bounds__(kThreads)
fp12_cyclo_sqr_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
                      int n) {
  __shared__ __align__(16) uint32_t s[cyclo::kScratch * fp384::kWords];
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  uint32_t w[fp384::kWords];
  if (t < fp12::kElems) {
    fp384::load_row(a + lane * kLaneLimbs + t * fp384::kLimbs, w);
    fp12::st(s, cyclo::kV + t, w);
  }
  __syncthreads();
  const phases::Block run{s};
#pragma unroll 1
  for (int round = 0; round < n; ++round) run(cyclo::Square{});
  if (t < fp12::kElems) {
    fp12::ld(s, cyclo::kV + t, w);
    fp384::store_row(w, out + lane * kLaneLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  a and out are (lanes, 2, 3, 2, 32) int32, contiguous
// and 16-byte aligned, on the current device; n >= 0 is the number of
// squarings (0 copies a); stream is a cudaStream_t.  One block per lane,
// so lanes < 2^31.  The launch is asynchronous; the return value is
// cudaGetLastError().
extern "C" int harmony_fp12_cyclo_sqr(const void* a, void* out, int64_t lanes,
                                      int32_t n, void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fp12_cyclo_sqr_kernel<<<static_cast<unsigned int>(lanes), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
