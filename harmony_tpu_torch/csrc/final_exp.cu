// The final exponentiation of the BLS12-381 pairing, for Hopper (sm_90a).
// One block runs one lane's whole f^(3 (p^12 - 1) / r) in one launch.
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/pairing.py
// final_exponentiation (the easy part by towers.py fp12_inv and
// fp12_frobenius, then five powers over |x|'s and |x - 1|'s schedules by
// cyclotomic squarings in a fori_loop inside a scan) is jnp code around
// the Pallas multiply that XLA runs as one program.  Run eagerly in
// PyTorch, it was 183 kernel launches (106 fp_addsub, 11 mont_mul, 35
// fp12_mul, 30 runs of fp12_cyclo_sqr, one fp_inv) and 338 other tensor
// ops per call: most of a quorum check's host dispatches.  Here it is one
// launch, and the lane's values never leave the SM.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate), per lane:
//   bytes: 3,072 B (read f, write the result, 1,536 B each);
//   operations: the plain version's Montgomery products: 315 cyclotomic
//   squarings of 18, 34 products of 54 and one square of 36 (the complex
//   method), the inverse's 112 and three Frobenius maps of 18: 7,708
//   products of 576 IMAD, 4,439,808 IMAD (the adds and subs are a few
//   per cent more), and the steps of the inverse's binary GCD on one Fp
//   element (some 270 of about 120 word operations).  This kernel makes
//   7,726 products (f2^2 by the 54-product plan).
// At 1 to 256 lanes the card could do that in at most 0.07 ms.  The cost
// is one lane's dependent chain: 315 squarings of three phases, 35
// products of six, and the inverse's GCD on one thread, a block barrier
// after each phase.  The tensor cores, TMA and wgmma do not serve it: a
// lane moves 3 KB once, and its work is 32-bit word products with carries
// in dependent rounds of 2 to 54 independent products, no matrix tile.
//
// Design: the SM's integer pipes, shuffles, shared memory and registers.
//  - One block of 224 threads per lane (block_threads of the plans), so
//    that every phase of final_exp.cuh is one round: each product takes a
//    group of four threads (the split Montgomery product of
//    fp384_split.cuh; 54 at most), each add task one thread.
//  - The program of final_exp.cuh fixed at compile time, read from
//    constant memory: one squaring body (cyclo.cuh, unchanged), one
//    product body (fp12_plans.cuh, the Miller loop's f times the line),
//    two Frobenius maps, the inverse and the moves, each a plan of phases
//    whose scratch indices are constants, looped over at run time.
//  - The lane's values stay in shared memory, 241 elements of 48 bytes
//    (11,568 B), for the whole call; __syncthreads() ends each phase.
//  - The one Fp inversion is fp384.cuh's binary GCD on thread 0.
//
// Boundary format: f as (lanes, 2, 3, 2, 32) int32 limbs, in and out,
// canonical and in the Montgomery domain, as the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

#include "final_exp.cuh"

namespace {

constexpr int kThreads = final_exp::kThreads;
constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;

__global__ void __launch_bounds__(kThreads)
final_exp_kernel(const int32_t* __restrict__ f, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s[final_exp::kScratch * fp384::kWords];
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  uint32_t w[fp384::kWords];
  if (t < fp12::kElems) {
    fp384::load_row(f + lane * kLaneLimbs + t * fp384::kLimbs, w);
    fp12::st(s, final_exp::kT + t, w);
  }
  __syncthreads();
  final_exp::run_program(phases::Block{s});
  if (t < fp12::kElems) {
    fp12::ld(s, final_exp::kAcc + t, w);
    fp384::store_row(w, out + lane * kLaneLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  f and out are (lanes, 2, 3, 2, 32) int32, contiguous
// and 16-byte aligned, on the current device; stream is a cudaStream_t.
// One block per lane, so lanes < 2^31.  The launch is asynchronous; the
// return value is cudaGetLastError().
extern "C" int harmony_final_exp(const void* f, void* out, int64_t lanes,
                                 void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  final_exp_kernel<<<static_cast<unsigned int>(lanes), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
