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
//   per cent more), and the batches of the inverse's binary GCD on one Fp
//   element (some 19 of about 1,300 word operations).  This kernel makes
//   7,726 products (f2^2 by the 54-product plan).
// At 1 to 256 lanes the card could do that in at most 0.07 ms.  The cost
// is one lane's dependent chain: 315 squarings of three phases, 35
// products of six, and the inverse's batches on four threads, a block
// barrier after each phase.  Measured on an H100 (PERF.md), a squaring
// is a Montgomery product (about 0.7 us: 12 iterations of a chain through
// one shuffle) and some 5 dependent modular adds (each two 12-word carry
// chains, about 0.09 us), and each phase costs more inside this kernel
// than in a kernel of its own.  The tensor cores, TMA and wgmma do not
// serve it: a lane moves 3 KB once, and its work is 32-bit word products
// with carries in dependent rounds of 2 to 54 independent products, no
// matrix tile.
//
// Design: the SM's integer pipes, shuffles, shared memory and registers.
//  - One block of 224 threads per lane (the most threads a phase of
//    final_exp.cuh takes), so that every phase is one round: each product
//    takes a group of four threads (the split Montgomery product of
//    fp384_split.cuh; 54 at most), each add task one thread.  Two blocks
//    fit on a multiprocessor (at most 128 registers a thread).
//  - The program of final_exp.cuh fixed at compile time as one table of
//    phases in constant memory, run by one loop (run_phases): a product
//    phase forms its operands by its number, then every product phase
//    reaches the same product code, so the kernel holds one copy of it;
//    a phase of adds is one case of a switch.  The squaring is
//    cyclo.cuh's polynomial with its products' operands not reduced
//    (SquareLazy), the Fp12 product fp12_plans.cuh's (the Miller loop's
//    f times the line).
//  - The lane's values stay in shared memory, 241 elements of 48 bytes
//    (11,568 B), for the whole call; __syncthreads() ends each phase.
//  - The one Fp inversion is fp384.cuh's inv4 on the first four threads.
//
// Boundary format: f as (lanes, 2, 3, 2, 32) int32 limbs, in and out,
// canonical and in the Montgomery domain, as the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

#include "final_exp.cuh"

namespace {

constexpr int kThreads = final_exp::kThreads;
constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;

// Two blocks a multiprocessor (at most 128 registers a thread: the card
// gives a block of 7 warps the registers of 8), so that 256 lanes run in
// one wave.
__global__ void __launch_bounds__(kThreads, 2)
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
  final_exp::run_phases(s, final_exp::ProgramPhases{});
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
