// The Miller loop of the optimal ate pairing over BLS12-381, for Hopper
// (sm_90a).  One block runs one lane's whole loop, f_{|x|,Q}(P)
// conjugated, in one launch.
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/pairing.py
// miller_loop is a scan over |x|'s segments with a fori_loop of doubling
// steps inside, jnp code around the Pallas multiply that XLA runs as one
// program.  Run eagerly in PyTorch, each of its 63 doublings and 5
// additions was some 50 fp_addsub and 8 mont_mul launches, two fp12_mul
// launches and about 150 other tensor ops.  Here the loop is one launch,
// and the lane's state never leaves the SM.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate):
//   bytes: 2,304 B per lane (read P, 256 B, and Q, 512 B; write f,
//   1,536 B);
//   operations: the plain loop's products, the fewest of its parts: per
//   doubling 36 for f^2 (the complex method), 54 for f times the line and
//   34 for the step, per addition 54 + 44: 8,302 Montgomery products of
//   576 IMAD, 4,781,952 IMAD per lane (the adds and subs are a few per
//   cent more; a sparse line product would need fewer).  This kernel
//   makes the same 8,302.
// At 1 to 128 lanes the card could do that in well under 0.1 ms.  The cost
// is one lane's dependent chain: 68 steps of 13 to 14 phases, each a round
// of products or of adds, and a block barrier after each.  The tensor
// cores, TMA and wgmma do not serve it: a lane moves 2.3 KB once, and its
// work is 32-bit word products with carries, in rounds of 2 to 60
// independent Montgomery products, at 1 to 128 lanes: no matrix tile.
//
// Design: the SM's integer pipes, shuffles, shared memory and registers.
//  - One block of 256 threads per lane, so that 128 lanes take 128 of the
//    132 SMs, and every phase of the plans in miller.cuh is one round:
//    each product takes a group of four threads (60 products at most),
//    each add task one thread.
//  - Work that does not depend on each other shares a round: f^2 (the
//    complex method, 36 products) runs beside the doubling step's
//    phases, its products in one round with the step's first 11; f times
//    the chord shares its round with the addition's last 6 products.
//  - Plans fixed at compile time: each phase is a type (phases.cuh), so
//    its scratch indices are constants and no register array is indexed
//    at run time; one doubling body and one addition body, looped over
//    the schedule at run time.
//  - One product site per phase: each task forms its two operands (loads
//    and a few adds), then each task's group of four threads runs the
//    Montgomery product split over them (fp384_split.cuh): the words of
//    the accumulator spread over the group, m and one word per iteration
//    exchanged by __shfl_sync.
//  - The lane's f, twist point, line and intermediates stay in shared
//    memory, 356 elements of 48 bytes (17,088 B) for the whole loop;
//    __syncthreads() ends each phase.
//
// Boundary format: P as (lanes, 2, 32), Q as (lanes, 2, 2, 32), f as
// (lanes, 2, 3, 2, 32): rows of 32 little-endian 12-bit limbs in int32,
// canonical and in the Montgomery domain, as the plain version's.

#include <cstdint>

#include <cuda_runtime.h>

#include "miller.cuh"

namespace {

constexpr int kThreads = miller::kThreads;
constexpr int64_t kPLimbs = 2 * fp384::kLimbs;
constexpr int64_t kQLimbs = 4 * fp384::kLimbs;
constexpr int64_t kFLimbs = fp12::kElems * fp384::kLimbs;

__global__ void __launch_bounds__(kThreads)
miller_loop_kernel(const int32_t* __restrict__ p,
                   const int32_t* __restrict__ q, int32_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t s[miller::kScratch * fp384::kWords];
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  uint32_t w[fp384::kWords];
  if (t < 6) {  // xp, yp; xq (2), yq (2)
    fp384::load_row(t < 2 ? p + lane * kPLimbs + t * fp384::kLimbs
                          : q + lane * kQLimbs + (t - 2) * fp384::kLimbs,
                    w);
    fp12::st(s, t < 2 ? miller::kXp + t : miller::kXq + t - 2, w);
  }
  __syncthreads();
  miller::loop(phases::Block{s});
  if (t < fp12::kElems) {
    fp12::ld(s, miller::kF + t, w);
    fp384::store_row(w, out + lane * kFLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  p is (lanes, 2, 32), q (lanes, 2, 2, 32) and out
// (lanes, 2, 3, 2, 32), int32, contiguous and 16-byte aligned, on the
// current device; stream is a cudaStream_t.  One block per lane, so
// lanes < 2^31.  The launch is asynchronous; the return value is
// cudaGetLastError().
extern "C" int harmony_miller_loop(const void* p, const void* q, void* out,
                                   int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  miller_loop_kernel<<<static_cast<unsigned int>(lanes), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p), static_cast<const int32_t*>(q),
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
