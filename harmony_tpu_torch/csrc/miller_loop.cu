// The Miller loop of the optimal ate pairing over BLS12-381, for Hopper
// (sm_90a).  One warp runs one lane's whole loop, f_{|x|,Q}(P) conjugated,
// in one launch.
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/pairing.py
// miller_loop is a scan over |x|'s segments with a fori_loop of doubling
// steps inside, jnp code around the Pallas multiply that XLA runs as one
// program.  Run eagerly in PyTorch, each of its 63 doublings and 5
// additions was some 50 fp_addsub and 8 mont_mul launches, two fp12_mul
// launches and about 150 other tensor ops: 91% of a quorum check's
// fp_addsub launches and 80% of its other ops.  Here the loop is one
// launch, and the lane's state never leaves the SM.
//
// Design, as the fused tower kernels (fp12_mul.cu): the path runs the loop
// on 2 to 128 lanes, so a warp takes a lane, and the threads share the
// independent Fp tasks of each phase of the plan in miller.cuh: the
// doubling and addition steps, and fp12.cuh's product for f^2 (on (f, f))
// and f times the line (as a dense Fp12).  The lane's f, twist point,
// line and intermediates stay in shared memory, 176 elements of 48 bytes
// (8,448 B), for the 262 operations and 1,342 phases of the loop, with
// __syncwarp() between phases.  Four lanes per block: 33 KB of static
// shared memory.
//
// Boundary format: P as (lanes, 2, 32), Q as (lanes, 2, 2, 32), f as
// (lanes, 2, 3, 2, 32): rows of 32 little-endian 12-bit limbs in int32,
// canonical and in the Montgomery domain, as the plain version's.
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
//   makes 9,436, as it squares f by the 54-product plan.
// At 2 to 128 lanes the card could do that in well under 0.1 ms; the cost
// is one warp's dependent chain: 539 rounds of products on 32 threads
// (8 per doubling, 7 per addition) and the phases of adds between them.

#include <cstdint>

#include <cuda_runtime.h>

#include "miller.cuh"

namespace {

constexpr int kLanesPerBlock = 4;
constexpr int kThreads = 32 * kLanesPerBlock;
constexpr int64_t kPLimbs = 2 * fp384::kLimbs;
constexpr int64_t kQLimbs = 4 * fp384::kLimbs;
constexpr int64_t kFLimbs = fp12::kElems * fp384::kLimbs;

// Every phase of operation `op` on one lane, the tasks shared by the warp.
__device__ __forceinline__ void run(int op, int t, uint32_t* s) {
  for (int phase = 0; phase < miller::op_phases(op); ++phase) {
    for (int k = t; k < miller::op_tasks(op, phase); k += 32) {
      miller::op_task(op, phase, k, s);
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads)
miller_loop_kernel(const int32_t* __restrict__ p,
                   const int32_t* __restrict__ q, int32_t* __restrict__ out,
                   int64_t lanes) {
  __shared__ __align__(16)
      uint32_t scratch[kLanesPerBlock][miller::kScratch * fp384::kWords];
  const int t = threadIdx.x % 32;
  const int64_t lane =
      static_cast<int64_t>(blockIdx.x) * kLanesPerBlock + threadIdx.x / 32;
  if (lane >= lanes) return;  // the whole warp
  uint32_t* s = scratch[threadIdx.x / 32];
  uint32_t w[fp384::kWords];
  if (t < 6) {  // xp, yp; xq (2), yq (2)
    fp384::load_row(t < 2 ? p + lane * kPLimbs + t * fp384::kLimbs
                          : q + lane * kQLimbs + (t - 2) * fp384::kLimbs,
                    w);
    fp12::st(s, t < 2 ? miller::kXp + t : miller::kXq + t - 2, w);
  }
  __syncwarp();
  run(miller::kInit, t, s);
  const int steps = miller::steps();
  for (int i = 0; i < steps; ++i) run(miller::step_op(i), t, s);
  run(miller::kConj, t, s);
  if (t < fp12::kElems) {
    fp12::ld(s, miller::kF + t, w);
    fp384::store_row(w, out + lane * kFLimbs + t * fp384::kLimbs);
  }
}

}  // namespace

// C ABI for ctypes.  p is (lanes, 2, 32), q (lanes, 2, 2, 32) and out
// (lanes, 2, 3, 2, 32), int32, contiguous and 16-byte aligned, on the
// current device; stream is a cudaStream_t.  The launch is asynchronous;
// the return value is cudaGetLastError().
extern "C" int harmony_miller_loop(const void* p, const void* q, void* out,
                                   int64_t lanes, void* stream) {
  if (lanes <= 0) return 0;
  const int64_t blocks = (lanes + kLanesPerBlock - 1) / kLanesPerBlock;
  miller_loop_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p), static_cast<const int32_t*>(q),
      static_cast<int32_t*>(out), lanes);
  return static_cast<int>(cudaGetLastError());
}
