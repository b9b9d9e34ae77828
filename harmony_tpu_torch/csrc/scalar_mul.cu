// Scalar multiplication in G1 and in the G2 twist, for Hopper (sm_90a):
// one block per lane runs the lane's whole double-and-add over an
// MSB-first bit string in one launch.  Two kernels of one template,
// scalar_mul_g1_kernel (over Fp: derive_pubkeys) and scalar_mul_g2_kernel
// (over Fp2: sign, clear_cofactor_g2).
//
// Replaces no TPU kernel.  It fuses the JAX package's
// harmony_tpu/ops/curve.py scalar_mul (a lax.scan over the bits of dbl,
// add(..., handle_equal=False) and a select by the bit), jnp code around
// the Pallas multiply that XLA fuses.  Run eagerly in PyTorch, each of a
// signature's 255 steps is 10 stacked product calls over Fp2 (4 for the
// doubling, 6 for the addition) and the adds and selects around them,
// each a few tensor ops.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 IMAD/s,
// half the 67 TFLOP/s fp32 FMA rate), per lane of L bits:
//   bytes: read the point (384 B over Fp, 768 B over Fp2) and the bits
//   (4 L B, or once for all lanes), write the result as big as the point;
//   operations: per step the doubling's and the addition's Montgomery
//   products of 576 IMAD, 23 over Fp and 59 over Fp2 (Karatsuba products,
//   complex squares): 255 steps of 59 are 8.7 M IMAD a signature.
// At 1 to 256 lanes both bounds are microseconds.  The cost is one lane's
// chain: L steps of 8 rounds of products and 7 phases of adds, each
// followed by a block barrier.
//
// Design: the SM's integer pipes, shuffles and shared memory, as the
// other tower kernels.
//  - One block per lane, 32 threads over Fp and 64 over Fp2: a round's
//    products (at most 4 and 12) each take a group of four threads (the
//    split product of fp384_split.cuh), so every round of jac.cuh's plans
//    is one pass.  The lane's accumulator, base point and intermediates
//    stay in shared memory (2,304 B over Fp, 5,184 B over Fp2) for all L
//    steps; phases::Block ends each phase with __syncthreads().
//  - Constant time (the bits are secret keys): every step runs the same
//    phases and products whatever its bit; thread 0 writes the bit as a
//    mask of all ones or zeros before the step, and the step's last phase
//    combines the add's result and the doubled accumulator by that mask.
//    No branch depends on a bit or on a value derived from one, no step is
//    skipped (leading zeros double the point at infinity, as the reference
//    does), and nothing is inverted: the output is Jacobian.  Each step
//    reads its bit from device memory one step ahead.
//  - One bit string for all lanes (clear_cofactor_g2's cofactor) is read
//    once, not once per lane: the lanes' stride into it is 0.
//
// Boundary format: points (lanes, 3, 32) over Fp or (lanes, 3, 2, 32)
// over Fp2, Jacobian, rows of 32 little-endian 12-bit limbs in int32,
// canonical and in the Montgomery domain; bits (lanes, L) or (L,) int32,
// MSB first, a step adding where its bit is 1 (other values do not add,
// as curve.py's bit == 1); out as points.

#include <cstdint>

#include <cuda_runtime.h>

#include "jac.cuh"

namespace {

using fp384::kLimbs;
using fp384::kWords;

template <class F>
__device__ __forceinline__ void lane(uint32_t* s,
                                     const int32_t* __restrict__ points,
                                     const int32_t* __restrict__ bits,
                                     int64_t n_bits, int shared,
                                     int32_t* __restrict__ out) {
  using L = jac::Ladder<F>;
  constexpr int kRows = 3 * F::kE;
  const int t = threadIdx.x;
  const int64_t lane = blockIdx.x;
  if (t < kRows) {
    uint32_t w[kWords];
    fp384::load_row(points + (lane * kRows + t) * kLimbs, w);
    fp12::st(s, L::kBase + t, w);
    jac::infinity_element<F>(t, w);
    fp12::st(s, L::kAcc + t, w);
  }
  const int32_t* mine = bits + (shared ? 0 : lane * n_bits);
  int32_t next = n_bits > 0 ? mine[0] : 0;
  __syncthreads();
#pragma unroll 1
  for (int64_t i = 0; i < n_bits; ++i) {
    // the previous step's last phase, which read the mask, has ended
    if (t == 0) s[L::kBit * kWords] = jac::mask(next == 1);
    next = i + 1 < n_bits ? mine[i + 1] : 0;
    jac::step<F>(phases::Block{s});
  }
  if (t < kRows) {
    uint32_t w[kWords];
    fp12::ld(s, L::kAcc + t, w);
    fp384::store_row(w, out + (lane * kRows + t) * kLimbs);
  }
}

__global__ void __launch_bounds__(jac::Ladder<jac::Fp>::kThreads)
scalar_mul_g1_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ bits,
                     int32_t* __restrict__ out, int64_t n_bits, int shared) {
  __shared__ __align__(16) uint32_t s[jac::Ladder<jac::Fp>::kScratch * kWords];
  lane<jac::Fp>(s, points, bits, n_bits, shared, out);
}

__global__ void __launch_bounds__(jac::Ladder<jac::Fp2>::kThreads)
scalar_mul_g2_kernel(const int32_t* __restrict__ points,
                     const int32_t* __restrict__ bits,
                     int32_t* __restrict__ out, int64_t n_bits, int shared) {
  __shared__ __align__(16)
      uint32_t s[jac::Ladder<jac::Fp2>::kScratch * kWords];
  lane<jac::Fp2>(s, points, bits, n_bits, shared, out);
}

template <class F, class Kernel>
int launch(Kernel kernel, const void* points, const void* bits, void* out,
           int64_t lanes, int64_t n_bits, int32_t shared, void* stream) {
  if (lanes <= 0) return 0;
  if (lanes > 0x7fffffff || n_bits < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<static_cast<unsigned int>(lanes), jac::Ladder<F>::kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(points), static_cast<const int32_t*>(bits),
      static_cast<int32_t*>(out), n_bits, shared);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C ABI for ctypes.  points and out are (lanes, 3, 32) for G1 and (lanes,
// 3, 2, 32) for G2; bits is (lanes, n_bits), or (n_bits,) for every lane
// where shared is 1; all int32, contiguous, 16-byte aligned (points,
// out), on the current device; lanes < 2^31.  stream is a cudaStream_t.
// The launch is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_scalar_mul_g1(const void* points, const void* bits,
                                     void* out, int64_t lanes, int64_t n_bits,
                                     int32_t shared, void* stream) {
  return launch<jac::Fp>(scalar_mul_g1_kernel, points, bits, out, lanes,
                         n_bits, shared, stream);
}

extern "C" int harmony_scalar_mul_g2(const void* points, const void* bits,
                                     void* out, int64_t lanes, int64_t n_bits,
                                     int32_t shared, void* stream) {
  return launch<jac::Fp2>(scalar_mul_g2_kernel, points, bits, out, lanes,
                          n_bits, shared, stream);
}
