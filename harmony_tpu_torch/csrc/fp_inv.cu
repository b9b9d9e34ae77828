// Batched inversion over the BLS12-381 base field, for Hopper (sm_90a).
// One thread computes one a^-1 in the Montgomery domain by a binary
// extended GCD (fp384.cuh inv, with inv(0) = 0), in one launch.
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/fp.py inv is
// pow_fixed, a scan over the bits of p - 2 around the Pallas multiply,
// which XLA runs inside its jitted programs.  Run eagerly in PyTorch it
// was 610 one-row mont_mul launches in a row.  A quorum check inverts
// once here (the Fp12 inverse of the final exponentiation); the affine
// form of its aggregate key inverts inside g1_masked_sum.cu with the
// same device function.
//
// Design.  The path inverts one to 64 rows, each a dependent chain, so a
// thread takes a row and keeps it in registers.  The GCD's chain is about
// 270 steps of 12-word subtractions and shifts (PTX carry chains), not
// Fermat's 608 Montgomery products; it is variable-time, which suits the
// public values the verify path inverts.  Rows of a warp take different
// branches, so many rows cost more per row than one.
//
// Same boundary format as the other Fp kernels: rows of 32 little-endian
// 12-bit limbs in int32, canonical (< p) in and out.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 ops/s,
// half the 67 TFLOP/s fp32 FMA rate):
//   bytes: 256 B per row (read 128 B, write 128 B);
//   operations: per step of the GCD about 100 word operations (the
//   subtractions, the shift and the division of the coefficient by
//   2^k), and one Montgomery product of 576 IMAD at the end.
// At one row both bounds are nanoseconds; the cost is one thread's chain.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp384.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
fp_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
              int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  uint32_t aw[fp384::kWords], cw[fp384::kWords];
  fp384::load_row(a + row * fp384::kLimbs, aw);
  fp384::inv(aw, cw);
  fp384::store_row(cw, out + row * fp384::kLimbs);
}

}  // namespace

// C ABI for ctypes.  a and out are (rows, 32) int32, contiguous and
// 16-byte aligned, on the current device; stream is a cudaStream_t.  The
// launch is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_fp_inv(const void* a, void* out, int64_t rows,
                              void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  fp_inv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
