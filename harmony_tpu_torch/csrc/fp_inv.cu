// Batched inversion over the BLS12-381 base field, for Hopper (sm_90a).
// Four threads compute one a^-1 in the Montgomery domain by batched
// binary GCD steps (fp384.cuh inv4, with inv(0) = 0), in one launch.
//
// Replaces no TPU kernel.  The JAX package's harmony_tpu/ops/fp.py inv is
// pow_fixed, a scan over the bits of p - 2 around the Pallas multiply,
// which XLA runs inside its jitted programs.  Run eagerly in PyTorch it
// was 610 one-row mont_mul launches in a row.  A quorum check's
// inversions (the Fp12 inverse of the final exponentiation, the affine
// form of its aggregate key) run inside final_exp.cu and g1_masked_sum.cu
// with the same device function.
//
// Design.  One row is a dependent chain of about 19 batches, each 30
// binary GCD steps on 62-bit approximations and four linear combinations
// of 13-limb values; a group of four threads takes a row, each thread
// holding two of the four values and forming one combination a batch
// (fp384.cuh).  It is variable-time, which suits the public values the
// verify path inverts.  Rows of a warp take different branches and batch
// counts, so many rows cost more per row than one.
//
// Same boundary format as the other Fp kernels: rows of 32 little-endian
// 12-bit limbs in int32, canonical (< p) in and out.
//
// What bounds it on an H100 SXM (3.35 TB/s HBM3; ~16.75e12 int32 ops/s,
// half the 67 TFLOP/s fp32 FMA rate):
//   bytes: 256 B per row (read 128 B, write 128 B);
//   operations: per batch about 1,300 word operations (the steps on the
//   approximations and the combinations), and one Montgomery product of
//   576 IMAD at the end.
// At one row both bounds are nanoseconds; the cost is one group's chain.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp384.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = kThreads / 4;

__global__ void __launch_bounds__(kThreads)
fp_inv_kernel(const int32_t* __restrict__ a, int32_t* __restrict__ out,
              int64_t rows) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 4;
  if (row >= rows) return;  // the whole group
  const int r = threadIdx.x % 4;
  const unsigned mask = 0xfu << ((threadIdx.x & 31) & ~3);
  uint32_t aw[fp384::kWords], cw[fp384::kWords];
  fp384::load_row(a + row * fp384::kLimbs, aw);
  fp384::inv4(r, mask, aw, cw);
  if (r == 0) fp384::store_row(cw, out + row * fp384::kLimbs);
}

}  // namespace

// C ABI for ctypes.  a and out are (rows, 32) int32, contiguous and
// 16-byte aligned, on the current device; stream is a cudaStream_t.  The
// launch is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_fp_inv(const void* a, void* out, int64_t rows,
                              void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  fp_inv_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
