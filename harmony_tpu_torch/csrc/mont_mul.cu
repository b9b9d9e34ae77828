// Batched Montgomery multiplication over the BLS12-381 base field, for
// Hopper (sm_90a).  One thread computes one product a * b * 2^-384 mod p.
//
// Replaces the TPU kernel harmony_tpu/ops/fp_pallas.py::_mont_mul_kernel
// (wrapper mont_mul_pallas).  Same boundary format: rows of 32
// little-endian 12-bit limbs in int32, canonical (< p) in and out.  The
// TPU kernel laid limbs on sublanes and batch on lanes and ran a 32-step
// CIOS on 12-bit digits, because its vector unit multiplies 32-bit lanes
// and has no wide product.  Here one thread packs its two rows into 12
// words of 32 bits in registers, runs CIOS over 12 words with 64-bit
// products (fp384.cuh), and unpacks: R = 2^384 either way, and the
// canonical result is unique, so the output is the JAX package's, limb
// for limb.
//
// What bounds it on an H100 SXM (published peaks: 3.35 TB/s HBM3; int32
// multiply-add at half the fp32 FMA rate of 67 TFLOP/s, i.e. ~16.7e12
// IMAD/s):
//   bytes: 384 B per product (read a and b, 128 B each; write 128 B);
//   operations: 2 x 12 x 12 = 288 32x32->64-bit products, ~576 IMAD.
// The 12-bit schedule this replaces issued 2 x 32 x 32 = 2048 IMAD and
// held four 32-entry arrays per thread; this one holds three of 12
// words.  At large batch the bytes bound (0.115 ns per product) is the
// least time; at the path's batch sizes (one Fp12 product at 64 lanes is
// 3,456 products) a launch is a few microseconds of work.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp384.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  uint32_t aw[fp384::kWords], bw[fp384::kWords], cw[fp384::kWords];
  fp384::load_row(a + row * fp384::kLimbs, aw);
  fp384::load_row(b + row * fp384::kLimbs, bw);
  fp384::mont_mul(aw, bw, cw);
  fp384::store_row(cw, out + row * fp384::kLimbs);
}

}  // namespace

// C ABI for ctypes.  a, b and out are (rows, 32) int32, contiguous and
// 16-byte aligned, on the current device; stream is a cudaStream_t.  The
// launch is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_mont_mul(const void* a, const void* b, void* out,
                                int64_t rows, void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  mont_mul_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}
