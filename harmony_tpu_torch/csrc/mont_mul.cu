// Batched Montgomery multiplication over the BLS12-381 base field, for
// Hopper (sm_90a).  One thread computes one product a * b * 2^-384 mod p.
//
// Replaces the TPU kernel harmony_tpu/ops/fp_pallas.py::_mont_mul_kernel
// (wrapper mont_mul_pallas).  Same boundary format: rows of 32
// little-endian 12-bit limbs in int32, canonical (< p) in and out.  The
// TPU kernel laid limbs on sublanes and batch on lanes and resolved
// carries by Kogge-Stone lookahead, because its vector unit has no
// scalar loop; here one thread holds a whole row in registers, so it runs
// the same 32-step CIOS, ripples its carries and its final borrow, and
// gives the same canonical limbs.
//
// What bounds it on an H100 SXM (published peaks: 3.35 TB/s HBM3; int32
// multiply-add at half the fp32 FMA rate of 67 TFLOP/s, i.e. ~16.7e12
// IMAD/s):
//   bytes: 384 B per product (read a and b, 128 B each; write 128 B);
//   operations: a 384-bit Montgomery product needs ~288 32x32->64-bit
//     products (12 x 12 words, twice), ~576 IMAD; this 12-bit-digit
//     version issues 2 x 32 x 32 = 2048 IMAD instead.
// At large batch the bytes bound (0.115 ns per product) is the least
// time; the operations of the 12-bit schedule sit within a small factor
// of it.  At the path's batch sizes (one Fp12 product at 64 lanes is
// 3,456 products, 1.3 MB) a launch is a few microseconds of work, so
// launch latency is the likely bound: later designs fuse launches
// (CUDA graphs) and move to 32-bit words.
//
// The modulus p and -p^-1 mod 2^12 come in as macros from a header that
// the build generates from ops/_constants.py and pre-includes
// (kernels/mont_mul.py).

#include <cstdint>

#include <cuda_runtime.h>

#if !defined(HARMONY_P_LIMBS) || !defined(HARMONY_P_INV_NEG)
#error "build through harmony_tpu_torch/kernels/mont_mul.py, which defines the modulus"
#endif

namespace {

constexpr int kLimbs = 32;
constexpr int kBits = 12;
constexpr uint32_t kMask = (1u << kBits) - 1u;
constexpr uint32_t kPInvNeg = HARMONY_P_INV_NEG;
constexpr int kThreads = 128;

__constant__ uint32_t kP[kLimbs] = {HARMONY_P_LIMBS};

__global__ void __launch_bounds__(kThreads)
mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;

  // 16-byte loads: each row is 128 B and 16-byte aligned (the wrapper
  // checks the base pointers).
  const int4* a4 = reinterpret_cast<const int4*>(a + row * kLimbs);
  const int4* b4 = reinterpret_cast<const int4*>(b + row * kLimbs);
  uint32_t av[kLimbs], bv[kLimbs];
#pragma unroll
  for (int k = 0; k < kLimbs / 4; ++k) {
    const int4 x = __ldg(a4 + k);
    const int4 y = __ldg(b4 + k);
    av[4 * k] = x.x; av[4 * k + 1] = x.y; av[4 * k + 2] = x.z; av[4 * k + 3] = x.w;
    bv[4 * k] = y.x; bv[4 * k + 1] = y.y; bv[4 * k + 2] = y.z; bv[4 * k + 3] = y.w;
  }

  // CIOS with a lazy accumulator: each step adds a_i * b + m_i * p and
  // shifts down one limb.  Unsigned throughout: every limb stays below
  // 2^31 (the same bound as the int32 scan), and no shift sees a sign.
  uint32_t t[kLimbs];
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const uint32_t ai = av[i];
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] += ai * bv[j];
    const uint32_t m = ((t[0] & kMask) * kPInvNeg) & kMask;
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) t[j] += m * kP[j];
    const uint32_t carry0 = t[0] >> kBits;  // low limb is 0 mod 2^12
#pragma unroll
    for (int j = 0; j < kLimbs - 1; ++j) t[j] = t[j + 1];
    t[0] += carry0;
    t[kLimbs - 1] = 0;
  }

  // Exact digits by a ripple carry.  T < 2p < 2^384, so no carry leaves
  // the top limb.
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint32_t v = t[j] + carry;
    t[j] = v & kMask;
    carry = v >> kBits;
  }

  // d = T - p with an explicit borrow: s = t + 2^12 - p - borrow lies in
  // [0, 2^13), and its bit 12 is 1 exactly when no borrow goes out.
  uint32_t d[kLimbs];
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    const uint32_t s = t[j] + (1u << kBits) - kP[j] - borrow;
    d[j] = s & kMask;
    borrow = 1u - (s >> kBits);
  }
  // borrow out of the top limb: T < p, keep T; else T - p.
  int4* o4 = reinterpret_cast<int4*>(out + row * kLimbs);
#pragma unroll
  for (int k = 0; k < kLimbs / 4; ++k) {
    int4 v;
    v.x = static_cast<int32_t>(borrow ? t[4 * k] : d[4 * k]);
    v.y = static_cast<int32_t>(borrow ? t[4 * k + 1] : d[4 * k + 1]);
    v.z = static_cast<int32_t>(borrow ? t[4 * k + 2] : d[4 * k + 2]);
    v.w = static_cast<int32_t>(borrow ? t[4 * k + 3] : d[4 * k + 3]);
    o4[k] = v;
  }
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
