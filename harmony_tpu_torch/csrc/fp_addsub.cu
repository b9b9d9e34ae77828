// Batched modular addition, subtraction and negation over the BLS12-381
// base field, for Hopper (sm_90a).  One thread takes one row.
//
// Replaces no TPU kernel.  In the JAX package add, sub and neg
// (harmony_tpu/ops/fp.py) are jnp code that XLA fuses into the jitted
// programs around the Pallas multiply; run eagerly in PyTorch, each is a
// chain of small kernels (carry lookahead, borrow scan, conditional
// subtraction: ~20 tensor ops a call), and they made 93% of the tensor
// ops of a quorum check.  This kernel does one of them in one launch.
//
// Same boundary format as mont_mul.cu: rows of 32 little-endian 12-bit
// limbs in int32, canonical (< p) in and out, neg(0) = 0.  The thread
// packs its rows into 12 words of 32 bits, ripples carries and borrows
// over them, does one conditional subtraction (add) or addition (sub) of
// p, and unpacks (fp384.cuh); the canonical result is unique, so the
// output is the plain version's, limb for limb.
//
// What bounds it on an H100 SXM: bytes.  add and sub read 256 B and write
// 128 B per row, neg reads and writes 128 B: 0.115 ns (add, sub) and
// 0.076 ns (neg) per row at 3.35 TB/s, against a few dozen word
// operations.  At the path's sizes (768 to 8,192 rows) a launch is far
// below a microsecond of that work, so the launch is the cost.

#include <cstdint>

#include <cuda_runtime.h>

#include "fp384.cuh"

namespace {

constexpr int kThreads = 128;

enum class Op { kAdd, kSub, kNeg };

template <Op op>
__global__ void __launch_bounds__(kThreads)
fp_addsub_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                 int32_t* __restrict__ out, int64_t rows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= rows) return;
  uint32_t aw[fp384::kWords], bw[fp384::kWords], cw[fp384::kWords];
  fp384::load_row(a + row * fp384::kLimbs, aw);
  if constexpr (op == Op::kNeg) {
    fp384::neg(aw, cw);
  } else {
    fp384::load_row(b + row * fp384::kLimbs, bw);
    if constexpr (op == Op::kAdd) {
      fp384::add(aw, bw, cw);
    } else {
      fp384::sub(aw, bw, cw);
    }
  }
  fp384::store_row(cw, out + row * fp384::kLimbs);
}

template <Op op>
int launch(const void* a, const void* b, void* out, int64_t rows,
           void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  fp_addsub_kernel<op><<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C ABI for ctypes.  a, b and out are (rows, 32) int32, contiguous and
// 16-byte aligned, on the current device; stream is a cudaStream_t.  Each
// launch is asynchronous; the return value is cudaGetLastError().
extern "C" int harmony_fp_add(const void* a, const void* b, void* out,
                              int64_t rows, void* stream) {
  return launch<Op::kAdd>(a, b, out, rows, stream);
}

extern "C" int harmony_fp_sub(const void* a, const void* b, void* out,
                              int64_t rows, void* stream) {
  return launch<Op::kSub>(a, b, out, rows, stream);
}

extern "C" int harmony_fp_neg(const void* a, void* out, int64_t rows,
                              void* stream) {
  return launch<Op::kNeg>(a, nullptr, out, rows, stream);
}
