// Loads and stores of the scratch elements that the plans of phases.cuh
// share: one Fp element of 12 words of 32 bits (fp384.cuh) each, 48 bytes
// apart.
//
// The tower is the port's (ops/towers.py) and the JAX package's:
//   Fp2 = Fp[u]/(u^2 + 1), Fp6 = Fp2[v]/(v^3 - xi) with xi = u + 1,
//   Fp12 = Fp6[w]/(w^2 - v).
// An Fp12 value is 12 Fp elements, element 6 i12 + 2 i6 + i2 being the
// coefficient of w^i12 v^i6 u^i2: the order of the (..., 2, 3, 2, 32)
// limb tensors.

#pragma once

#include <cstdint>

#include "fp384.cuh"

namespace fp12 {

using fp384::kWords;

constexpr int kElems = 12;  // Fp elements per Fp12 value

// Element i of the scratch area s into registers, and back.  On the card
// s is 16-byte aligned shared memory, and elements 48 bytes apart are read
// 16 bytes a thread without bank conflicts.
FP384_FN void ld(const uint32_t* s, int i, uint32_t w[kWords]) {
#if defined(__CUDA_ARCH__)
  const uint4* p = reinterpret_cast<const uint4*>(s + kWords * i);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 x = p[k];
    w[4 * k] = x.x; w[4 * k + 1] = x.y; w[4 * k + 2] = x.z; w[4 * k + 3] = x.w;
  }
#else
  for (int j = 0; j < kWords; ++j) w[j] = s[kWords * i + j];
#endif
}

FP384_FN void st(uint32_t* s, int i, const uint32_t w[kWords]) {
#if defined(__CUDA_ARCH__)
  uint4* p = reinterpret_cast<uint4*>(s + kWords * i);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    p[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  }
#else
  for (int j = 0; j < kWords; ++j) s[kWords * i + j] = w[j];
#endif
}

}  // namespace fp12
