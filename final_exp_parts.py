#!/usr/bin/env python3
"""Where the final_exp kernel's time goes, on one NVIDIA GPU (built for
Hopper).

    python3 final_exp_parts.py

Run from the root of a checkout on a machine with one CUDA card.  It
builds probe kernels beside the kernel library (into the git-ignored
harmony_tpu_torch/_build/), each running one part of the program of
harmony_tpu_torch/csrc/final_exp.cuh on one block of 224 threads per lane,
as final_exp.cu does, and times each at 1 lane with CUDA events:

- each plan compiled alone into its kernel: runs of cyclotomic squarings
  (cyclo.cuh Square; also on a block of 128 threads, as fp12_cyclo_sqr.cu
  runs it), Fp12 products (fp12_plans.cuh), the inverse, Frobenius maps;
- the same steps chosen at run time: among every step of the program
  (run_step, as final_exp.cu compiles them), among the squaring and the
  product alone, and among those two as functions of their own
  (__noinline__);
- the whole program (run_program), and the final_exp kernel through its
  wrapper.

A launch with no work is timed too and taken off the others.  It prints
the card's name and power limit, the probes' registers and stack frames
(ptxas), and last one JSON object of microseconds: each probe's time per
call and per part.  Without CUDA it exits 2 and prints no result.
"""

import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

PROBES = r"""
#include <cstdint>

#include <cuda_runtime.h>

#include "final_exp.cuh"

namespace {

using namespace final_exp;

enum What {
  kIdle, kSquareAlone, kMulAlone, kInverseAlone, kFrobAlone, kAnyStep,
  kSquareOrMul, kSquareOrMulCalls, kWholeProgram
};

__device__ __noinline__ void square_run(uint32_t* s, int n) {
  const phases::Block run{s};
#pragma unroll 1
  for (int r = 0; r < n; ++r) run(cyclo::Square{});
}

__device__ __noinline__ void mul_run(uint32_t* s) {
  phases::Block{s}(Mul::Plan{});
}

// n times the part kWhat (with step, for the parts that choose at run
// time) on each lane's f, loaded into every slot.
template <int kBlock, int kWhat>
__global__ void __launch_bounds__(kBlock)
probe_kernel(const int32_t* f, int32_t* out, int n, int step) {
  __shared__ __align__(16) uint32_t s[kScratch * fp384::kWords];
  constexpr int64_t kLaneLimbs = fp12::kElems * fp384::kLimbs;
  const int t = threadIdx.x;
  uint32_t w[fp384::kWords];
  if (t < fp12::kElems) {
    fp384::load_row(f + blockIdx.x * kLaneLimbs + t * fp384::kLimbs, w);
    fp12::st(s, kT + t, w);
    fp12::st(s, kAcc + t, w);
    fp12::st(s, kBase + t, w);
  }
  __syncthreads();
  const phases::Block run{s};
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (kWhat == kSquareAlone) run(cyclo::Square{});
    if (kWhat == kMulAlone) run(Mul::Plan{});
    if (kWhat == kInverseAlone) run(Inverse{});
    if (kWhat == kFrobAlone) run(Frob<1>{});
    if (kWhat == kAnyStep) run_step(run, step);
    if (kWhat == kSquareOrMul || kWhat == kSquareOrMulCalls) {
      if ((step & 0xff) == kSquare) {
        if (kWhat == kSquareOrMul) {
#pragma unroll 1
          for (int r = 0; r < step >> 8; ++r) run(cyclo::Square{});
        } else {
          square_run(s, step >> 8);
        }
      } else if (kWhat == kSquareOrMul) {
        run(Mul::Plan{});
      } else {
        mul_run(s);
      }
    }
    if (kWhat == kWholeProgram) run_program(run);
  }
  if (t < fp12::kElems) {
    fp12::ld(s, kAcc + t, w);
    fp384::store_row(w, out + blockIdx.x * kLaneLimbs + t * fp384::kLimbs);
  }
}

template <int kBlock, int kWhat>
int launch(const void* f, void* out, int64_t lanes, int n, int step) {
  probe_kernel<kBlock, kWhat><<<static_cast<unsigned int>(lanes), kBlock>>>(
      static_cast<const int32_t*>(f), static_cast<int32_t*>(out), n, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Part what on a block of kThreads (or 128 threads where block128 and the
// part is the squaring alone).
extern "C" int harmony_final_exp_probe(int what, int block128, const void* f,
                                       void* out, int64_t lanes, int n,
                                       int step) {
  if (block128) {
    return what == kSquareAlone ? launch<128, kSquareAlone>(f, out, lanes, n, step)
                                : -1;
  }
  switch (what) {
    case kIdle: return launch<kThreads, kIdle>(f, out, lanes, n, step);
    case kSquareAlone: return launch<kThreads, kSquareAlone>(f, out, lanes, n, step);
    case kMulAlone: return launch<kThreads, kMulAlone>(f, out, lanes, n, step);
    case kInverseAlone: return launch<kThreads, kInverseAlone>(f, out, lanes, n, step);
    case kFrobAlone: return launch<kThreads, kFrobAlone>(f, out, lanes, n, step);
    case kAnyStep: return launch<kThreads, kAnyStep>(f, out, lanes, n, step);
    case kSquareOrMul: return launch<kThreads, kSquareOrMul>(f, out, lanes, n, step);
    case kSquareOrMulCalls:
      return launch<kThreads, kSquareOrMulCalls>(f, out, lanes, n, step);
    case kWholeProgram:
      return launch<kThreads, kWholeProgram>(f, out, lanes, n, step);
  }
  return -1;
}
"""

# What, in PROBES, and the steps of csrc/final_exp.cuh's Op
IDLE, SQUARE_ALONE, MUL_ALONE, INVERSE_ALONE, FROB_ALONE, ANY_STEP, \
    SQUARE_OR_MUL, SQUARE_OR_MUL_CALLS, PROGRAM = range(9)
STEP_INVERSE, STEP_SQUARE, STEP_MUL = 1, 2, 3
SQUARINGS, PRODUCTS = 315, 35  # what one final exponentiation makes


def build(_build):
    """The probes' library, built with the kernels' flags and header."""
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        header = Path(tmp) / "harmony_params.h"
        header.write_text(_build.params_header())
        src = Path(tmp) / "final_exp_parts.cu"
        src.write_text(PROBES)
        so = out_dir / "final_exp_parts.so"
        done = subprocess.run(
            [_build._nvcc(), *_build._FLAGS, "-Xptxas", "-v", "-shared",
             "-include", str(header), "-I", str(_build.CSRC), "-o", str(so),
             str(src)], capture_output=True, text=True, timeout=600)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    for line in (done.stdout + done.stderr).splitlines():
        if any(k in line for k in ("Compiling entry", "stack frame", "Used")):
            print(line.strip(), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.harmony_final_exp_probe.argtypes = (
        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int, ctypes.c_int])
    return lib


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("final_exp_parts: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import chip_smoke as CS
        from harmony_tpu_torch.kernels import _build
        from harmony_tpu_torch.kernels import final_exp as KF
    except ImportError as e:
        print(f"final_exp_parts: run from a checkout of the repo ({e})",
              file=sys.stderr)
        return 2

    print(CS.card_line(), flush=True)
    lib = build(_build)
    f = CS.fp12_limbs(np.random.default_rng(1673), 1)
    out = torch.empty_like(f)

    def us(what, n, step=0, block128=0):
        def go():
            rc = lib.harmony_final_exp_probe(what, block128, f.data_ptr(),
                                             out.data_ptr(), 1, n, step)
            if rc:
                raise RuntimeError(f"probe {what} failed: CUDA error {rc}")
        return 1e3 * CS.cuda_ms(go, 20)

    idle = us(IDLE, 0)
    square_run = STEP_SQUARE | SQUARINGS << 8
    runs = {  # name: (us per call, parts per call)
        "squaring alone": (us(SQUARE_ALONE, SQUARINGS), SQUARINGS),
        "squaring alone, 128 threads": (
            us(SQUARE_ALONE, SQUARINGS, block128=1), SQUARINGS),
        "product alone": (us(MUL_ALONE, PRODUCTS), PRODUCTS),
        "inverse alone": (us(INVERSE_ALONE, 1), 1),
        "Frobenius map alone": (us(FROB_ALONE, PRODUCTS), PRODUCTS),
        "squaring among every step": (us(ANY_STEP, 1, square_run),
                                      SQUARINGS),
        "product among every step": (us(ANY_STEP, PRODUCTS, STEP_MUL),
                                     PRODUCTS),
        "inverse among every step": (us(ANY_STEP, 1, STEP_INVERSE), 1),
        "squaring beside the product": (us(SQUARE_OR_MUL, 1, square_run),
                                        SQUARINGS),
        "product beside the squaring": (us(SQUARE_OR_MUL, PRODUCTS,
                                           STEP_MUL), PRODUCTS),
        "squaring beside the product, as calls": (
            us(SQUARE_OR_MUL_CALLS, 1, square_run), SQUARINGS),
        "product beside the squaring, as calls": (
            us(SQUARE_OR_MUL_CALLS, PRODUCTS, STEP_MUL), PRODUCTS),
        "the program": (us(PROGRAM, 1), 1),
    }
    result = {"idle launch": idle}
    for name, (total, parts) in runs.items():
        result[name] = {"us": total, "us_each": (total - idle) / parts}
        print(f"{name}: {total:.3f} us, {(total - idle) / parts:.4f} us "
              f"each of {parts} after the idle launch", flush=True)
    result["final_exp kernel"] = 1e3 * CS.cuda_ms(lambda: KF.final_exp(f),
                                                  20)
    print(f"final_exp kernel: {result['final_exp kernel']:.3f} us",
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
