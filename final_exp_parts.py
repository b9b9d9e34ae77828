#!/usr/bin/env python3
"""Where the final_exp kernel's time goes, on one NVIDIA GPU (built for
Hopper).

    python3 final_exp_parts.py

Run from the root of a checkout on a machine with one CUDA card.  It
builds probe kernels beside the kernel library (into the git-ignored
harmony_tpu_torch/_build/), each running parts of the program of
harmony_tpu_torch/csrc/final_exp.cuh on one block of threads per lane, as
final_exp.cu does, and times each at 1 lane with CUDA events:

- plans compiled alone into a kernel, each phase's code inlined with its
  own product (the runner of the other tower kernels, phases::Block):
  runs of the squaring as fp12_cyclo_sqr.cu runs it (cyclo.cuh Square;
  also on 128 threads), and as final_exp runs it (SquareLazy, the
  products' operands not reduced); each squaring's product phase alone,
  their Next and Sums phases alone, 18 products whose operands are loads
  alone, and a phase with no task (the barrier);
  Fp12 products (fp12_plans.cuh), the inverse, the inverse's GCD phase
  alone, Frobenius maps;
- tables of phases run by final_exp's own loop (run_phases: one product
  site, each phase's operands by its number): runs of squarings, runs of
  Fp12 products, the inverse, and the whole program;
- the program's steps run by plans instead (run_step: a switch over the
  steps, each plan's code inlined with its own product): a run of
  squarings, a product, and the whole program;
- the squaring alone in a kernel that also holds the program's code
  (never run), and a modular add or sub in a dependent chain (PTX carry
  chains, and fp384.cuh's 64-bit sums);
- the final_exp kernel through its wrapper.

A launch with no work is timed too and taken off the others.  It prints
the card's name and power limit, the probes' registers and stack frames
(ptxas), and last one JSON object of microseconds: each probe's time per
call and per part.  Without CUDA it exits 2 and prints no result.  To
compare two trees, run each tree's script in one call on one card.
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

// 18 products whose operands are loads of the value, into Square's slots.
struct LoadedProducts : phases::Products<18> {
  static FP384_FN int operands(int k, const uint32_t* s, uint32_t x[kWords],
                               uint32_t y[kWords]) {
    ld(s, cyclo::kV + k % 12, x);
    ld(s, cyclo::kV + (k + 5) % 12, y);
    return cyclo::kSq + k;
  }
};

struct NoTask : phases::Linear<0> {
  static FP384_FN void task(int, uint32_t*) {}
};

enum What {
  kIdle, kSquare3, kSquareLazy, kSquare3Products, kSquareLazyProducts,
  kSquareNext, kSquareSums,
  kLoadedProducts, kBarrier, kMulPlan, kInversePlan, kGcdPhase, kFrobPlan,
  kSquareTable, kMulTable, kInverseTable, kProgramTable, kSquareStep,
  kMulStep, kProgramSteps, kSquareBesideProgram
};

constexpr PhaseTable repeat(int op, int n) {
  PhaseTable t{};
  for (int r = 0; r < n; ++r) visit(Append{&t}, op);
  t.e[t.n++] = kEndPhase;
  return t;
}

__constant__ PhaseTable kSquareRun = repeat(kSquare, 315);
__constant__ PhaseTable kMulRun = repeat(kMul, 35);
__constant__ PhaseTable kInverseRun = repeat(kInverse, 1);

template <int kTable>  // 0, 1, 2: the tables above
struct FromTable {
  __device__ int operator()(int i) const {
    return kTable == 0 ? kSquareRun.e[i]
                       : kTable == 1 ? kMulRun.e[i] : kInverseRun.e[i];
  }
};

// n times the part kWhat on each lane's f, loaded into every slot.
template <int kBlock, int kWhat>
__global__ void __launch_bounds__(kBlock)
probe_kernel(const int32_t* f, int32_t* out, int n) {
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
    if (kWhat == kSquare3) run(cyclo::Square{});
    if (kWhat == kSquareLazy) run(cyclo::SquareLazy{});
    if (kWhat == kSquare3Products) {
      using Products =
          phases::Beside<cyclo::SquaresC<0>, cyclo::SquaresC<1>>;
      run(phases::Plan<Products>{});
    }
    if (kWhat == kSquareLazyProducts) run(phases::Plan<cyclo::SquaresLazy>{});
    if (kWhat == kSquareNext) run(phases::Plan<cyclo::Next>{});
    if (kWhat == kSquareSums) run(phases::Plan<cyclo::Sums>{});
    if (kWhat == kLoadedProducts) run(phases::Plan<LoadedProducts>{});
    if (kWhat == kBarrier) run(phases::Plan<NoTask>{});
    if (kWhat == kMulPlan) run(Mul::Plan{});
    if (kWhat == kInversePlan) run(Inverse{});
    if (kWhat == kGcdPhase) run(phases::Plan<Gcd>{});
    if (kWhat == kFrobPlan) run(Frob<1>{});
    if (kWhat == kSquareTable) run_phases(s, FromTable<0>{});
    if (kWhat == kMulTable) run_phases(s, FromTable<1>{});
    if (kWhat == kInverseTable) run_phases(s, FromTable<2>{});
    if (kWhat == kProgramTable) run_phases(s, ProgramPhases{});
    // the steps known only at run time, so that run_step keeps every plan
    if (kWhat == kSquareStep) run_step(run, n < 0 ? 0 : kSquare | 315 << 8);
    if (kWhat == kMulStep) run_step(run, n < 0 ? 0 : kMul);
    if (kWhat == kSquareBesideProgram) {
      if (n < 0) run_phases(s, ProgramPhases{});  // never: n >= 0
      run(cyclo::SquareLazy{});
    }
    if (kWhat == kProgramSteps) {
#pragma unroll 1
      for (int j = 0;; ++j) {
        const int step = step_at(j);
        if ((step & 0xff) == kEnd) break;
        run_step(run, step);
      }
    }
  }
  if (t < fp12::kElems) {
    fp12::ld(s, kAcc + t, w);
    fp384::store_row(w, out + blockIdx.x * kLaneLimbs + t * fp384::kLimbs);
  }
}

// n modular operations in a dependent chain on one warp: kind 0
// phases::add, 1 phases::sub (PTX carry chains), 2 fp384::add (64-bit
// sums, as mont_mul.cu and fp_addsub.cu use).
__global__ void chain_kernel(const int32_t* f, int32_t* out, int n,
                             int kind) {
  uint32_t x[fp384::kWords], y[fp384::kWords];
  fp384::load_row(f, x);
  fp384::load_row(f + fp384::kLimbs, y);
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    if (kind == 0) phases::add(x, y, x);
    if (kind == 1) phases::sub(x, y, x);
    if (kind == 2) fp384::add(x, y, x);
  }
  fp384::store_row(x, out);
}

template <int kBlock, int kWhat>
int launch(const void* f, void* out, int n) {
  probe_kernel<kBlock, kWhat><<<1, kBlock>>>(
      static_cast<const int32_t*>(f), static_cast<int32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Part what on one lane and a block of kThreads (or 128 threads where
// block128 and the part is the three-phase squaring).
extern "C" int harmony_final_exp_probe(int what, int block128, const void* f,
                                       void* out, int n) {
  if (block128) {
    return what == kSquare3 ? launch<128, kSquare3>(f, out, n) : -1;
  }
  switch (what) {
#define PROBE(w) \
  case w:        \
    return launch<kThreads, w>(f, out, n);
    PROBE(kIdle) PROBE(kSquare3) PROBE(kSquareLazy) PROBE(kSquare3Products)
    PROBE(kSquareLazyProducts) PROBE(kSquareNext) PROBE(kSquareSums)
    PROBE(kLoadedProducts)
    PROBE(kBarrier) PROBE(kMulPlan) PROBE(kInversePlan) PROBE(kGcdPhase)
    PROBE(kFrobPlan) PROBE(kSquareTable) PROBE(kMulTable)
    PROBE(kInverseTable) PROBE(kProgramTable) PROBE(kSquareStep)
    PROBE(kMulStep) PROBE(kProgramSteps) PROBE(kSquareBesideProgram)
#undef PROBE
  }
  return -1;
}

extern "C" int harmony_final_exp_chain(int kind, const void* f, void* out,
                                       int n) {
  chain_kernel<<<1, 32>>>(static_cast<const int32_t*>(f),
                          static_cast<int32_t*>(out), n, kind);
  return static_cast<int>(cudaGetLastError());
}
"""

# What, in PROBES, in order: (name, parts a call makes, repeats of the
# part in the probe's loop)
SQUARINGS, PRODUCTS = 315, 35  # what one final exponentiation makes
RUNS = (
    ("idle launch", 0, 0),
    ("squaring, reduced operands (Square), alone", SQUARINGS, SQUARINGS),
    ("squaring, operands not reduced (SquareLazy), alone", SQUARINGS,
     SQUARINGS),
    ("Square's product phase alone", SQUARINGS, SQUARINGS),
    ("SquareLazy's product phase alone", SQUARINGS, SQUARINGS),
    ("the squaring's Next phase alone", SQUARINGS, SQUARINGS),
    ("the squaring's Sums phase alone", SQUARINGS, SQUARINGS),
    ("18 products of loaded operands, one phase", SQUARINGS, SQUARINGS),
    ("a phase with no task", SQUARINGS, SQUARINGS),
    ("product alone", PRODUCTS, PRODUCTS),
    ("inverse alone", 1, 1),
    ("the inverse's GCD phase alone", 1, 1),
    ("Frobenius map alone", PRODUCTS, PRODUCTS),
    ("squaring in the program's loop", SQUARINGS, 1),  # the table repeats
    ("product in the program's loop", PRODUCTS, 1),
    ("inverse in the program's loop", 1, 1),
    ("the program in its loop", 1, 1),
    ("squaring among every step, by plans (run_step)", SQUARINGS, 1),
    ("product among every step, by plans (run_step)", PRODUCTS, PRODUCTS),
    ("the program by plans (run_step)", 1, 1),
    ("squaring alone, the program's code present but not run", SQUARINGS,
     SQUARINGS),
)
CHAINS = ("phases::add", "phases::sub", "fp384::add")  # chain_kernel's kinds
CHAIN_LENGTH = 2000


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
         ctypes.c_int])
    lib.harmony_final_exp_chain.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int])
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

    def us(what, n, block128=0):
        def go():
            rc = lib.harmony_final_exp_probe(what, block128, f.data_ptr(),
                                             out.data_ptr(), n)
            if rc:
                raise RuntimeError(f"probe {what} failed: CUDA error {rc}")
        return 1e3 * CS.cuda_ms(go, 20)

    result = {}
    idle = None
    for what, (name, parts, n) in enumerate(RUNS):
        total = us(what, n)
        if idle is None:
            idle = result[name] = total
            continue
        result[name] = {"us": total, "us_each": (total - idle) / parts}
    total = us(1, SQUARINGS, block128=1)
    result["squaring, reduced operands (Square), alone, 128 threads"] = {
        "us": total, "us_each": (total - idle) / SQUARINGS}
    for name, r in result.items():
        if isinstance(r, dict):
            print(f"{name}: {r['us']:.3f} us, {r['us_each']:.4f} us each "
                  f"after the idle launch", flush=True)
    for kind, name in enumerate(CHAINS):
        def chain(n, kind=kind):
            def go():
                rc = lib.harmony_final_exp_chain(kind, f.data_ptr(),
                                                 out.data_ptr(), n)
                if rc:
                    raise RuntimeError(f"chain {kind}: CUDA error {rc}")
            return 1e3 * CS.cuda_ms(go, 20)
        ns = 1e3 * (chain(CHAIN_LENGTH) - chain(0)) / CHAIN_LENGTH
        result[f"{name}, one of a dependent chain"] = {"ns_each": ns}
        print(f"{name}, one of a dependent chain of {CHAIN_LENGTH} on one "
              f"warp: {ns:.3f} ns", flush=True)
    result["final_exp kernel"] = 1e3 * CS.cuda_ms(lambda: KF.final_exp(f),
                                                  20)
    print(f"final_exp kernel: {result['final_exp kernel']:.3f} us",
          flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
