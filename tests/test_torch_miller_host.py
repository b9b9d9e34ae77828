"""The Miller-loop and Fermat-inverse kernels' arithmetic and phase plans,
on the CPU.

``harmony_tpu_torch/csrc/miller.cuh`` holds the doubling and addition
steps and the whole loop that ``miller_loop.cu`` runs on the card, as
phases of independent tasks; ``csrc/fp384.cuh`` holds the Fermat chain
that ``fp_inv.cu`` runs.  Outside nvcc both are plain C++, so here g++
compiles them through a small host harness, with the header the kernel
build generates, and ctypes loads the result.  As for the Fp12 plans
(tests/test_torch_fp12_host.py), the harness runs each phase's tasks
forward, in reverse, and isolated (every task sees the scratch area as
the phase found it; two tasks writing one word fail), on a scratch area
poisoned with non-canonical words.

The results must equal the port's plain versions (``ops/pairing.py``
``_dbl_step``, ``_add_step`` and ``miller_loop_reference``, ``ops/fp.py``
``inv_reference``) and, for the inverse, Python's ``pow``: tolerance 0,
exact integer work with unique canonical limbs.  The steps are
polynomials, so random Fp2 values stand for the points; zero lanes are
among them.  Without g++ the tests skip.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu.ref import curve as RC
from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.ops import fp as TFP
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ops import pairing as TPR
from harmony_tpu_torch.ops import schedule as S
from test_torch_fp import P, _limbs

_HOST_SRC = r"""
#include <cstddef>
#include <cstdint>
#include <vector>

#include "miller.cuh"

namespace {

constexpr int kWords = fp384::kWords;
constexpr int kLimbs = fp384::kLimbs;

void load(const int32_t* src, uint32_t* s, int i) {
  uint32_t l[kLimbs], w[kWords];
  for (int k = 0; k < kLimbs; ++k) l[k] = static_cast<uint32_t>(src[k]);
  fp384::pack(l, w);
  fp12::st(s, i, w);
}

void store(const uint32_t* s, int i, int32_t* dst) {
  uint32_t l[kLimbs], w[kWords];
  fp12::ld(s, i, w);
  fp384::unpack(w, l);
  for (int k = 0; k < kLimbs; ++k) dst[k] = static_cast<int32_t>(l[k]);
}

// Run the n tasks of one phase on scratch s: order 0 forward, 1 in
// reverse, 2 isolated (each task on a copy of s as the phase found it;
// the words it changed are merged back, and two tasks changing one word
// is an error).  Returns false on such a conflict.
template <class Task>
bool run_phase(std::vector<uint32_t>& s, int n, int order, Task task) {
  if (order < 2) {
    for (int i = 0; i < n; ++i) task(order ? n - 1 - i : i, s.data());
    return true;
  }
  const std::vector<uint32_t> before = s;
  std::vector<int> writer(s.size(), -1);
  for (int k = 0; k < n; ++k) {
    std::vector<uint32_t> mine = before;
    task(k, mine.data());
    for (std::size_t j = 0; j < s.size(); ++j) {
      if (mine[j] == before[j]) continue;
      if (writer[j] >= 0) return false;
      writer[j] = k;
      s[j] = mine[j];
    }
  }
  return true;
}

bool run_op(std::vector<uint32_t>& s, int op, int order) {
  for (int phase = 0; phase < miller::op_phases(op); ++phase) {
    if (!run_phase(s, miller::op_tasks(op, phase), order,
                   [op, phase](int k, uint32_t* x) {
                     miller::op_task(op, phase, k, x);
                   })) {
      return false;
    }
  }
  return true;
}

// A scratch area full of words that are no canonical element, P and Q of
// one lane loaded as the kernel loads them, and the init operation run.
bool start(std::vector<uint32_t>& s, const int32_t* p, const int32_t* q,
           int order) {
  for (auto& w : s) w = 0xa5a5a5a5u;
  for (int e = 0; e < 2; ++e) load(p + e * kLimbs, s.data(), miller::kXp + e);
  for (int e = 0; e < 4; ++e) load(q + e * kLimbs, s.data(), miller::kXq + e);
  return run_op(s, miller::kInit, order);
}

}  // namespace

// The loop's operations between init and conj, in order; returns their
// count (at most n are written).
extern "C" int host_miller_schedule(int32_t* ops, int n) {
  const int steps = miller::steps();
  for (int i = 0; i < steps && i < n; ++i) ops[i] = miller::step_op(i);
  return steps;
}

// The whole loop, lane by lane, as the kernel runs it.  Returns 0, or -1
// if two tasks of one phase wrote the same word.
extern "C" int host_miller_loop(const int32_t* p, const int32_t* q,
                                int32_t* out, int64_t lanes, int order) {
  std::vector<uint32_t> s(miller::kScratch * kWords);
  for (int64_t lane = 0; lane < lanes; ++lane) {
    bool ok = start(s, p + lane * 2 * kLimbs, q + lane * 4 * kLimbs, order);
    const int steps = miller::steps();
    for (int i = 0; ok && i < steps; ++i) ok = run_op(s, miller::step_op(i), order);
    if (!ok || !run_op(s, miller::kConj, order)) return -1;
    for (int e = 0; e < fp12::kElems; ++e) {
      store(s.data(), miller::kF + e, out + (lane * fp12::kElems + e) * kLimbs);
    }
  }
  return 0;
}

// One doubling (op kDbl) or addition (op kAdd) of the twist point t
// (X, Y, Z) against P and the affine Q: the new point into t_out and the
// line, as the dense Fp12 operand b, into line.  Returns 0 or -1 as above.
extern "C" int host_miller_step(int op, const int32_t* p, const int32_t* q,
                                const int32_t* t, int32_t* t_out,
                                int32_t* line, int64_t lanes, int order) {
  std::vector<uint32_t> s(miller::kScratch * kWords);
  for (int64_t lane = 0; lane < lanes; ++lane) {
    if (!start(s, p + lane * 2 * kLimbs, q + lane * 4 * kLimbs, order)) {
      return -1;
    }
    for (int e = 0; e < 6; ++e) {
      load(t + (lane * 6 + e) * kLimbs, s.data(), miller::kX + e);
    }
    if (!run_op(s, op, order)) return -1;
    for (int e = 0; e < 6; ++e) {
      store(s.data(), miller::kX + e, t_out + (lane * 6 + e) * kLimbs);
    }
    for (int e = 0; e < fp12::kElems; ++e) {
      store(s.data(), miller::kB + e, line + (lane * fp12::kElems + e) * kLimbs);
    }
  }
  return 0;
}

extern "C" void host_fp_inv(const int32_t* a, int32_t* out, int64_t rows) {
  for (int64_t r = 0; r < rows; ++r) {
    uint32_t l[kLimbs], w[kWords], z[kWords];
    for (int k = 0; k < kLimbs; ++k) l[k] = static_cast<uint32_t>(a[r * kLimbs + k]);
    fp384::pack(l, w);
    fp384::inv(w, z);
    fp384::unpack(z, l);
    for (int k = 0; k < kLimbs; ++k) out[r * kLimbs + k] = static_cast<int32_t>(l[k]);
  }
}
"""

_ORDERS = {"forward": 0, "reverse": 1, "isolated": 2}
_OPS = {"init": 0, "copy": 1, "mul": 2, "dbl": 3, "add": 4}
R = 1 << 384


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of miller.cuh "
                    "needs a C++17 compiler")
    tmp = tmp_path_factory.mktemp("miller_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "miller_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "miller_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_miller_schedule.argtypes = [ptr, i32]
    lib.host_miller_loop.argtypes = [ptr] * 3 + [i64, i32]
    lib.host_miller_step.argtypes = [i32] + [ptr] * 5 + [i64, i32]
    lib.host_fp_inv.argtypes = [ptr, ptr, i64]
    lib.host_fp_inv.restype = None
    return lib


def _ptr(x):
    return x.ctypes.data


def _canonical(g, *shape):
    """Seeded random canonical elements as (*shape, 32) limbs: 12-bit limbs
    with the top limb below p's (416)."""
    a = g.integers(0, 4096, size=(*shape, 32), dtype=np.int32)
    a[..., 31] = g.integers(0, 416, size=shape)
    return a


def _step_inputs(seed):
    """P (lanes, 2, 32), Q (lanes, 2, 2, 32) and T (lanes, 3, 2, 32) for
    six lanes: random, then with Z = 0, with Y = 0, all of T zero, P zero,
    and Q zero."""
    g = np.random.default_rng(seed)
    p, q, t = _canonical(g, 6, 2), _canonical(g, 6, 2, 2), _canonical(g, 6, 3, 2)
    t[1, 2] = 0
    t[2, 1] = 0
    t[3] = 0
    p[4] = 0
    q[5] = 0
    return p, q, t


_STEP_CASES = {"random lanes": 0x4D11, "other random lanes": 0x4D12}


def _plain_step(op, p, q, t):
    """The plain port's step on the same inputs: the new point stacked
    (lanes, 3, 2, 32), and the line as the dense Fp12 the loop builds."""
    p, q, t = (torch.from_numpy(x) for x in (p, q, t))
    xp, yp = p[:, 0], p[:, 1]
    x, y, z = t[:, 0], t[:, 1], t[:, 2]
    if op == "dbl":
        point, line = TPR._dbl_step(x, y, z, TPR._small(xp, 3), yp)
    else:
        point, line = TPR._add_step(x, y, z, q[:, 0], q[:, 1], xp, yp)
    return (torch.stack(point, dim=1).numpy(),
            TPR._sparse_line_to_fp12(*line).numpy())


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("case", sorted(_STEP_CASES))
@pytest.mark.parametrize("op", ["add", "dbl"])
def test_step_equals_the_plain_step(host_lib, op, case, order):
    p, q, t = _step_inputs(_STEP_CASES[case])
    t_out, line = np.empty_like(t), np.empty((6, 2, 3, 2, 32), np.int32)
    rc = host_lib.host_miller_step(_OPS[op], _ptr(p), _ptr(q), _ptr(t),
                                   _ptr(t_out), _ptr(line), 6, _ORDERS[order])
    assert rc == 0, "two tasks of one phase write the same word"
    want_t, want_line = _plain_step(op, p, q, t)
    np.testing.assert_array_equal(t_out, want_t)
    np.testing.assert_array_equal(line, want_line)


def test_schedule_replays_the_plain_loop(host_lib):
    """The operations between init and conj are the plain loop's: per
    doubling b = f, f^2, the step, f times the line; per addition the
    step, f times the line; over |x|'s segments."""
    want = []
    for n_dbl, do_add in zip(*S.X_SCHED):
        want += [_OPS["copy"], _OPS["mul"], _OPS["dbl"], _OPS["mul"]] * n_dbl
        want += [_OPS["add"], _OPS["mul"]] * do_add
    ops = np.zeros(len(want) + 8, np.int32)
    assert host_lib.host_miller_schedule(_ptr(ops), len(ops)) == len(want)
    assert ops[:len(want)].tolist() == want


@pytest.fixture(scope="module")
def pairs():
    """Four lanes of affine P and Q in the Montgomery domain: two pairs of
    multiples of the generators, then (P, infinity) and
    (infinity, Q), as verify's padded and forged lanes give the loop; and
    the plain loop's f on them, computed once."""
    # small multiples of the generators: points of the groups, cheap to make
    g1 = [RC.g1.mul(RC.G1_GEN, k) for k in (3, 5, 7)]
    g2 = [RC.g2.mul(RC.G2_GEN, k) for k in (11, 13, 17)]
    p = torch.stack([TI.g1_affine_to_arr(x) for x in g1[:3]]
                    + [torch.zeros(2, 32, dtype=torch.int32)])
    q = torch.stack([TI.g2_affine_to_arr(x) for x in g2[:2]]
                    + [torch.zeros(2, 2, 32, dtype=torch.int32),
                       TI.g2_affine_to_arr(g2[2])])
    return p.numpy(), q.numpy(), TPR.miller_loop_reference(p, q).numpy()


@pytest.mark.parametrize("order", sorted(_ORDERS))
def test_loop_equals_the_plain_loop(host_lib, pairs, order):
    p, q, want = pairs
    got = np.empty_like(want)
    rc = host_lib.host_miller_loop(_ptr(p), _ptr(q), _ptr(got), len(p),
                                   _ORDERS[order])
    assert rc == 0, "two tasks of one phase write the same word"
    np.testing.assert_array_equal(got, want)


def test_inverse_equals_the_plain_chain_and_pow(host_lib):
    """a^(p-2) in the Montgomery domain on 0, 1, p - 1, R mod p and seeded
    random rows."""
    rng = random.Random(0x1417)
    xs = [0, 1, P - 1, R % P] + [rng.randrange(P) for _ in range(6)]
    a = _limbs([x * R % P for x in xs])
    got = np.empty_like(a)
    host_lib.host_fp_inv(_ptr(a), _ptr(got), len(a))
    np.testing.assert_array_equal(
        got, TFP.inv_reference(torch.from_numpy(a)).numpy())
    np.testing.assert_array_equal(
        got, _limbs([pow(x, P - 2, P) * R % P for x in xs]))
