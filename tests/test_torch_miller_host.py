"""The Miller-loop and Fermat-inverse kernels' arithmetic and phase plans,
on the CPU.

``harmony_tpu_torch/csrc/miller.cuh`` holds the plans that
``miller_loop.cu`` runs on the card: a doubling (the step, f^2 beside it,
f times the tangent), an addition (the step, f times the chord), and the
loop over |x|'s schedule; ``csrc/fp384.cuh`` holds the Fermat chain that
``fp_inv.cu`` runs.  Outside nvcc both are plain C++, so here g++
compiles them through a small host harness, with the header the kernel
build generates, and ctypes loads the result.  The harness is the plans'
runner of tests/test_torch_fp12_host.py: each phase's tasks run forward,
in reverse, and isolated (every task sees the scratch area as the phase
found it; two tasks writing one word fail), on a scratch area poisoned
with non-canonical words, and every product is the split product with
its threads run step by step.

The results must equal the port's plain versions (``ops/pairing.py``
``_dbl_step``, ``_add_step`` and ``miller_loop_reference``,
``ops/towers.py`` ``fp12_sqr_reference`` and ``fp12_mul_reference``,
``ops/fp.py`` ``inv_reference``) and, for the inverse, Python's ``pow``:
tolerance 0, exact integer work with unique canonical limbs.  The steps
are polynomials, so random Fp2 values stand for the points and a random
Fp12 value for f; zero lanes are among them.  Without g++ the tests skip.
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
from harmony_tpu_torch.ops import towers as TT
from test_torch_fp import P, _limbs
from test_torch_fp12_host import HOST_RUNNER

_HOST_SRC = HOST_RUNNER + r"""
#include "miller.cuh"

namespace {

using host::load;
using host::store;
constexpr int kWords = fp384::kWords;
constexpr int kLimbs = fp384::kLimbs;

// A scratch area full of words that are no canonical element, and P and
// Q of one lane loaded as the kernel loads them.
void start(std::vector<uint32_t>& s, const int32_t* p, const int32_t* q) {
  host::poison(s);
  for (int e = 0; e < 2; ++e) load(p + e * kLimbs, s.data(), miller::kXp + e);
  for (int e = 0; e < 4; ++e) load(q + e * kLimbs, s.data(), miller::kXq + e);
}

}  // namespace

// The number of doublings, and per doubling 1 if an addition follows.
extern "C" int host_miller_schedule(int32_t* adds, int n) {
  for (int i = 0; i < miller::kDoublings && i < n; ++i) {
    adds[i] = static_cast<int32_t>(miller::kAdditions >> i & 1u);
  }
  return miller::kDoublings;
}

// The whole loop, lane by lane, as the kernel runs it.  Returns 0, or -1
// if two tasks of one phase wrote the same word.
extern "C" int host_miller_loop(const int32_t* p, const int32_t* q,
                                int32_t* out, int64_t lanes, int order) {
  std::vector<uint32_t> s(miller::kScratch * kWords);
  for (int64_t lane = 0; lane < lanes; ++lane) {
    start(s, p + lane * 2 * kLimbs, q + lane * 4 * kLimbs);
    if (!miller::loop(host::Runner{&s, order})) return -1;
    for (int e = 0; e < fp12::kElems; ++e) {
      store(s.data(), miller::kF + e, out + (lane * fp12::kElems + e) * kLimbs);
    }
  }
  return 0;
}

// One doubling (op 0) or addition (op 1) of the loop from f, the twist
// point t (X, Y, Z), P and the affine Q: the new f into f_out, the new
// point into t_out and the line, as the dense Fp12 operand b, into line.
// Returns 0 or -1 as above.
extern "C" int host_miller_step(int op, const int32_t* p, const int32_t* q,
                                const int32_t* f, const int32_t* t,
                                int32_t* f_out, int32_t* t_out, int32_t* line,
                                int64_t lanes, int order) {
  std::vector<uint32_t> s(miller::kScratch * kWords);
  const host::Runner run{&s, order};
  for (int64_t lane = 0; lane < lanes; ++lane) {
    start(s, p + lane * 2 * kLimbs, q + lane * 4 * kLimbs);
    if (!run(miller::Start{})) return -1;
    for (int e = 0; e < 6; ++e) {
      load(t + (lane * 6 + e) * kLimbs, s.data(), miller::kX + e);
    }
    for (int e = 0; e < fp12::kElems; ++e) {
      load(f + (lane * fp12::kElems + e) * kLimbs, s.data(), miller::kF + e);
    }
    if (!(op == 0 ? run(miller::Double{}) : run(miller::Add{}))) return -1;
    for (int e = 0; e < 6; ++e) {
      store(s.data(), miller::kX + e, t_out + (lane * 6 + e) * kLimbs);
    }
    for (int e = 0; e < fp12::kElems; ++e) {
      const int64_t at = (lane * fp12::kElems + e) * kLimbs;
      store(s.data(), miller::kF + e, f_out + at);
      store(s.data(), miller::kB + e, line + at);
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
_OPS = {"dbl": 0, "add": 1}
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
    lib.host_miller_step.argtypes = [i32] + [ptr] * 7 + [i64, i32]
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
    """P (lanes, 2, 32), Q (lanes, 2, 2, 32), T (lanes, 3, 2, 32) and f
    (lanes, 2, 3, 2, 32) for six lanes: random, then with Z = 0, with
    Y = 0, all of T zero, P zero, and Q zero."""
    g = np.random.default_rng(seed)
    p, q = _canonical(g, 6, 2), _canonical(g, 6, 2, 2)
    t = _canonical(g, 6, 3, 2)
    t[1, 2] = 0
    t[2, 1] = 0
    t[3] = 0
    p[4] = 0
    q[5] = 0
    return p, q, t, _canonical(g, 6, 2, 3, 2)


_STEP_CASES = {"random lanes": 0x4D11, "other random lanes": 0x4D12}


def _plain_step(op, p, q, t, f):
    """The plain port's step on the same inputs: the new point stacked
    (lanes, 3, 2, 32), the line as the dense Fp12 the loop builds, and
    f^2 times the tangent (doubling) or f times the chord (addition)."""
    p, q, t, f = (torch.from_numpy(x) for x in (p, q, t, f))
    xp, yp = p[:, 0], p[:, 1]
    x, y, z = t[:, 0], t[:, 1], t[:, 2]
    if op == "dbl":
        point, line = TPR._dbl_step(x, y, z, TPR._small(xp, 3), yp)
        f = TT.fp12_sqr_reference(f)
    else:
        point, line = TPR._add_step(x, y, z, q[:, 0], q[:, 1], xp, yp)
    line = TPR._sparse_line_to_fp12(*line)
    return (torch.stack(point, dim=1).numpy(), line.numpy(),
            TT.fp12_mul_reference(f, line).numpy())


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("case", sorted(_STEP_CASES))
@pytest.mark.parametrize("op", ["add", "dbl"])
def test_step_equals_the_plain_step(host_lib, op, case, order):
    """One doubling or addition plan of miller.cuh (the step, and f^2 and
    f times the line beside it), each phase run forward, in reverse and
    isolated, on a poisoned scratch area."""
    p, q, t, f = _step_inputs(_STEP_CASES[case])
    t_out, line = np.empty_like(t), np.empty_like(f)
    f_out = np.empty_like(f)
    rc = host_lib.host_miller_step(_OPS[op], _ptr(p), _ptr(q), _ptr(f),
                                   _ptr(t), _ptr(f_out), _ptr(t_out),
                                   _ptr(line), 6, _ORDERS[order])
    assert rc == 0, "two tasks of one phase write the same word"
    want_t, want_line, want_f = _plain_step(op, p, q, t, f)
    np.testing.assert_array_equal(t_out, want_t)
    np.testing.assert_array_equal(line, want_line)
    np.testing.assert_array_equal(f_out, want_f)


def test_schedule_replays_the_plain_loop(host_lib):
    """The loop's doublings and the additions after them are the plain
    loop's, over |x|'s segments."""
    want = []
    for n_dbl, do_add in zip(*S.X_SCHED):
        want += [0] * (n_dbl - 1) + [do_add]
    adds = np.full(len(want) + 8, -1, np.int32)
    assert host_lib.host_miller_schedule(_ptr(adds), len(adds)) == len(want)
    assert adds[:len(want)].tolist() == want


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
