"""The fused Fp12 kernels' arithmetic and phase plans, and the split
Montgomery product, on the CPU.

``harmony_tpu_torch/csrc/fp12.cuh`` holds the Fp12 product that
``fp12_mul.cu`` runs on the card, ``csrc/cyclo.cuh`` the cyclotomic
squaring that ``fp12_cyclo_sqr.cu`` runs, both as phases of independent
tasks, and ``csrc/fp384_split.cuh`` the Montgomery product split over a
group of threads that the cyclotomic and Miller kernels use.  Outside
nvcc they are plain C++, so here g++ compiles them through a small host
harness, with the modulus header the kernel build generates, and ctypes
loads the result.  The harness runs each phase's tasks in one of three
orders: forward, in reverse, and isolated (every task sees the scratch
area as the phase found it, and the harness fails on two tasks writing
one word), so that a plan with a dependency inside a phase fails here
before it reaches the card.  It runs the split product's threads step by
step, with an array for the shuffles, forward or in reverse within each
step.

The fused results must equal the port's plain versions
(``ops/towers.py`` ``fp12_mul_reference``, ``fp12_sqr_reference``,
``fp12_cyclo_sqr_n`` on CPU tensors), and the split product
``fp384::mont_mul`` and the bigint, bit for bit: tolerance 0, exact
integer work with unique canonical limbs.  Inputs are seeded random
values, values built from the worst-case carry vectors of
tests/test_torch_fp.py, elements of the cyclotomic subgroup, and for the
product the edge words (0, 1, p - 1, words of all ones, values just
under p).  Without g++ the tests skip.
"""

import ctypes
import functools
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu.ops import interop as JI
from harmony_tpu.ref import fields as RF
from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.ops import fp as TFP
from harmony_tpu_torch.ops import pairing as TPR
from harmony_tpu_torch.ops import schedule as S
from harmony_tpu_torch.ops import towers as TT
from harmony_tpu_torch.ops.limbs import limbs_to_int
from test_torch_fp import _CARRY_VECTORS, P, _limbs

# The runner of the phase plans (csrc/phases.cuh) on the CPU, shared with
# tests/test_torch_miller_host.py: run_tasks runs one phase's n tasks in
# an order (0 forward, 1 in reverse, 2 isolated: each task on a copy of
# the scratch as the phase found it, the words it changed merged back, two
# tasks changing one word an error); a product task's product is the split
# product with the group's threads run step by step, in reverse within
# each step for order 1.
HOST_RUNNER = r"""
#include <cstddef>
#include <cstdint>
#include <vector>

#include "phases.cuh"

namespace host {

constexpr int kWords = fp384::kWords;
constexpr int kGroup = split::kGroup;

void split_mul(const uint32_t a[kWords], const uint32_t b[kWords],
               uint32_t out[kWords], bool reverse) {
  split::Part st[kGroup];
  uint32_t in[kGroup] = {}, shown[kGroup], res[kGroup][kWords];
  for (int r = 0; r < kGroup; ++r) split::start(r, b, st[r]);
  for (int s = 0; s < split::kSteps; ++s) {
    for (int i = 0; i < kGroup; ++i) {
      const int r = reverse ? kGroup - 1 - i : i;
      shown[r] = split::step(s, r, a, st[r], in[r]);
    }
    for (int r = 0; r < kGroup; ++r) in[r] = shown[split::source(s, r)];
  }
  for (int r = 0; r < kGroup; ++r) split::finish(st[r], in[r], res[r]);
  for (int j = 0; j < kWords; ++j) out[j] = res[0][j];
}

template <class Task>
bool run_tasks(std::vector<uint32_t>& s, int n, int order, Task task) {
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

// Runs plans on one lane's scratch area; returns false on a conflict.
struct Runner {
  std::vector<uint32_t>* s;
  int order;

  template <class Ph>
  bool phase() const {
    if constexpr (Ph::kProduct) {
      const bool reverse = order == 1;
      return run_tasks(*s, Ph::kTasks, order, [reverse](int k, uint32_t* x) {
        uint32_t a[kWords], b[kWords], r[kWords];
        const int out = Ph::operands(k, x, a, b);
        if (out < 0) return;  // a gap between kinds of task
        split_mul(a, b, r, reverse);
        fp12::st(x, out, r);
      });
    } else {
      return run_tasks(*s, Ph::kTasks, order,
                       [](int k, uint32_t* x) { Ph::task(k, x); });
    }
  }

  template <class... Ph>
  bool operator()(phases::Plan<Ph...>) const {
    bool ok = true;
    ((ok = phase<Ph>() && ok), ...);
    return ok;
  }
};

void load(const int32_t* src, uint32_t* s, int i) {
  uint32_t l[fp384::kLimbs], w[kWords];
  for (int k = 0; k < fp384::kLimbs; ++k) l[k] = static_cast<uint32_t>(src[k]);
  fp384::pack(l, w);
  fp12::st(s, i, w);
}

void store(const uint32_t* s, int i, int32_t* dst) {
  uint32_t l[fp384::kLimbs], w[kWords];
  fp12::ld(s, i, w);
  fp384::unpack(w, l);
  for (int k = 0; k < fp384::kLimbs; ++k) dst[k] = static_cast<int32_t>(l[k]);
}

// Scratch full of words that are no canonical element, so that a task
// reading what no earlier phase wrote gives a wrong result.
void poison(std::vector<uint32_t>& s) {
  for (auto& w : s) w = 0xa5a5a5a5u;
}

}  // namespace host
"""

_HOST_SRC = HOST_RUNNER + r"""
#include "cyclo.cuh"

namespace {

using host::load;
using host::poison;
using host::store;
constexpr int kWords = fp384::kWords;

}  // namespace

extern "C" int host_fp12_mul(const int32_t* a, const int32_t* b, int32_t* out,
                             int64_t lanes, int order) {
  std::vector<uint32_t> s(fp12::kMulScratch * kWords);
  const int64_t stride = fp12::kElems * fp384::kLimbs;
  for (int64_t lane = 0; lane < lanes; ++lane) {
    poison(s);
    for (int e = 0; e < fp12::kElems; ++e) {
      load(a + lane * stride + e * fp384::kLimbs, s.data(), fp12::kMulA + e);
      load(b + lane * stride + e * fp384::kLimbs, s.data(), fp12::kMulB + e);
    }
    for (int phase = 0; phase < fp12::kMulPhases; ++phase) {
      if (!host::run_tasks(s, fp12::mul_tasks(phase), order,
                           [phase](int k, uint32_t* x) {
                             fp12::mul_task(phase, k, x);
                           })) {
        return -1 - phase;
      }
    }
    for (int e = 0; e < fp12::kElems; ++e) {
      store(s.data(), fp12::kMulOut + e,
            out + lane * stride + e * fp384::kLimbs);
    }
  }
  return 0;
}

extern "C" int host_fp12_cyclo_sqr(const int32_t* a, int32_t* out,
                                   int64_t lanes, int n, int order) {
  std::vector<uint32_t> s(cyclo::kScratch * kWords);
  const host::Runner run{&s, order};
  const int64_t stride = fp12::kElems * fp384::kLimbs;
  for (int64_t lane = 0; lane < lanes; ++lane) {
    poison(s);
    for (int e = 0; e < fp12::kElems; ++e) {
      load(a + lane * stride + e * fp384::kLimbs, s.data(), cyclo::kV + e);
    }
    for (int round = 0; round < n; ++round) {
      if (!run(cyclo::Square{})) return -1;
    }
    for (int e = 0; e < fp12::kElems; ++e) {
      store(s.data(), cyclo::kV + e, out + lane * stride + e * fp384::kLimbs);
    }
  }
  return 0;
}

// Rows of a b 2^-384 mod p: how 0 by fp384::mont_mul, 1 by the split
// product with its threads forward, 2 in reverse.
extern "C" void host_mont_mul(const int32_t* a, const int32_t* b, int32_t* out,
                              int64_t rows, int how) {
  std::vector<uint32_t> s(3 * kWords);
  for (int64_t r = 0; r < rows; ++r) {
    uint32_t x[kWords], y[kWords], z[kWords];
    load(a + r * fp384::kLimbs, s.data(), 0);
    load(b + r * fp384::kLimbs, s.data(), 1);
    fp12::ld(s.data(), 0, x);
    fp12::ld(s.data(), 1, y);
    if (how == 0) {
      fp384::mont_mul(x, y, z);
    } else {
      host::split_mul(x, y, z, how == 2);
    }
    fp12::st(s.data(), 2, z);
    store(s.data(), 2, out + r * fp384::kLimbs);
  }
}
"""

_ORDERS = {"forward": 0, "reverse": 1, "isolated": 2}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of fp12.cuh needs "
                    "a C++17 compiler")
    tmp = tmp_path_factory.mktemp("fp12_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "fp12_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "fp12_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    lib.host_fp12_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                         ctypes.c_int]
    lib.host_fp12_cyclo_sqr.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.host_fp12_mul.restype = lib.host_fp12_cyclo_sqr.restype = ctypes.c_int
    lib.host_mont_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64,
                                                         ctypes.c_int]
    lib.host_mont_mul.restype = None
    return lib


def _host(fn, *xs, extra=()):
    xs = [np.ascontiguousarray(x, dtype=np.int32) for x in xs]
    out = np.empty_like(xs[0])
    lanes = xs[0].size // (12 * 32)
    rc = fn(*(x.ctypes.data for x in xs), out.ctypes.data, lanes, *extra)
    assert rc == 0, "two tasks of one phase write the same word"
    return out


def _random_fp12(lanes, seed):
    g = np.random.default_rng(seed)
    a = g.integers(0, 4096, size=(lanes, 2, 3, 2, 32), dtype=np.int32)
    a[..., 31] = g.integers(0, 416, size=(lanes, 2, 3, 2))  # below p's top
    return a


def _carry_fp12():
    """Fp12 lanes whose 12 elements cycle through the worst-case carry
    vectors (0, 1, p - 1, all-ones limb runs and their partners)."""
    xs = sorted({x for pair in _CARRY_VECTORS.values() for v in pair
                 for x in v})
    rows = _limbs([xs[i % len(xs)] for i in range(4 * 12)])
    a = rows.reshape(4, 2, 3, 2, 32)
    return a, a[::-1].copy()


def _cyclotomic_fp12(lanes, seed):
    """f^((p^6 - 1)(p^2 + 1)) for random f: unitary elements, as every
    final-exponentiation intermediate after the easy part."""
    rng = random.Random(seed)
    out = []
    for _ in range(lanes):
        f = tuple(tuple((rng.randrange(P), rng.randrange(P))
                        for _ in range(3)) for _ in range(2))
        f1 = RF.fp12_mul(RF.fp12_conj(f), RF.fp12_inv(f))
        out.append(RF.fp12_mul(RF.fp12_pow(f1, P * P), f1))
    return JI.batch(JI.fp12_to_arr, out)


_CARRY_A, _CARRY_B = _carry_fp12()
_CASES = {
    "random": (_random_fp12(6, 12), _random_fp12(6, 13)),
    "carry_vectors": (_CARRY_A, _CARRY_B),
    "cyclotomic": (_cyclotomic_fp12(2, 14), _cyclotomic_fp12(2, 15)),
}


def _plain(fn, *xs):
    return fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)).numpy()


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_fp12_mul_equals_the_plain_version(host_lib, case, order):
    a, b = _CASES[case]
    got = _host(host_lib.host_fp12_mul, a, b, extra=(_ORDERS[order],))
    np.testing.assert_array_equal(got, _plain(TT.fp12_mul_reference, a, b))


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_squaring_equals_the_plain_complex_method(host_lib, case,
                                                        order):
    a, _ = _CASES[case]
    got = _host(host_lib.host_fp12_mul, a, a, extra=(_ORDERS[order],))
    np.testing.assert_array_equal(got, _plain(TT.fp12_sqr_reference, a))


@functools.lru_cache(maxsize=None)
def _plain_cyclo(case, n):
    """n plain squarings of case's first operand, computed once."""
    a = torch.from_numpy(np.ascontiguousarray(_CASES[case][0]))
    for _ in range(n):
        a = TT.fp12_cyclo_sqr_reference(a)
    return a.numpy()


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("n", [1, 2, 9, 32])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_fused_cyclo_sqr_equals_the_plain_loop(host_lib, case, n, order):
    """cyclo.cuh's plan, each phase run forward, in reverse and isolated
    on a poisoned scratch area, n times in a row."""
    a, _ = _CASES[case]
    got = _host(host_lib.host_fp12_cyclo_sqr, a, extra=(n, _ORDERS[order]))
    np.testing.assert_array_equal(got, _plain_cyclo(case, n))


def test_zero_squarings_return_the_input(host_lib):
    a, _ = _CASES["random"]
    np.testing.assert_array_equal(
        _host(host_lib.host_fp12_cyclo_sqr, a, extra=(0, 2)), a)


def _split_cases():
    """Operand rows for the split product: every pair of the edge values
    (0, 1, p - 1, 2^384 mod p, words of all ones, values just under p and
    under 2^381), whose products ripple carries through every word and
    reach t's bound; and seeded random canonical pairs."""
    r = 1 << 384
    edges = [0, 1, 2, P - 1, P - 2, P - (1 << 32), P - (1 << 64), r % P,
             (1 << 352) - 1, (1 << 380) - 1, (1 << 32) - 1,
             P - (1 << 352), int("5" * 95, 16) % P]
    pairs = [(x, y) for x in edges for y in edges]
    rng = random.Random(0x5917)
    pairs += [(rng.randrange(P), rng.randrange(P)) for _ in range(256)]
    return {"edges": pairs[:len(edges) ** 2], "random": pairs[len(edges) ** 2:]}


_SPLIT_CASES = _split_cases()


@pytest.mark.parametrize("threads", ["forward", "reverse"])
@pytest.mark.parametrize("case", sorted(_SPLIT_CASES))
def test_split_product_equals_mont_mul(host_lib, case, threads):
    """fp384_split.cuh's product, its threads run step by step in each
    order, equals fp384::mont_mul, the plain version and the bigint, on
    (p - 1)^2 and the other edge pairs and on random pairs."""
    xs, ys = zip(*_SPLIT_CASES[case])
    a, b = _limbs(list(xs)), _limbs(list(ys))
    out = {}
    for how in (0, 1 if threads == "forward" else 2):
        out[how] = np.empty_like(a)
        host_lib.host_mont_mul(a.ctypes.data, b.ctypes.data,
                               out[how].ctypes.data, len(a), how)
    np.testing.assert_array_equal(out[1 if threads == "forward" else 2],
                                  out[0])
    np.testing.assert_array_equal(
        out[0], TFP.mont_mul_reference(torch.from_numpy(a),
                                       torch.from_numpy(b)).numpy())
    inv_r = pow(1 << 384, -1, P)
    assert [limbs_to_int(row) for row in out[0]] == [
        x * y * inv_r % P for x, y in zip(xs, ys)]


# a short schedule with runs of one, two and several squarings, and a
# trailing run without a multiply, like |x|'s
_SHORT_SCHED = S.schedule(0b1101000100000)


@pytest.mark.parametrize("sched", ["short", "x_minus_1"])
def test_cyclo_pow_by_segments_equals_one_squaring_at_a_time(sched):
    """``_cyclo_pow_abs`` squares once per segment (``fp12_cyclo_sqr_n``);
    the same schedule one squaring at a time, and the bigint power, agree
    with it."""
    n_sqr, do_mul = {"short": _SHORT_SCHED, "x_minus_1": S.XM1_SCHED}[sched]
    a = torch.from_numpy(_CASES["cyclotomic"][0])
    got = TPR._cyclo_pow_abs(a, (n_sqr, do_mul))
    acc = a
    for n, mul in zip(n_sqr, do_mul):
        for _ in range(n):
            acc = TT.fp12_cyclo_sqr_reference(acc)
        if mul:
            acc = TT.fp12_mul_reference(acc, a)
    np.testing.assert_array_equal(got.numpy(), acc.numpy())
    if sched == "short":
        e = 1
        for n, mul in zip(n_sqr, do_mul):
            e = (e << n) + mul
        want = [RF.fp12_pow(JI.arr_to_fp12(x), e) for x in a.numpy()]
        assert [JI.arr_to_fp12(x) for x in got.numpy()] == want
