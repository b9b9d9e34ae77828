"""The scalar multiplication and masked G2 sum kernels' plans, on the CPU.

``harmony_tpu_torch/csrc/jac.cuh`` holds the plans that ``scalar_mul.cu``
(one lane's ladder: a setup, then a step a bit of six rounds of products
that only load their operands, each followed by a phase of adds, the
last of which selects by the bit) and ``g2_masked_sum.cu`` (an add of
the tree in five such rounds, with the doubling where its operands are
equal; its partition over blocks is held in
tests/test_torch_g2_sum_host.py) run on the card, over Fp and Fp2 by one
template.  Outside nvcc they are plain C++,
so here g++ compiles them through a small host harness, with the header
the kernel build generates, and ctypes loads the result.  The harness is
the plans' runner of tests/test_torch_fp12_host.py: each phase's tasks
run forward, in reverse and isolated (every task sees the scratch area as
the phase found it; two tasks writing one word fail), on a scratch area
poisoned with non-canonical words, and every product is the split
product with its threads run step by step.

The ladder and the sum must equal the port's plain versions
(``ops/curve.py`` ``scalar_mul_reference`` and ``masked_sum_reference``)
bit for bit, Jacobian limbs (tolerance 0: they depend on the formula, and
the plans keep the reference's), over G1 and G2, with per-lane and shared
bits, on a point at infinity, zero scalars, a repeated point (the
doubling), a point and its negative, infinity leaves and mask words
other than 0 and 1; at full width (255 and 507 bits) the ladder must give
the bigint reference's points.  The constant-time property, where it can
be checked without a card: the ladder runs the same phases, tasks and
products, in the same order, for a scalar of all zeros, one of all ones
and a random one.  The ladder's product tasks make no modular add or
sub (phases.cuh's count of them).  Without g++ the tests skip.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.ops import _constants as C
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ref import fields as RF
from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
from harmony_tpu_torch.ref.params import R_ORDER
from test_torch_fp12_host import HOST_RUNNER

# Counts the modular adds and subs of phases.cuh (its PHASES_COUNT_OP hook)
_COUNTER = r"""
#include <cstdint>
namespace host_ops {
inline int64_t count = 0;
}
#define PHASES_COUNT_OP() (++host_ops::count)
"""

_HOST_SRC = _COUNTER + HOST_RUNNER + r"""
#include "jac.cuh"

namespace {

using host::load;
using host::store;
constexpr int kWords = fp384::kWords;
constexpr int kLimbs = fp384::kLimbs;

// One lane's scratch area as scalar_mul.cu starts it: poisoned, the base
// point and (1, 1, 0) in place.
template <class F>
void start(std::vector<uint32_t>& s, const int32_t* point) {
  using L = jac::Ladder<F>;
  host::poison(s);
  for (int e = 0; e < 3 * F::kE; ++e) {
    load(point + e * kLimbs, s.data(), L::kBase + e);
    uint32_t w[kWords];
    jac::infinity_element<F>(e, w);
    fp12::st(s.data(), L::kAcc + e, w);
  }
}

// The ladder of each lane as scalar_mul.cu runs it: the setup, then a
// step a bit, the bit's mask written first.
template <class F>
int ladder(const int32_t* points, const int32_t* bits, int64_t n_bits,
           int shared, int32_t* out, int64_t lanes, int order) {
  using L = jac::Ladder<F>;
  constexpr int kRows = 3 * F::kE;
  std::vector<uint32_t> s(L::kScratch * kWords);
  const host::Runner run{&s, order};
  for (int64_t lane = 0; lane < lanes; ++lane) {
    start<F>(s, points + lane * kRows * kLimbs);
    if (!run(typename L::Setup{})) return -1;
    const int32_t* mine = bits + (shared ? 0 : lane * n_bits);
    for (int64_t i = 0; i < n_bits; ++i) {
      s[L::kBitWord] = jac::mask(mine[i] == 1);
      if (!run(typename L::Step{})) return -1;
    }
    for (int e = 0; e < kRows; ++e) {
      store(s.data(), L::kAcc + e, out + (lane * kRows + e) * kLimbs);
    }
  }
  return 0;
}

// The masked sum by the add of g2_masked_sum.cu, on one scratch area: the
// leaves selected by the mask and padded with (1, 1, 0), then each
// level's adds, point k + half into point k.
template <class F>
int masked_sum(const int32_t* points, const int32_t* mask, int64_t n,
               int32_t* out, int order) {
  using A = jac::sum::Slots<F>;
  constexpr int kPoint = 3 * F::kE;
  const int size = jac::leaves(n);
  std::vector<uint32_t> leaves(size * kPoint * kWords);
  for (int i = 0; i < size; ++i) {
    for (int e = 0; e < kPoint; ++e) {
      if (i < n && mask[i] == 1) {
        load(points + (i * kPoint + e) * kLimbs, leaves.data(), i * kPoint + e);
      } else {
        uint32_t w[kWords];
        jac::infinity_element<F>(e, w);
        fp12::st(leaves.data(), i * kPoint + e, w);
      }
    }
  }
  std::vector<uint32_t> s(A::kEnd * kWords);
  const host::Runner run{&s, order};
  for (int half = size / 2; half >= 1; half /= 2) {
    for (int k = 0; k < half; ++k) {
      host::poison(s);
      for (int j = 0; j < kPoint * kWords; ++j) {
        s[A::kP1 * kWords + j] = leaves[k * kPoint * kWords + j];
        s[A::kP2 * kWords + j] = leaves[(k + half) * kPoint * kWords + j];
      }
      if (!jac::sum::add<F>(run, s.data())) return -1;
      for (int j = 0; j < kPoint * kWords; ++j) {
        leaves[k * kPoint * kWords + j] = s[A::kP1 * kWords + j];
      }
    }
  }
  for (int e = 0; e < kPoint; ++e) store(leaves.data(), e, out + e * kLimbs);
  return 0;
}

// Records what a plan runs: each phase's kind and tasks, and each product
// task's element, hashed in order (FNV-1a), with the products counted, and
// the modular adds and subs of the product tasks (forming operands) and of
// the phases of adds counted apart.
struct Tracer {
  std::vector<uint32_t>* s;
  uint64_t* hash;
  int64_t* products;
  int64_t* product_ops;
  int64_t* linear_ops;

  void mix(uint64_t v) const {
    *hash = (*hash ^ v) * 0x100000001b3ull;
  }

  template <class Ph>
  bool phase() const {
    mix(Ph::kProduct ? 1 : 2);
    mix(Ph::kTasks);
    for (int k = 0; k < Ph::kTasks; ++k) {
      const int64_t before = host_ops::count;
      if constexpr (Ph::kProduct) {
        uint32_t x[kWords], y[kWords], r[kWords];
        const int at = Ph::operands(k, s->data(), x, y);
        *product_ops += host_ops::count - before;
        mix(static_cast<uint64_t>(at));
        fp384::mont_mul(x, y, r);
        fp12::st(s->data(), at, r);
        ++*products;
      } else {
        Ph::task(k, s->data());
        *linear_ops += host_ops::count - before;
      }
    }
    return true;
  }

  template <class... Ph>
  bool operator()(phases::Plan<Ph...>) const {
    (phase<Ph>(), ...);
    return true;
  }
};

// counts: the products, then the adds and subs of the product tasks and
// of the phases of adds, over the setup and the steps.
template <class F>
void trace(const int32_t* point, const int32_t* bits, int64_t n_bits,
           uint64_t* hash, int64_t* counts, int32_t* out) {
  using L = jac::Ladder<F>;
  constexpr int kRows = 3 * F::kE;
  std::vector<uint32_t> s(L::kScratch * kWords);
  start<F>(s, point);
  *hash = 0xcbf29ce484222325ull;
  counts[0] = counts[1] = counts[2] = 0;
  const Tracer run{&s, hash, counts, counts + 1, counts + 2};
  run(typename L::Setup{});
  for (int64_t i = 0; i < n_bits; ++i) {
    s[L::kBitWord] = jac::mask(bits[i] == 1);
    run(typename L::Step{});
  }
  for (int e = 0; e < kRows; ++e) store(s.data(), L::kAcc + e, out + e * kLimbs);
}

}  // namespace

extern "C" int host_ladder(int field, const int32_t* points,
                           const int32_t* bits, int64_t n_bits, int shared,
                           int32_t* out, int64_t lanes, int order) {
  return field == 1
             ? ladder<jac::Fp>(points, bits, n_bits, shared, out, lanes, order)
             : ladder<jac::Fp2>(points, bits, n_bits, shared, out, lanes,
                                order);
}

extern "C" int host_masked_sum(int field, const int32_t* points,
                               const int32_t* mask, int64_t n, int32_t* out,
                               int order) {
  return field == 1 ? masked_sum<jac::Fp>(points, mask, n, out, order)
                    : masked_sum<jac::Fp2>(points, mask, n, out, order);
}

extern "C" void host_trace(int field, const int32_t* point,
                           const int32_t* bits, int64_t n_bits,
                           uint64_t* hash, int64_t* counts, int32_t* out) {
  if (field == 1) {
    trace<jac::Fp>(point, bits, n_bits, hash, counts, out);
  } else {
    trace<jac::Fp2>(point, bits, n_bits, hash, counts, out);
  }
}

// The lane's scratch elements, threads and phases a step (scalar_mul.cu)
// and an add's scratch elements (g2_masked_sum.cu), by field.
template <class F>
void sizes(int32_t* out) {
  using L = jac::Ladder<F>;
  out[0] = L::kScratch;
  out[1] = L::kThreads;
  out[2] = jac::sum::Slots<F>::kEnd;
  out[3] = L::kPhases;
}

extern "C" void host_sizes(int field, int32_t* out) {
  if (field == 1) {
    sizes<jac::Fp>(out);
  } else {
    sizes<jac::Fp2>(out);
  }
}
"""

_ORDERS = {"forward": 0, "reverse": 1, "isolated": 2}
_FIELDS = {"g1": (1, TCV.FP_OPS, (3, 32)), "g2": (2, TCV.FP2_OPS, (3, 2, 32))}
# Montgomery products of the ladder's setup (Z2^2 and Z2^3 of the base
# point) and of a step: 8 squares and 13 products (the doubling's 5 and
# 1, the addition's 3 and 12, Z1 (2 Z2) in place of its Z2^2, Z2^3 and
# (Z1 + Z2)^2), over Fp2 schoolbook (3 and 4 Montgomery products)
_SETUP_PRODUCTS = {"g1": 1 + 1, "g2": 3 + 4}
_STEP_PRODUCTS = {"g1": 8 + 13, "g2": 8 * 3 + 13 * 4}

rng = random.Random(0x5CA1)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of jac.cuh needs a "
                    "C++17 compiler")
    tmp = tmp_path_factory.mktemp("jac_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "jac_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "jac_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=180)
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_ladder.argtypes = [i32, ptr, ptr, i64, i32, ptr, i64, i32]
    lib.host_masked_sum.argtypes = [i32, ptr, ptr, i64, ptr, i32]
    lib.host_trace.argtypes = [i32, ptr, ptr, i64, ptr, ptr, ptr]
    lib.host_trace.restype = None
    lib.host_sizes.argtypes = [i32, ptr]
    lib.host_sizes.restype = None
    return lib


def _ptr(x):
    return x.ctypes.data


def _doubled(field, pts):
    """Host affine points (None: infinity), each doubled once by the plain
    doubling: Jacobian limbs with Z = 2 Y != 1."""
    to_arr = (TI.g1_affine_to_jacobian_arr if field == "g1"
              else TI.g2_affine_to_jacobian_arr)
    ops = _FIELDS[field][1]
    return TCV.dbl(torch.stack([to_arr(p) for p in pts]), ops)


def _points(field, n):
    """n random points of the group (a multiple of its generator), one of
    them at infinity."""
    group, gen = (g1, G1_GEN) if field == "g1" else (g2, G2_GEN)
    pts = [group.mul(gen, rng.randrange(1, R_ORDER)) for _ in range(n)]
    pts[1] = None
    return pts


def _host_ladder(lib, field, points, bits, order):
    pts = np.ascontiguousarray(points.numpy())
    b = np.ascontiguousarray(bits.numpy().astype(np.int32))
    out = np.zeros_like(pts)
    lanes = pts.shape[0] if pts.ndim > len(_FIELDS[field][2]) else 1
    assert lib.host_ladder(_FIELDS[field][0], _ptr(pts), _ptr(b), b.shape[-1],
                           int(b.ndim == 1), _ptr(out), lanes,
                           _ORDERS[order]) == 0
    return out


@pytest.fixture(scope="module")
def ladder_cases():
    """Per field: 4 points (one at infinity) with Z != 1, per-lane bits of
    12 bits (zeros, ones, random; a word other than 0 and 1), and the
    plain ladder's results for them and for the random row shared."""
    cases = {}
    for field, (_, ops, _) in _FIELDS.items():
        points = _doubled(field, _points(field, 4))
        bits = torch.tensor([[0] * 12, [1] * 12,
                             [rng.randrange(2) for _ in range(12)],
                             [1, 0, 2, 1, 1, 0, 1, -1, 0, 1, 1, 0]],
                            dtype=torch.int32)
        cases[field] = (points, bits,
                        TCV.scalar_mul_reference(points, bits, ops),
                        TCV.scalar_mul_reference(points, bits[2], ops))
    return cases


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("field", sorted(_FIELDS))
def test_ladder_equals_the_plain_version(host_lib, ladder_cases, field,
                                         order):
    points, bits, per_lane, shared = ladder_cases[field]
    np.testing.assert_array_equal(
        _host_ladder(host_lib, field, points, bits, order), per_lane.numpy())
    np.testing.assert_array_equal(
        _host_ladder(host_lib, field, points, bits[2], order), shared.numpy())


def test_ladder_of_no_bits_is_infinity(host_lib, ladder_cases):
    for field, (_, ops, _) in _FIELDS.items():
        points = ladder_cases[field][0]
        empty = torch.zeros(0, dtype=torch.int32)
        got = _host_ladder(host_lib, field, points, empty, "forward")
        np.testing.assert_array_equal(
            got, TCV.scalar_mul_reference(points, empty, ops).numpy())
        np.testing.assert_array_equal(
            got, TCV.infinity(ops, (4,)).numpy())


def _bits(k, n):
    return [(k >> (n - 1 - j)) & 1 for j in range(n)]


def test_ladder_at_full_width_gives_the_bigint_points(host_lib):
    """255-bit keys over G1 (derive_pubkeys) and G2 (sign), and G2's
    507-bit cofactor (clear_cofactor_g2), in affine against the bigint
    reference: the plans on real widths, where the plain version is slow
    on the CPU."""
    sks = [rng.randrange(1, R_ORDER) for _ in range(3)] + [R_ORDER - 1]
    for field, (group, gen) in (("g1", (g1, G1_GEN)), ("g2", (g2, G2_GEN))):
        base = [gen] * 4 if field == "g1" else \
            [g2.mul(G2_GEN, rng.randrange(1, R_ORDER)) for _ in range(4)]
        pts = torch.stack([(TI.g1_affine_to_jacobian_arr if field == "g1"
                            else TI.g2_affine_to_jacobian_arr)(p)
                           for p in base])
        bits = torch.tensor([_bits(k, 255) for k in sks], dtype=torch.int32)
        out = _host_ladder(host_lib, field, pts, bits, "forward")
        to_aff = TI.arr_to_g1_affine if field == "g1" else TI.arr_to_g2_affine
        for i, k in enumerate(sks):
            assert to_aff(out[i]) == group.mul(base[i], k), (field, i)
    tw = _twist_point()
    pts = TI.g2_affine_to_jacobian_arr(tw)[None]
    h2 = torch.tensor(_bits(C.H2, C.H2.bit_length()), dtype=torch.int32)
    assert h2.shape == (507,)
    out = _host_ladder(host_lib, "g2", pts, h2, "forward")
    assert TI.arr_to_g2_affine(out[0]) == g2.mul(tw, C.H2)


def _twist_point():
    """A point of the twist outside G2, as the host's map to the twist
    gives them: the first x = (k, 1) with x^3 + b a square."""
    for k in range(1, 100):
        x = (k, 1)
        y = RF.fp2_sqrt(RF.fp2_add(RF.fp2_mul(RF.fp2_sqr(x), x), g2.b))
        if y is not None:
            return (x, y)
    raise AssertionError("no twist point")


def _sum_inputs(field):
    """Five points (padded to 8): a point twice (the doubling), a point
    and its negative (infinity), a point at infinity; masks of every,
    none, one point, the two equal ones, and words other than 0 and 1."""
    group = g1 if field == "g1" else g2
    pts = _points(field, 5)
    pts[3] = pts[0]
    pts[4] = group.neg(pts[2])
    points = _doubled(field, pts)
    masks = torch.tensor([[1, 1, 1, 1, 1], [0, 0, 0, 0, 0], [0, 0, 1, 0, 0],
                          [1, 0, 0, 1, 0], [1, 2, 1, -1, 0], [1, 1, 1, 0, 1]],
                         dtype=torch.int32)
    return points, masks


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("field", sorted(_FIELDS))
def test_masked_sum_equals_the_plain_version(host_lib, field, order):
    code, ops, tail = _FIELDS[field]
    points, masks = _sum_inputs(field)
    pts = np.ascontiguousarray(points.numpy())
    for n in (5, 1, 0):
        for mask in masks:
            m = np.ascontiguousarray(mask[:n].numpy())
            out = np.zeros(tail, dtype=np.int32)
            assert host_lib.host_masked_sum(code, _ptr(pts), _ptr(m), n,
                                            _ptr(out), _ORDERS[order]) == 0
            want = TCV.masked_sum_reference(points[:n], mask[:n], ops)
            np.testing.assert_array_equal(out, want.numpy(), err_msg=str(
                (n, mask.tolist())))


def _trace(lib, field, point, bits):
    """(hash, [products, adds and subs of the product tasks, of the
    phases of adds], the point) of the ladder on one lane."""
    code, _, tail = _FIELDS[field]
    b = np.asarray(bits, dtype=np.int32)
    h = np.zeros(1, dtype=np.uint64)
    counts = np.zeros(3, dtype=np.int64)
    out = np.zeros(tail, dtype=np.int32)
    pt = np.ascontiguousarray(point.numpy())
    lib.host_trace(code, _ptr(pt), _ptr(b), len(bits), _ptr(h),
                   _ptr(counts), _ptr(out))
    return int(h[0]), counts.tolist(), out


def test_the_ladder_runs_the_same_products_for_every_scalar(host_lib):
    """A scalar of all zeros, one of all ones and a random one: the same
    phases, tasks and product elements in the same order (one hash of the
    sequence), the same count of products, the setup's 2 and 21 a step
    over Fp, 7 and 76 over Fp2, and each the plain version's point."""
    for field, (_, ops, _) in _FIELDS.items():
        point = _doubled(field, _points(field, 3)[:1])[0]
        seen = set()
        for bits in ([0] * 16, [1] * 16, [rng.randrange(2) for _ in range(16)]):
            h, counts, out = _trace(host_lib, field, point, bits)
            assert counts[0] == (_SETUP_PRODUCTS[field]
                                 + 16 * _STEP_PRODUCTS[field])
            np.testing.assert_array_equal(
                out, TCV.scalar_mul_reference(
                    point, torch.tensor(bits, dtype=torch.int32),
                    ops).numpy())
            seen.add(h)
        assert len(seen) == 1, field


@pytest.mark.parametrize("field", sorted(_FIELDS))
def test_the_ladders_product_tasks_only_load_their_operands(host_lib, field):
    """Every product task of the ladder loads its two operands and makes
    no modular add or sub (phases.cuh's counted add, sub, add_lazy,
    sub_lazy), in the setup and in every step; the phases of adds make
    them all, the same number a step whatever the bits."""
    point = _doubled(field, _points(field, 3)[:1])[0]
    linear = set()
    for bits in ([0] * 8, [1] * 8, [rng.randrange(2) for _ in range(8)]):
        _, (products, product_ops, linear_ops), _ = _trace(
            host_lib, field, point, bits)
        assert products == _SETUP_PRODUCTS[field] + 8 * _STEP_PRODUCTS[field]
        assert product_ops == 0
        linear.add(linear_ops)
    assert len(linear) == 1 and linear.pop() > 0


def test_scratch_and_threads_fit_the_kernels(host_lib):
    """What the kernels' sources state: a lane's scratch area of 53 and
    139 elements (2,544 and 6,672 B) on 32 and 64 threads, 12 phases a
    step (six rounds of products, each followed by a phase of adds), an
    add's of 54 elements over Fp and 144 over Fp2 (6,912 B), so that a
    block's 2 adds and the table of 128 words take 14,340 B of static
    shared memory with the block's flag."""
    got = {}
    for field, (code, _, _) in _FIELDS.items():
        out = np.zeros(4, dtype=np.int32)
        host_lib.host_sizes(code, _ptr(out))
        got[field] = tuple(out)
    assert got == {"g1": (53, 32, 54, 12), "g2": (139, 64, 144, 12)}
    elem = 48
    assert 2 * 144 * elem + 128 * 4 + 4 == 14340


def test_the_timed_build_takes_the_kernels_arguments_and_no_launch():
    """kernels/scalar_mul.py phase_clocks, the ladders' timed build: its
    record's size is the source's, its entry points take the kernels'
    arguments and the record, and off the card it raises as the kernels
    do, counting no launch."""
    from harmony_tpu_torch.kernels import scalar_mul as KS

    src = (_build.CSRC / "scalar_mul.cu").read_text()
    assert f"constexpr int kMaxPhases = {KS.MAX_PHASES};" in src
    assert "clocks (int64,\n// 4 + 2 kMaxPhases words)" in src
    assert KS.CLOCK_WORDS == 4 + 2 * KS.MAX_PHASES == 52
    for name in ("scalar_mul_g1", "scalar_mul_g2"):
        timed = _build._ENTRY_POINTS[f"harmony_{name}_phases"]
        plain = _build._ENTRY_POINTS[f"harmony_{name}"]
        assert timed == [ctypes.c_void_p] + plain
    before = dict(KS.LAUNCHES)
    meta = {"device": "meta", "dtype": torch.int32}
    for name, tail in (("scalar_mul_g1", (3, 32)),
                       ("scalar_mul_g2", (3, 2, 32))):
        for device in ("cpu", "meta"):
            pts = torch.zeros(2, *tail, dtype=torch.int32, device=device)
            bits = torch.zeros(255, dtype=torch.int32, device=device)
            with pytest.raises(ValueError, match="CUDA"):
                KS.phase_clocks(name, pts, bits)
        with pytest.raises(TypeError, match="int32"):
            KS.phase_clocks(name, torch.empty(2, *tail, device="meta"),
                            torch.empty(255, **meta))
    assert KS.LAUNCHES == before
