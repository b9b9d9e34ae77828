"""The masked G1 sum kernel's plan and the GCD inversion, on the CPU.

``harmony_tpu_torch/csrc/g1.cuh`` holds one lane's plan of
``g1_masked_sum.cu`` (the leaves, the add-2007-bl add with its doubling
and selects, the affine form) and ``csrc/fp384.cuh`` the binary extended
GCD that inverts Z there and in ``fp_inv.cu``.  Outside nvcc both are
plain C++, so here g++ compiles them through a small host harness, with
the header the kernel build generates, and ctypes loads the result.  The
harness runs a lane as the kernel does: the leaves, then each level's
adds (point k + half into point k, in place), forward with the one-thread
product, or in reverse with the split product's threads run step by step
(``HOST_RUNNER``); then the inversion and the affine form.

The sum and its affine form must equal the port's plain versions
(``ops/curve.py`` ``masked_sum_reference`` and ``to_affine``) bit for bit
(tolerance 0: a Jacobian point's limbs depend on the formula, and the
kernel keeps the reference's), on committees with a repeated key (the
doubling), a key and its negative (infinity), a pad row (0, 0), masks of
no, every and one key, mask words other than 0 and 1, affine and
Jacobian inputs, the (N, B) form, and the mainnet shape.  The inverse
must equal the plain Fermat chain (``ops/fp.py`` ``inv_reference``) and
Python's ``pow``.  Without g++ the tests skip.
"""

import ctypes
import random
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import fp as TFP
from harmony_tpu_torch.ops.limbs import ints_to_limbs
from harmony_tpu_torch.ref.curve import G1_GEN, g1
from harmony_tpu_torch.ref.params import R_ORDER
from test_torch_fp import _CARRY_VECTORS, P
from test_torch_fp12_host import HOST_RUNNER

R = 1 << 384

_HOST_SRC = HOST_RUNNER + r"""
#include "g1.cuh"

using fp384::kWords;
using g1::kPoint;

namespace {

// The product on a group: the one-thread product, or the split product's
// threads run step by step in reverse.
struct HostMul {
  bool split;

  void operator()(const uint32_t* a, const uint32_t* b, uint32_t* out) const {
    uint32_t x[kWords], y[kWords], r[kWords];
    for (int j = 0; j < kWords; ++j) {
      x[j] = a[j];
      y[j] = b[j];
    }
    if (split) {
      host::split_mul(x, y, r, true);
    } else {
      fp384::mont_mul(x, y, r);
    }
    for (int j = 0; j < kWords; ++j) out[j] = r[j];
  }
};

struct HostAny {
  bool operator()(bool c) const { return c; }
};

// The kernel's form of an add: a program's rounds (g1.cuh), each round's
// products with the split product's threads run step by step, forward,
// in reverse, or isolated (every product's operands formed from the slots
// as the round found them, then every store).
struct HostRounds {
  bool ones;
  const uint32_t *p1, *p2;
  uint32_t* sc;
  int order;  // 0 forward, 1 reverse, 2 isolated

  void operator()(int prog) const {
    for (int i = 0; i < g1::rounds(prog); ++i) {
      const int lo = g1::round_start(prog, i);
      const int hi = g1::round_start(prog, i + 1);
      std::vector<uint32_t> got((hi - lo) * kWords);
      for (int q = 0; q < hi - lo; ++q) {
        const int j = order == 1 ? hi - 1 - q : lo + q;
        const int k = g1::product_slot(prog, j);
        uint32_t x[kWords], y[kWords], r[kWords];
        g1::operands(prog, k, ones, p1, p2, sc, x, y);
        host::split_mul(x, y, r, order == 1);
        for (int w = 0; w < kWords; ++w) {
          if (order == 2) {
            got[(j - lo) * kWords + w] = r[w];
          } else {
            sc[k * kWords + w] = r[w];
          }
        }
      }
      if (order == 2) {
        for (int j = lo; j < hi; ++j) {
          const int k = g1::product_slot(prog, j);
          for (int w = 0; w < kWords; ++w) {
            sc[k * kWords + w] = got[(j - lo) * kWords + w];
          }
        }
      }
    }
  }
};

// A binary extended GCD one subtraction at a time (each step a 12-word
// subtraction, a modular subtraction and the stripping of factors of 2):
// an independent reference for fp384::inv.
namespace stepwise {

using namespace fp384;

// out = a - b mod 2^384, and the borrow (1 iff a < b): one PTX
// sub.cc/subc.cc chain on the card, sub_words under g++.  out may be a or
// b.
FP384_FN uint32_t sub_chain(const uint32_t a[kWords], const uint32_t b[kWords],
                            uint32_t out[kWords]) {
#if defined(__CUDA_ARCH__)
  uint32_t borrow;
  FP384_CHAIN("sub.cc.u32", out[0], a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("subc.cc.u32", out[j], a[j], b[j]);
  }
  FP384_CHAIN("subc.u32", borrow, 0u, 0u);  // all ones iff a < b
  return borrow & 1u;
#else
  return sub_words(a, b, out);
#endif
}

// out = a + b mod 2^384 (the carry out falls away), as sub_chain.
FP384_FN void add_chain(const uint32_t a[kWords], const uint32_t b[kWords],
                        uint32_t out[kWords]) {
#if defined(__CUDA_ARCH__)
  FP384_CHAIN("add.cc.u32", out[0], a[0], b[0]);
#pragma unroll
  for (int j = 1; j < kWords; ++j) {
    FP384_CHAIN("addc.cc.u32", out[j], a[j], b[j]);
  }
#else
  add_words(a, b, out);
#endif
}

// x = (x - y) mod p for canonical x, y: where x - y borrowed, adding p
// lands in [0, p).
FP384_FN void sub_mod(uint32_t x[kWords], const uint32_t y[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  const uint32_t mask = 0u - sub_chain(x, y, x);
  uint32_t q[kWords];
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) q[j] = p[j] & mask;
  add_chain(x, q, x);
}

FP384_FN int ctz(uint32_t w) {  // w != 0
#if defined(__CUDA_ARCH__)
  return __ffs(w) - 1;
#else
  return __builtin_ctz(w);
#endif
}

// v = v / 2^k for 1 <= k <= 32, the words above v's top being 0.
FP384_FN void shift_down(uint32_t v[kWords], int k) {
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    const uint64_t hi = j + 1 < kWords ? v[j + 1] : 0u;
    v[j] = static_cast<uint32_t>((hi << 32 | v[j]) >> k);
  }
}

// x = x 2^-k mod p for canonical x and 1 <= k <= 32: m = x (-p^-1) mod
// 2^k makes x + m p divisible by 2^k (a k-bit step of Montgomery's
// reduction), and (x + m p) / 2^k < p (1 + 2^k) / 2^k < 2p, so one
// conditional subtraction makes it canonical.
FP384_FN void div_pow2(uint32_t x[kWords], int k) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  const uint32_t m = x[0] * kPInv & (k == 32 ? ~0u : (1u << k) - 1u);
  uint32_t t[kWords];
  uint64_t c = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    c += static_cast<uint64_t>(x[j]) + static_cast<uint64_t>(m) * p[j];
    t[j] = static_cast<uint32_t>(c);
    c >>= 32;
  }
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    const uint64_t hi = j + 1 < kWords ? t[j + 1] : c;
    t[j] = static_cast<uint32_t>((hi << 32 | t[j]) >> k);
  }
  uint32_t d[kWords];
  const uint32_t borrow = sub_chain(t, p, d);
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) x[j] = borrow ? t[j] : d[j];
}

// v odd, keeping x a = v (mod p): divide v by its factors of 2 and x by
// as many.  v != 0.
FP384_FN void strip_twos(uint32_t v[kWords], uint32_t x[kWords]) {
  FP384_ROLLED
  while (v[0] == 0) {
    shift_down(v, 32);
    div_pow2(x, 32);
  }
  const int k = ctz(v[0]);
  if (k) {
    shift_down(v, k);
    div_pow2(x, k);
  }
}

// a^-1 in the Montgomery domain (the inverse of a R is a^-1 R) for
// canonical a, with inv(0) = 0.  Binary extended Euclid on the plain
// value A = a R: u = A and v = p, with coefficients x = 1 and y = 0 kept
// so that x A = u and y A = v (mod p).  Both stay odd after their factors of 2
// are stripped; each step subtracts the smaller from the larger (and its
// coefficient from the other's, mod p) and strips the difference's
// factors of 2, dividing the coefficient by as many (div_pow2).  The gcd
// is 1, so u and v meet at 1, and then x = A^-1 = a^-1 R^-1: one
// Montgomery product by R^3 gives a^-1 R.  For BLS12-381's p: 268
// subtractions on average over random inputs (at most about 300), each a
// 12-word subtraction, a modular subtraction and a shift by about 2 bits.
// The inverse is unique, so the limbs are those of the plain Fermat chain
// (ops/fp.py inv_reference).
FP384_FN void inv(const uint32_t a[kWords], uint32_t out[kWords]) {
  constexpr uint32_t p[kWords] = {HARMONY_P_WORDS};
  constexpr uint32_t r3[kWords] = {HARMONY_R3_WORDS};
  uint32_t u[kWords], v[kWords], x[kWords], y[kWords], d[kWords];
  uint32_t any = 0;
  FP384_UNROLL
  for (int j = 0; j < kWords; ++j) {
    u[j] = a[j];
    v[j] = p[j];
    x[j] = j == 0;
    y[j] = 0;
    any |= a[j];
  }
  if (!any) {
    FP384_UNROLL
    for (int j = 0; j < kWords; ++j) out[j] = 0;
    return;
  }
  strip_twos(u, x);
  FP384_ROLLED
  for (;;) {
    if (!sub_chain(u, v, d)) {  // u >= v
      uint32_t nonzero = 0;
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) nonzero |= d[j];
      if (!nonzero) break;  // u = v = 1
      FP384_UNROLL
      for (int j = 0; j < kWords; ++j) u[j] = d[j];
      sub_mod(x, y);
      strip_twos(u, x);
    } else {
      sub_chain(v, u, v);
      sub_mod(y, x);
      strip_twos(v, y);
    }
  }
  mont_mul(x, r3, out);
}

}  // namespace stepwise

void load_words(const int32_t* src, uint32_t* w) {
  uint32_t l[fp384::kLimbs];
  for (int k = 0; k < fp384::kLimbs; ++k) l[k] = static_cast<uint32_t>(src[k]);
  fp384::pack(l, w);
}

void store_words(const uint32_t* w, int32_t* dst) {
  uint32_t l[fp384::kLimbs];
  fp384::unpack(w, l);
  for (int k = 0; k < fp384::kLimbs; ++k) dst[k] = static_cast<int32_t>(l[k]);
}

}  // namespace

// g1_masked_sum.cu's lane, lane after lane: order 0 runs each level's
// adds forward with the one-thread product, order 1 in reverse with the
// split product, both by the sequential add; orders 2, 3, 4 run the
// kernel's form, add_in_rounds on a scratch area poisoned for each add
// (each level's adds forward, in reverse and forward, each round's
// products forward, in reverse, isolated), and the affine form in rounds.
extern "C" void host_g1_masked_sum(const int32_t* points, const int32_t* mask,
                                   int32_t* out, int32_t* affine, int64_t n,
                                   int coords, int64_t lanes, int order) {
  const int size = g1::leaves(n);
  const HostMul mul{order == 1};
  const bool rounds = order >= 2;
  std::vector<uint32_t> sc(g1::kSlots * kWords);
  for (int64_t lane = 0; lane < lanes; ++lane) {
    std::vector<uint32_t> s(size * kPoint);
    for (int i = 0; i < size; ++i) {
      uint32_t pt[kPoint] = {};
      const bool on = i < n && mask[i * lanes + lane] == 1;
      if (on) {
        for (int c = 0; c < coords; ++c) {
          load_words(points + (i * coords + c) * fp384::kLimbs,
                     pt + c * kWords);
        }
      }
      g1::leaf(on, coords == 2, pt);
      for (int j = 0; j < kPoint; ++j) s[i * kPoint + j] = pt[j];
    }
    for (int half = size / 2; half >= 1; half /= 2) {
      const bool ones = coords == 2 && half == size / 2;
      for (int q = 0; q < half; ++q) {
        const int k = order % 2 ? half - 1 - q : q;
        const uint32_t *p1 = &s[k * kPoint], *p2 = &s[(k + half) * kPoint];
        uint32_t sum[kPoint];
        if (rounds) {
          host::poison(sc);
          const g1::Flags f = g1::add_in_rounds(
              HostRounds{ones, p1, p2, sc.data(), order - 2}, HostAny{}, ones,
              p1, p2, sc.data());
          for (int e = 0; e < 3; ++e) {
            g1::result(e, ones, f, p1, p2, sc.data(), sum + e * kWords);
          }
        } else {
          g1::add(mul, HostAny{}, p1, p2, sum);
        }
        for (int j = 0; j < kPoint; ++j) s[k * kPoint + j] = sum[j];
      }
    }
    for (int c = 0; c < 3; ++c) {
      store_words(&s[c * kWords], out + (lane * 3 + c) * fp384::kLimbs);
    }
    uint32_t zi[kWords], xy[2 * kWords];
    fp384::inv(&s[2 * kWords], zi);
    if (rounds) {
      host::poison(sc);
      HostRounds{false, s.data(), zi, sc.data(), order - 2}(g1::kAffine);
      const bool inf = g1::is_zero(g1::Z(s.data()));
      for (int j = 0; j < 2 * kWords; ++j) {
        xy[j] = inf ? 0u : sc[2 * kWords + j];
      }
    } else {
      g1::affine(mul, s.data(), zi, xy);
    }
    for (int c = 0; c < 2; ++c) {
      store_words(xy + c * kWords, affine + (lane * 2 + c) * fp384::kLimbs);
    }
  }
}

extern "C" void host_fp_inv(const int32_t* a, int32_t* out, int64_t rows) {
  for (int64_t r = 0; r < rows; ++r) {
    uint32_t w[kWords], z[kWords];
    load_words(a + r * fp384::kLimbs, w);
    fp384::inv(w, z);
    store_words(z, out + r * fp384::kLimbs);
  }
}

// Rows inverted by fp384::inv (how 0, with its batches into batches; how
// 2 its four threads stepped in reverse) or by the stepwise binary GCD
// (how 1).
extern "C" void host_fp_inv_by(const int32_t* a, int32_t* out,
                               int32_t* batches, int64_t rows, int how) {
  for (int64_t r = 0; r < rows; ++r) {
    uint32_t w[kWords], z[kWords];
    load_words(a + r * fp384::kLimbs, w);
    if (how == 1) {
      stepwise::inv(w, z);
    } else {
      batches[r] = fp384::inv(w, z, how == 2);
    }
    store_words(z, out + r * fp384::kLimbs);
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of g1.cuh needs a "
                    "C++17 compiler")
    tmp = tmp_path_factory.mktemp("g1_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "g1_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "g1_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.host_g1_masked_sum.argtypes = [ptr] * 4 + [i64, i32, i64, i32]
    lib.host_g1_masked_sum.restype = None
    lib.host_fp_inv.argtypes = [ptr, ptr, i64]
    lib.host_fp_inv.restype = None
    lib.host_fp_inv_by.argtypes = [ptr, ptr, ptr, i64, i32]
    lib.host_fp_inv_by.restype = None
    return lib


def _ptr(x):
    return x.ctypes.data


def _host_sum(lib, points, mask, order):
    """The harness on points (N, [1,] C, 32) and mask (N[, B])."""
    points = np.ascontiguousarray(points, dtype=np.int32)
    mask = np.ascontiguousarray(mask, dtype=np.int32)
    lanes = mask.shape[1:]
    n_lanes = int(np.prod(lanes, dtype=np.int64))
    out = np.empty((*lanes, 3, 32), np.int32)
    aff = np.empty((*lanes, 2, 32), np.int32)
    lib.host_g1_masked_sum(_ptr(points), _ptr(mask), _ptr(out), _ptr(aff),
                           len(points), points.shape[-2], n_lanes, order)
    return out, aff


def _plain(points, mask):
    """masked_sum_reference and to_affine on CPU tensors."""
    pts = torch.from_numpy(np.ascontiguousarray(points))
    m = torch.from_numpy(np.ascontiguousarray(mask))
    jac = TCV.affine_to_jacobian_g1(pts) if pts.shape[-2] == 2 else pts
    out = TCV.masked_sum_reference(jac, m, TCV.FP_OPS)
    ax, ay = TCV.to_affine(out, TCV.FP_OPS)
    return out.numpy(), torch.stack([ax, ay], dim=-2).numpy()


def _mont(xs):
    return ints_to_limbs([x * R % P for x in xs])


def _tables(affine_pts, seed):
    """(affine (N, 2, 32), Jacobian (N, 3, 32) with random Z) of reference
    points; None is the pad row (0, 0), and (0, 0, 0) in Jacobian form."""
    rng = random.Random(seed)
    aff, jac = [], []
    for pt in affine_pts:
        if pt is None:
            aff.append(_mont([0, 0]))
            jac.append(_mont([0, 0, 0]))
            continue
        x, y = pt
        z = rng.randrange(1, P)
        aff.append(_mont([x, y]))
        jac.append(_mont([x * z * z % P, y * z * z * z % P, z]))
    return np.stack(aff), np.stack(jac)


_ORDERS = {"forward": 0, "reverse_split": 1}
# the kernel's form, add_in_rounds: each round's products forward, in
# reverse (and each level's adds), isolated
_ROUND_ORDERS = {"rounds_forward": 2, "rounds_reverse": 3,
                 "rounds_isolated": 4}
_rng = random.Random(0x61)
_A, _B, _D, _E = (g1.mul(G1_GEN, _rng.randrange(1, R_ORDER))
                  for _ in range(4))
# bucket 8: A three times, B and -B, a pad row (0, 0)
_TABLE8 = _tables([_A, _B, _A, _D, _A, g1.neg(_B), _E, None], seed=8)
_MASKS8 = {
    "none": [0, 0, 0, 0, 0, 0, 0, 0],
    "all": [1, 1, 1, 1, 1, 1, 1, 1],
    "one_key": [0, 0, 0, 1, 0, 0, 0, 0],
    "p_plus_p": [1, 0, 0, 0, 1, 0, 0, 0],  # A + A at the first level
    "p_plus_p_later": [1, 0, 1, 0, 0, 0, 0, 0],  # A + A at the second
    "p_minus_p": [0, 1, 0, 0, 0, 1, 0, 0],  # B + (-B)
    "pad_row": [0, 0, 1, 0, 0, 0, 0, 1],
    "pad_row_alone": [0, 0, 0, 0, 0, 0, 0, 1],
    "other_words": [2, 1, -1, 1, 0, 255, 1, 0],  # only 1 selects
}
_FORMS = {"affine": 0, "jacobian": 1}


@pytest.fixture(scope="module")
def plain8():
    """Every bucket-8 mask as one lane of one (N, B) plain sum, per form."""
    masks = np.array(list(_MASKS8.values()), np.int32).T  # (8, B)
    return {form: _plain(_TABLE8[i][:, None], masks)
            for form, i in _FORMS.items()}


@pytest.mark.parametrize("order", sorted(_ORDERS))
@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("case", sorted(_MASKS8))
def test_lane_plan_equals_the_plain_sum_at_bucket_8(host_lib, plain8, case,
                                                    form, order):
    lane = list(_MASKS8).index(case)
    out, aff = _host_sum(host_lib, _TABLE8[_FORMS[form]],
                         np.array(_MASKS8[case]), _ORDERS[order])
    np.testing.assert_array_equal(out, plain8[form][0][lane])
    np.testing.assert_array_equal(aff, plain8[form][1][lane])


def test_the_cases_hit_doubling_infinity_and_the_pad_row(plain8):
    """The bucket-8 sums are the group's: A + A is 2A, B + (-B) and no key
    are infinity, the pad row alone is (0, 0, 0)."""
    from harmony_tpu_torch.ops.interop import arr_to_g1_affine

    out = dict(zip(_MASKS8, plain8["jacobian"][0]))
    assert arr_to_g1_affine(out["p_plus_p"]) == g1.dbl(_A)
    assert arr_to_g1_affine(out["p_plus_p_later"]) == g1.dbl(_A)
    assert arr_to_g1_affine(out["p_minus_p"]) is None
    assert arr_to_g1_affine(out["none"]) is None
    assert not out["pad_row_alone"].any()
    assert arr_to_g1_affine(out["other_words"]) == g1.add(
        g1.add(_B, _D), _E)


@pytest.mark.parametrize("form", sorted(_FORMS))
def test_lane_plan_equals_the_plain_sum_on_an_n_by_b_mask(host_lib, form):
    """The (N, B) form with B = 3: one table, affine or Jacobian, for
    every lane."""
    names = ("all", "p_plus_p", "p_minus_p")
    masks = np.array([_MASKS8[k] for k in names], np.int32).T  # (8, 3)
    table = _TABLE8[_FORMS[form]][:, None]
    want = _plain(table, masks)
    for order in _ORDERS.values():
        got = _host_sum(host_lib, table, masks, order)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 5])
def test_lane_plan_pads_short_committees(host_lib, n):
    """No key, one key, and five keys padded to eight with infinity."""
    table = _TABLE8[1][:n]
    mask = np.array(_MASKS8["all"][:n], np.int32)
    for order in _ORDERS.values():
        got = _host_sum(host_lib, table, mask, order)
        want = _plain(table, mask)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_lane_plan_equals_the_plain_sum_at_mainnet_width(host_lib):
    """200 keys in bucket 256 (56 pad rows), 150 of them signed."""
    rng = random.Random(0x200)
    step = g1.mul(G1_GEN, rng.randrange(1, R_ORDER))
    keys = [g1.mul(G1_GEN, rng.randrange(1, R_ORDER))]
    for _ in range(199):
        keys.append(g1.add(keys[-1], step))
    aff, jac = _tables(keys + [None] * 56, seed=256)
    mask = np.zeros(256, np.int32)
    mask[rng.sample(range(200), 150)] = 1
    for table, order in ((aff, 0), (jac, 1)):
        out, xy = _host_sum(host_lib, table, mask, order)
        want = _plain(table, mask)
        np.testing.assert_array_equal(out, want[0])
        np.testing.assert_array_equal(xy, want[1])


def _inverse_cases():
    carry = sorted({x for xs, ys in _CARRY_VECTORS.values() for x in xs + ys})
    return ([0, 1, P - 1, R % P, (R * R) % P] + [1 << k for k in range(0, 381,
                                                                        20)]
            + carry)


def test_inverse_equals_the_plain_chain_and_pow_on_edges(host_lib):
    """0, 1, p - 1, 2^k, R mod p and the carry vectors, as Montgomery
    limbs, against inv_reference and pow."""
    xs = _inverse_cases()
    a = _mont(xs)
    got = np.empty_like(a)
    host_lib.host_fp_inv(_ptr(a), _ptr(got), len(a))
    np.testing.assert_array_equal(
        got, TFP.inv_reference(torch.from_numpy(a)).numpy())
    np.testing.assert_array_equal(
        got, _mont([pow(x, P - 2, P) for x in xs]))


def test_inverse_equals_pow_on_seeded_rows(host_lib):
    """4,096 seeded rows (the raw limbs: any canonical value) against
    pow; x (x^-1) = 1."""
    rng = random.Random(0x4096)
    xs = [rng.randrange(P) for _ in range(4096)]
    a = ints_to_limbs(xs)
    got = np.empty_like(a)
    host_lib.host_fp_inv(_ptr(a), _ptr(got), len(a))
    # limbs x hold x R^-1 in the Montgomery domain: the inverse is x^-1 R^2
    np.testing.assert_array_equal(
        got, ints_to_limbs([pow(x, P - 2, P) * R * R % P for x in xs]))


@pytest.mark.parametrize("order", sorted(_ROUND_ORDERS))
@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("case", sorted(_MASKS8))
def test_rounds_equal_the_sequential_add_at_bucket_8(host_lib, plain8, case,
                                                     form, order):
    """The kernel's form (add_in_rounds: add-2007-bl in 5 rounds, 3 on the
    first level of the affine table, whose Z are 1; the doubling in 3;
    the affine form in 2), each round's products forward, in reverse and
    isolated, equals the sequential g1::add and the plain sum on the
    doubling, the opposite point, infinity and the pad row."""
    lane = list(_MASKS8).index(case)
    table, mask = _TABLE8[_FORMS[form]], np.array(_MASKS8[case])
    got = _host_sum(host_lib, table, mask, _ROUND_ORDERS[order])
    want = _host_sum(host_lib, table, mask, _ORDERS["forward"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], plain8[form][0][lane])
    np.testing.assert_array_equal(got[1], plain8[form][1][lane])


@pytest.fixture(scope="module")
def mainnet_runs(host_lib):
    """Lanes of the kernel's shapes, each with the sequential add's sum
    and affine form: 200 keys in bucket 256 (56 pad rows), 150 of them
    signed, affine (the first level's adds of Z = 1) and Jacobian; an
    (N, B) mask of 3 lanes, affine and Jacobian; committees of 0, 1 and 5
    keys."""
    rng = random.Random(0x201)
    step = g1.mul(G1_GEN, rng.randrange(1, R_ORDER))
    keys = [g1.mul(G1_GEN, rng.randrange(1, R_ORDER))]
    for _ in range(199):
        keys.append(g1.add(keys[-1], step))
    aff, jac = _tables(keys + [None] * 56, seed=257)
    mask = np.zeros(256, np.int32)
    mask[rng.sample(range(200), 150)] = 1
    runs = [(aff, mask), (jac, mask)]
    masks3 = np.array([_MASKS8[k] for k in ("all", "p_plus_p", "p_minus_p")],
                      np.int32).T
    runs += [(_TABLE8[i][:, None], masks3) for i in (0, 1)]
    runs += [(_TABLE8[1][:n], np.array(_MASKS8["all"][:n], np.int32))
             for n in (0, 1, 5)]
    return [(table, m, _host_sum(host_lib, table, m, _ORDERS["forward"]))
            for table, m in runs]


@pytest.mark.parametrize("order", sorted(_ROUND_ORDERS))
def test_rounds_equal_the_sequential_add_at_mainnet_width(host_lib,
                                                          mainnet_runs,
                                                          order):
    """The kernel's form equals the sequential add (which equals the plain
    sum: test_lane_plan_equals_the_plain_sum_at_mainnet_width) at mainnet
    width, on the (N, B) form and on short committees."""
    for table, m, want in mainnet_runs:
        got = _host_sum(host_lib, table, m, _ROUND_ORDERS[order])
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _inv_by(lib, a, how):
    out = np.empty_like(a)
    batches = np.zeros(len(a), np.int32)
    lib.host_fp_inv_by(_ptr(a), _ptr(out), _ptr(batches), len(a), how)
    return out, batches


@pytest.mark.parametrize("case", ["edges", "seeded"])
def test_batched_inverse_equals_the_stepwise_gcd_and_pow(host_lib, case):
    """fp384::inv (Pornin's batches of 30 steps, its four threads stepped
    forward and in reverse) against the stepwise binary GCD and pow(x, p - 2)
    on 0, 1, p - 1, R mod p, powers of 2 and 200 seeded rows; its batch
    count against the smoke's model of it, which the bound counts, and
    within the 26 batches that BLS12-381's p needs at most."""
    import chip_smoke

    if case == "edges":
        xs = [0, 1, 2, P - 1, P - 2, R % P] + [1 << k for k in range(381)]
    else:
        rng = random.Random(0x1200)
        xs = [rng.randrange(P) for _ in range(200)]
    a = ints_to_limbs(xs)
    got, batches = _inv_by(host_lib, a, 0)
    np.testing.assert_array_equal(got, _inv_by(host_lib, a, 1)[0])
    np.testing.assert_array_equal(got, _inv_by(host_lib, a, 2)[0])
    np.testing.assert_array_equal(
        got, ints_to_limbs([pow(x, P - 2, P) * R * R % P for x in xs]))
    assert batches.tolist() == [chip_smoke.inv_batches(x) for x in xs]
    assert batches.max() <= 26
