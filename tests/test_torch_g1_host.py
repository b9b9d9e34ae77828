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
// split product.
extern "C" void host_g1_masked_sum(const int32_t* points, const int32_t* mask,
                                   int32_t* out, int32_t* affine, int64_t n,
                                   int coords, int64_t lanes, int order) {
  const int size = g1::leaves(n);
  const HostMul mul{order == 1};
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
      for (int q = 0; q < half; ++q) {
        const int k = order ? half - 1 - q : q;
        uint32_t sum[kPoint];
        g1::add(mul, HostAny{}, &s[k * kPoint], &s[(k + half) * kPoint], sum);
        for (int j = 0; j < kPoint; ++j) s[k * kPoint + j] = sum[j];
      }
    }
    for (int c = 0; c < 3; ++c) {
      store_words(&s[c * kWords], out + (lane * 3 + c) * fp384::kLimbs);
    }
    uint32_t zi[kWords], xy[2 * kWords];
    fp384::inv(&s[2 * kWords], zi);
    g1::affine(mul, s.data(), zi, xy);
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
