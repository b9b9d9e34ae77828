"""The CUDA kernels' own arithmetic, on the CPU.

``harmony_tpu_torch/csrc/fp384.cuh`` holds the word arithmetic that
``mont_mul.cu`` and ``fp_addsub.cu`` run on the card.  Its functions are
plain C++ outside nvcc, so here g++ compiles them through a small host
file, with the modulus header the kernel build generates, and ctypes
loads the result.  Its mont_mul, add, sub and neg must equal the port's
plain PyTorch versions bit for bit (tolerance 0: exact integer work with
unique canonical limbs), on the worst-case vectors of
tests/test_torch_fp.py and on seeded random rows.  Without g++ the tests
skip.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from harmony_tpu_torch.kernels import _build
from harmony_tpu_torch.ops import fp as tfp
from harmony_tpu_torch.ops.limbs import limbs_to_int
from test_torch_fp import _CARRY_VECTORS, _PALLAS_CASES, P, _limbs

_HOST_SRC = r"""
#include <cstdint>

#include "fp384.cuh"

namespace {

void load(const int32_t* src, uint32_t w[fp384::kWords]) {
  uint32_t l[fp384::kLimbs];
  for (int k = 0; k < fp384::kLimbs; ++k) l[k] = static_cast<uint32_t>(src[k]);
  fp384::pack(l, w);
}

void store(const uint32_t w[fp384::kWords], int32_t* dst) {
  uint32_t l[fp384::kLimbs];
  fp384::unpack(w, l);
  for (int k = 0; k < fp384::kLimbs; ++k) dst[k] = static_cast<int32_t>(l[k]);
}

template <void (*op)(const uint32_t*, const uint32_t*, uint32_t*)>
void binary(const int32_t* a, const int32_t* b, int32_t* out, int64_t rows) {
  for (int64_t r = 0; r < rows; ++r) {
    uint32_t x[fp384::kWords], y[fp384::kWords], z[fp384::kWords];
    load(a + r * fp384::kLimbs, x);
    load(b + r * fp384::kLimbs, y);
    op(x, y, z);
    store(z, out + r * fp384::kLimbs);
  }
}

}  // namespace

extern "C" void host_mont_mul(const int32_t* a, const int32_t* b,
                              int32_t* out, int64_t rows) {
  binary<fp384::mont_mul>(a, b, out, rows);
}

extern "C" void host_add(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t rows) {
  binary<fp384::add>(a, b, out, rows);
}

extern "C" void host_sub(const int32_t* a, const int32_t* b, int32_t* out,
                         int64_t rows) {
  binary<fp384::sub>(a, b, out, rows);
}

extern "C" void host_neg(const int32_t* a, int32_t* out, int64_t rows) {
  for (int64_t r = 0; r < rows; ++r) {
    uint32_t x[fp384::kWords], z[fp384::kWords];
    load(a + r * fp384::kLimbs, x);
    fp384::neg(x, z);
    store(z, out + r * fp384::kLimbs);
  }
}
"""

_OPS = ("mont_mul", "add", "sub", "neg")
_PLAIN = {"mont_mul": tfp.mont_mul_reference, "add": tfp.add_reference,
          "sub": tfp.sub_reference, "neg": tfp.neg_reference}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of fp384.cuh "
                    "needs a C++17 compiler")
    tmp = tmp_path_factory.mktemp("fp384_host")
    header = tmp / "harmony_params.h"
    header.write_text(_build.params_header())
    src = tmp / "fp384_host.cpp"
    src.write_text(_HOST_SRC)
    so = tmp / "fp384_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-I", str(_build.CSRC), "-include", str(header),
                    "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True, timeout=120)
    lib = ctypes.CDLL(str(so))
    for op in _OPS:
        n_ptrs = 2 if op == "neg" else 3
        fn = getattr(lib, f"host_{op}")
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int64]
        fn.restype = None
    return lib


def _host(lib, op, *xs):
    xs = [np.ascontiguousarray(x, dtype=np.int32).reshape(-1, 32) for x in xs]
    out = np.empty_like(xs[0])
    getattr(lib, f"host_{op}")(*(x.ctypes.data for x in xs), out.ctypes.data,
                               out.shape[0])
    return out


def _random_rows(n=300, seed=0x384):
    """Seeded canonical rows, biased to the edges: 0, 1, p - 1, pairs with
    a + b = p exactly, a = b, and all-ones limb runs."""
    g = np.random.default_rng(seed)
    a = g.integers(0, 4096, size=(n, 32), dtype=np.int32)
    a[:, 31] = g.integers(0, 416, size=n)  # top limb below p's: a < p
    b = a[g.permutation(n)]
    edges = _limbs([0, 1, P - 1, (1 << 372) - 1])
    a[:4], b[4:8] = edges, edges
    b[8:40] = _limbs([(P - limbs_to_int(x)) % P for x in a[8:40]])  # a + b = p
    b[40:72] = a[40:72]  # a = b
    return a, b


def _cases():
    cases = {f"carry_{name}": (_limbs(xs), _limbs(ys))
             for name, (xs, ys) in _CARRY_VECTORS.items()}
    cases.update({f"pallas_{name}": (a, b)
                  for name, (a, b, _) in _PALLAS_CASES.items()})
    cases["random_300"] = _random_rows()
    return cases


_CASES = _cases()


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("op", _OPS)
def test_host_arithmetic_equals_the_plain_version(host_lib, op, case):
    a, b = _CASES[case]
    args = (a,) if op == "neg" else (a, b)
    want = _PLAIN[op](*(torch.from_numpy(np.ascontiguousarray(x))
                        for x in args)).numpy()
    got = _host(host_lib, op, *args).reshape(want.shape)
    np.testing.assert_array_equal(got, want)


def test_generated_constants_are_the_modulus():
    header = _build.params_header()
    words = [int(w, 16) for w in re.findall(
        r"0x([0-9a-f]{8})u", header.split("HARMONY_P_WORDS", 1)[1]
        .split("\n", 1)[0])]
    inv = int(re.search(r"HARMONY_P_INV32 0x([0-9a-f]{8})u", header)[1], 16)
    assert len(words) == 12
    assert sum(w << (32 * i) for i, w in enumerate(words)) == P
    assert (P * inv) % (1 << 32) == (1 << 32) - 1  # p (-p^-1) = -1 mod 2^32
