"""harmony_tpu_torch.ops.fp against the JAX package's ops.fp, bit for bit.

Inputs come from a seeded ``random``; both packages get the same limb
arrays through numpy.  Tolerance is 0 everywhere: the arithmetic is exact
integer work and the canonical limbs of a field element are unique.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops import _constants as JC
from harmony_tpu.ops import fp as jfp
from harmony_tpu.ops.fp_pallas import mont_mul_pallas
from harmony_tpu.ref import params as JP
from harmony_tpu_torch.kernels import fp_addsub as KA
from harmony_tpu_torch.kernels import fp_inv as KI
from harmony_tpu_torch.kernels import mont_mul as K
from harmony_tpu_torch.ops import _constants as TC
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import fp as tfp
from harmony_tpu_torch.ops import limbs as TL
from harmony_tpu_torch.ref import params as TP

P = JP.P
R = 1 << 384
rng = random.Random(0xF7)


def _limbs(xs):
    return np.stack([TL.int_to_limbs(x) for x in xs])


def _ints(arr):
    return [TL.limbs_to_int(row) for row in np.asarray(arr).reshape(-1, 32)]


def _same(t_out, j_out):
    """Port output (torch) equals JAX output, limb for limb."""
    t = t_out.numpy()
    j = np.asarray(j_out)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


# --- constants -------------------------------------------------------------

_CONST_NAMES = sorted(n for n in vars(JC) if n.isupper())


@pytest.mark.parametrize("name", _CONST_NAMES)
def test_constant_equals_jax_package(name):
    assert getattr(TC, name) == getattr(JC, name)


@pytest.mark.parametrize("name", ["X", "R_ORDER", "P", "TRACE", "H1", "B_G1",
                                  "XI", "H2", "G1_X", "G1_Y", "G2_X", "G2_Y"])
def test_ref_param_equals_jax_package(name):
    assert getattr(TP, name) == getattr(JP, name)


def test_module_constants_match_limb_tables():
    for t, j in ((tfp.P_LIMBS, jfp.P_LIMBS), (tfp.ONE_MONT, jfp.ONE_MONT),
                 (tfp.R2, jfp.R2)):
        _same(t, j)


# --- mont_mul: the cases of tests/test_ops_fp_pallas.py --------------------


def _pallas_cases():
    xs = [rng.randrange(P) for _ in range(150)]  # not a multiple of 128
    ys = [rng.randrange(P) for _ in range(150)]
    ragged = (_limbs([x * R % P for x in xs]), _limbs([y * R % P for y in ys]),
              [x * y * R % P for x, y in zip(xs, ys)])
    w = _limbs([(P - 1) * R % P] * 4)
    worst = (w, w, [(P - 1) * (P - 1) * R % P] * 4)
    zs = [rng.randrange(P) for _ in range(72)]
    sq = _limbs([z * R % P for z in zs]).reshape(2, 36, 32)
    nd = (sq, sq, [z * z * R % P for z in zs])
    return {"ragged_150": ragged, "p_minus_1_squared": worst,
            "nd_2x36": nd}


_PALLAS_CASES = _pallas_cases()


@pytest.mark.parametrize("case", sorted(_PALLAS_CASES))
def test_mont_mul_matches_scan_pallas_and_bigint(case):
    a, b, expect = _PALLAS_CASES[case]
    out = tfp.mont_mul(torch.from_numpy(a), torch.from_numpy(b))
    _same(out, jfp.mont_mul(jnp.asarray(a), jnp.asarray(b)))
    _same(out, mont_mul_pallas(jnp.asarray(a), jnp.asarray(b),
                               interpret=True))
    assert _ints(out) == expect


def test_mont_mul_broadcasts_a_constant_against_a_batch():
    xs = [rng.randrange(P) for _ in range(5)]
    am = tfp.to_mont(torch.from_numpy(_limbs(xs)))
    assert _ints(am) == [x * R % P for x in xs]
    _same(tfp.from_mont(am), _limbs(xs))


def test_cpu_tensors_take_the_plain_version_and_the_kernel_refuses_them():
    a = torch.from_numpy(_limbs([3, 5]))
    before = K.LAUNCHES
    _same(tfp.mont_mul(a, a), tfp.mont_mul_reference(a, a))
    assert K.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        K.mont_mul(a, a)


# --- add / sub / neg / inv on the worst-case carry vectors -----------------

# every vector set has 4 lanes: the JAX side compiles each op once
_XS = [rng.randrange(P) for _ in range(4)]
_CARRY_VECTORS = {
    "edges": ([0, 1, P - 1, P - 1], [0, P - 1, P - 1, 1]),
    "worst_mul": ([P - 1, P - 1, 1, 0], [P - 1, 1, P - 1, 0]),
    # limbs of all ones below the top: every carry ripples the full width
    "all_ones": ([(1 << 380) - 1, P - (1 << 12), P - 1, (1 << 372) - 1],
                 [1, (1 << 12), 1, P - (1 << 372)]),
    "random": (_XS, _XS[::-1]),
}


@pytest.mark.parametrize("vectors", sorted(_CARRY_VECTORS))
@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_add_sub_neg_match_jax(op, vectors):
    xs, ys = _CARRY_VECTORS[vectors]
    a, b = _limbs(xs), _limbs(ys)
    args_t = (torch.from_numpy(a), torch.from_numpy(b))
    args_j = (jnp.asarray(a), jnp.asarray(b))
    n = 1 if op == "neg" else 2
    out = getattr(tfp, op)(*args_t[:n])
    _same(out, getattr(jfp, op)(*args_j[:n]))
    expect = {"add": [(x + y) % P for x, y in zip(xs, ys)],
              "sub": [(x - y) % P for x, y in zip(xs, ys)],
              "neg": [(-x) % P for x in xs]}[op]
    assert _ints(out) == expect


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_cpu_add_sub_neg_take_the_plain_versions_and_launch_nothing(
        op, monkeypatch):
    a = torch.from_numpy(_limbs([3, P - 1]))
    b = torch.from_numpy(_limbs([P - 5, 7]))
    args = (a,) if op == "neg" else (a, b)
    plain = getattr(tfp, f"{op}_reference")
    calls = []
    monkeypatch.setattr(tfp, f"{op}_reference",
                        lambda *xs: calls.append(1) or plain(*xs))
    before = (KA.LAUNCHES, K.LAUNCHES)
    _same(getattr(tfp, op)(*args), plain(*args))
    assert calls == [1]
    assert (KA.LAUNCHES, K.LAUNCHES) == before


def test_fp_addsub_kernel_refuses_cpu_tensors_and_wrong_dtypes():
    a = torch.from_numpy(_limbs([3, 5]))
    for fn, args in ((KA.add, (a, a)), (KA.sub, (a, a)), (KA.neg, (a,))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        with pytest.raises(TypeError, match="int32"):
            fn(*(x.long() for x in args))
    assert KA.LAUNCHES == 0


def test_inv_matches_jax():
    xs = [1, P - 1] + _XS[:2]  # 4 lanes, as above
    am = _limbs([x * R % P for x in xs])
    out = tfp.inv(torch.from_numpy(am))
    _same(out, jfp.inv(jnp.asarray(am)))
    assert _ints(out) == [pow(x, -1, P) * R % P for x in xs]


def test_cpu_inv_takes_the_plain_version_and_launches_nothing(monkeypatch):
    a = torch.from_numpy(_limbs([0, 1, P - 1]))
    plain = tfp.inv_reference
    calls = []
    monkeypatch.setattr(tfp, "inv_reference",
                        lambda x: calls.append(1) or plain(x))
    before = (KI.LAUNCHES, K.LAUNCHES)
    out = tfp.inv(a)
    _same(out, plain(a))
    assert calls == [1]
    assert (KI.LAUNCHES, K.LAUNCHES) == before
    # limbs x hold x R^-1 in the Montgomery domain: the inverse is x^-1 R^2
    assert _ints(out) == [pow(x, -1, P) * R * R % P if x else 0
                          for x in (0, 1, P - 1)]


@pytest.mark.parametrize("entry", ["fp.inv", "curve.FP_OPS.inv"])
def test_inv_off_the_cpu_goes_to_the_kernel_and_never_falls_back(
        entry, monkeypatch):
    """A tensor that is not on the CPU reaches the kernel's wrapper, which
    launches or raises: here (no card) it raises, and the plain version
    is never called.  ``curve.FP_OPS`` holds the dispatcher it captured
    at import, which must dispatch the same way."""
    calls = []
    monkeypatch.setattr(tfp, "inv_reference", lambda x: calls.append(1))
    inv = tfp.inv if entry == "fp.inv" else TCV.FP_OPS.inv
    with pytest.raises(ValueError, match="CUDA"):
        inv(torch.empty(3, 32, dtype=torch.int32, device="meta"))
    assert calls == []
    assert KI.LAUNCHES == 0


def test_fp_inv_kernel_refuses_cpu_tensors_and_wrong_dtypes():
    a = torch.from_numpy(_limbs([3, 5]))
    with pytest.raises(ValueError, match="CUDA"):
        KI.inv(a)
    with pytest.raises(TypeError, match="int32"):
        KI.inv(a.long())
    assert KI.LAUNCHES == 0


def test_generated_header_carries_r_cubed():
    """The GCD inversion leaves the kernels with A^-1 for A = a R and
    returns a^-1 R by one Montgomery product by the header's R^3 mod p."""
    from harmony_tpu_torch.kernels import _build

    line = _build.params_header().split("HARMONY_R3_WORDS", 1)[1]
    words = [int(w, 16) for w in line.split("\n", 1)[0].replace(
        "u", "").split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(words)) == R ** 3 % P
    a = 0x1234567 * R % P
    plain_inverse = pow(a, -1, P)  # what the GCD leaves
    assert plain_inverse * (R ** 3 % P) * pow(R, -1, P) % P == \
        pow(0x1234567, -1, P) * R % P


def test_is_zero_and_select_match_jax():
    a = _limbs([0, 1, P - 1, 0])
    b = _limbs([5, 6, 7, 8])
    mask = np.array([True, False, True, False])
    _same(tfp.is_zero(torch.from_numpy(a)), jfp.is_zero(jnp.asarray(a)))
    _same(tfp.select(torch.from_numpy(mask), torch.from_numpy(a),
                     torch.from_numpy(b)),
          jfp.select(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b)))


def test_carry_helpers_match_kogge_stone():
    """The port's running-maximum lookahead against the JAX package's
    Kogge-Stone one, on random limbs biased towards long carry chains.
    150 rows: the shape the JAX scan's own normalization already compiled
    for in the ragged mont_mul case."""
    g = np.random.default_rng(0x5EED)
    lazy = g.choice([0, 1, 4094, 4095, 4096, 8191], size=(150, 32))
    lazy = np.where(g.random((150, 32)) < 0.2,
                    g.integers(0, 8192, size=(150, 32)), lazy).astype(np.int32)
    _same(tfp.resolve_carries(torch.from_numpy(lazy)),
          jfp.resolve_carries(jnp.asarray(lazy)))
    x = np.where(g.random((150, 32)) < 0.5, 4095, 0).astype(np.int32)
    y = g.choice([0, 4095], size=(150, 32)).astype(np.int32)
    for t, j in zip(tfp._sub_exact(torch.from_numpy(x), torch.from_numpy(y)),
                    jfp._sub_exact(jnp.asarray(x), jnp.asarray(y))):
        _same(t, j)
    big = g.integers(0, 1 << 30, size=(150, 32)).astype(np.int32)
    big[:, -2:] = 0  # keep the value below 2^384
    _same(tfp.normalize(torch.from_numpy(big)),
          jfp.normalize(jnp.asarray(big)))
