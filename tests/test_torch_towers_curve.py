"""harmony_tpu_torch.ops.{towers,curve} against the JAX package's ops, run
eagerly, bit for bit (tolerance 0: exact integer arithmetic).

Inputs come from a seeded ``random`` and reach both packages as the same
numpy limb arrays.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops import curve as JCV
from harmony_tpu.ops import interop as JI
from harmony_tpu.ops import towers as JT
from harmony_tpu.ref import curve as RC
from harmony_tpu.ref import fields as RF
from harmony_tpu.ref.params import P, R_ORDER
from harmony_tpu_torch.kernels import fp12_cyclo_sqr as KC
from harmony_tpu_torch.kernels import fp12_mul as KM
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ops import towers as TT

rng = random.Random(0x7C)


def _fp2():
    return (rng.randrange(P), rng.randrange(P))


def _fp6():
    return (_fp2(), _fp2(), _fp2())


def _fp12():
    return (_fp6(), _fp6())


def _same(t_out, j_out):
    t = t_out.numpy()
    j = np.asarray(j_out)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def _both(arr):
    return torch.from_numpy(arr), jnp.asarray(arr)


A12 = JI.batch(JI.fp12_to_arr, [_fp12() for _ in range(2)])
B12 = JI.batch(JI.fp12_to_arr, [_fp12() for _ in range(2)])


def _cyclotomic(f):
    """f^((p^6 - 1)(p^2 + 1)): an element of the cyclotomic subgroup,
    where every final-exponentiation intermediate lives."""
    f1 = RF.fp12_mul(RF.fp12_conj(f), RF.fp12_inv(f))
    return RF.fp12_mul(RF.fp12_pow(f1, P * P), f1)


U12 = JI.batch(JI.fp12_to_arr, [_cyclotomic(_fp12()) for _ in range(2)])

# Held against the JAX package run eagerly: eager dispatch compiles one
# small XLA program per op and shape, so this list is the slice's core
# (every Fp12 product of the path reaches fp2/fp6 through fp12_mul).
_JAX_CASES = {
    "fp12_mul": (TT.fp12_mul, JT.fp12_mul, (A12, B12)),
    "fp12_cyclo_sqr_cyclotomic": (TT.fp12_cyclo_sqr, JT.fp12_cyclo_sqr,
                                  (U12,)),
    "fp12_frobenius_1": (lambda a: TT.fp12_frobenius(a, 1),
                         lambda a: JT.fp12_frobenius(a, 1), (A12,)),
    "fp12_frobenius_2": (lambda a: TT.fp12_frobenius(a, 2),
                         lambda a: JT.fp12_frobenius(a, 2), (A12,)),
    "fp12_frobenius_3": (lambda a: TT.fp12_frobenius(a, 3),
                         lambda a: JT.fp12_frobenius(a, 3), (A12,)),
}


@pytest.mark.parametrize("name", sorted(_JAX_CASES))
def test_tower_op_matches_jax(name):
    t_fn, j_fn, args = _JAX_CASES[name]
    t_args, j_args = zip(*(_both(a) for a in args))
    _same(t_fn(*t_args), j_fn(*j_args))


A2_REF = [_fp2() for _ in range(3)]
B2_REF = [_fp2() for _ in range(3)]
A6_REF = [_fp6() for _ in range(2)]
B6_REF = [_fp6() for _ in range(2)]
A12_REF = [JI.arr_to_fp12(a) for a in A12]
B12_REF = [JI.arr_to_fp12(b) for b in B12]

# Held against the bigint tower (harmony_tpu.ref.fields), which is cheap.
_REF_CASES = {
    "fp2_mul": (TT.fp2_mul, RF.fp2_mul, TI.fp2_to_arr, TI.arr_to_fp2,
                (A2_REF, B2_REF)),
    "fp2_sqr": (TT.fp2_sqr, RF.fp2_sqr, TI.fp2_to_arr, TI.arr_to_fp2,
                (A2_REF,)),
    "fp2_mul_xi": (TT.fp2_mul_xi, RF.fp2_mul_xi, TI.fp2_to_arr,
                   TI.arr_to_fp2, (A2_REF,)),
    "fp6_mul": (TT.fp6_mul, RF.fp6_mul, TI.fp6_to_arr, TI.arr_to_fp6,
                (A6_REF, B6_REF)),
    "fp6_mul_v": (TT.fp6_mul_v, RF.fp6_mul_v, TI.fp6_to_arr, TI.arr_to_fp6,
                  (A6_REF,)),
    "fp12_sqr": (TT.fp12_sqr, RF.fp12_sqr, TI.fp12_to_arr, TI.arr_to_fp12,
                 (A12_REF,)),
    "fp12_conj": (TT.fp12_conj, RF.fp12_conj, TI.fp12_to_arr,
                  TI.arr_to_fp12, (A12_REF,)),
    "fp12_inv": (TT.fp12_inv, RF.fp12_inv, TI.fp12_to_arr, TI.arr_to_fp12,
                 (A12_REF,)),
}


@pytest.mark.parametrize("name", sorted(_REF_CASES))
def test_tower_op_matches_bigint(name):
    t_fn, r_fn, to_arr, from_arr, args = _REF_CASES[name]
    out = t_fn(*(TI.batch(to_arr, xs) for xs in args))
    for i, row in enumerate(zip(*args)):
        assert from_arr(out[i]) == r_fn(*row), i


def test_cyclo_sqr_equals_generic_square_on_cyclotomic_input():
    u = torch.from_numpy(U12)
    _same(TT.fp12_cyclo_sqr(u), TT.fp12_sqr(u).numpy())


_FUSED = {
    "fp12_mul": (lambda a: TT.fp12_mul(a, a.flip(0)), "fp12_mul_reference",
                 lambda a: TT.fp12_mul_reference(a, a.flip(0))),
    "fp12_sqr": (TT.fp12_sqr, "fp12_sqr_reference", TT.fp12_sqr_reference),
    "fp12_cyclo_sqr": (TT.fp12_cyclo_sqr, "fp12_cyclo_sqr_reference",
                       TT.fp12_cyclo_sqr_reference),
    "fp12_cyclo_sqr_n": (lambda a: TT.fp12_cyclo_sqr_n(a, 3),
                         "fp12_cyclo_sqr_reference",
                         lambda a: TT.fp12_cyclo_sqr_reference(
                             TT.fp12_cyclo_sqr_reference(
                                 TT.fp12_cyclo_sqr_reference(a)))),
}


@pytest.mark.parametrize("name", sorted(_FUSED))
def test_cpu_tower_ops_take_the_plain_versions_and_launch_nothing(
        name, monkeypatch):
    fn, plain_name, plain = _FUSED[name]
    u = torch.from_numpy(U12)
    want = plain(u)
    calls = []
    real = getattr(TT, plain_name)
    monkeypatch.setattr(TT, plain_name,
                        lambda *xs: calls.append(1) or real(*xs))
    before = (KM.LAUNCHES, KC.LAUNCHES)
    _same(fn(u), want.numpy())
    assert calls
    assert (KM.LAUNCHES, KC.LAUNCHES) == before


def test_fused_kernels_refuse_cpu_tensors_wrong_dtypes_and_shapes():
    u = torch.from_numpy(U12)
    for fn, args in ((KM.fp12_mul, (u, u)),
                     (lambda a: KC.fp12_cyclo_sqr_n(a, 2), (u,))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)
        with pytest.raises(TypeError, match="int32"):
            fn(*(x.long() for x in args))
    with pytest.raises(ValueError, match="squarings"):
        KC.fp12_cyclo_sqr_n(u, -1)
    assert (KM.LAUNCHES, KC.LAUNCHES) == (0, 0)


# --- curve -----------------------------------------------------------------

KS = [rng.randrange(1, R_ORDER) for _ in range(4)]
G1_REF = [RC.g1.mul(RC.G1_GEN, k) for k in KS]
G1_PTS = np.stack([JI.g1_affine_to_jacobian_arr(p) for p in G1_REF])


# The special cases of the group law.  The JAX side runs them one lane at
# a time: a 1-lane add is the shape the 2-key masked_sum below reduces
# with, and the add computes a doubling inside, so its eager ops compile
# once for all three tests.
_P0, _P1 = G1_REF[0], G1_REF[1]
G1_CASES = [(_P0, _P1), (_P0, _P0), (_P0, RC.g1.neg(_P0)), (None, _P1),
            (_P0, None), (None, None)]
G1_LHS = np.stack([JI.g1_affine_to_jacobian_arr(x) for x, _ in G1_CASES])
G1_RHS = np.stack([JI.g1_affine_to_jacobian_arr(y) for _, y in G1_CASES])


def test_g1_add_special_cases_match_jax():
    out = TCV.add(torch.from_numpy(G1_LHS), torch.from_numpy(G1_RHS),
                  TCV.FP_OPS)
    for i, (x, y) in enumerate(G1_CASES):
        _same(out[i:i + 1], JCV.add(jnp.asarray(G1_LHS[i:i + 1]),
                                    jnp.asarray(G1_RHS[i:i + 1]), JCV.FP_OPS))
        assert TI.arr_to_g1_affine(out[i]) == RC.g1.add(x, y), i


def test_g1_dbl_matches_jax():
    out = TCV.dbl(torch.from_numpy(G1_LHS), TCV.FP_OPS)
    for i, (x, _) in enumerate(G1_CASES):
        _same(out[i:i + 1],
              JCV.dbl(jnp.asarray(G1_LHS[i:i + 1]), JCV.FP_OPS))
        assert TI.arr_to_g1_affine(out[i]) == RC.g1.dbl(x), i


def test_g2_dbl_add_match_bigint():
    ref2 = [RC.g2.mul(RC.G2_GEN, k) for k in KS[:2]]
    cases = [(ref2[0], ref2[1]), (ref2[0], ref2[0]), (None, ref2[1])]
    a = np.stack([JI.g2_affine_to_jacobian_arr(x) for x, _ in cases])
    b = np.stack([JI.g2_affine_to_jacobian_arr(y) for _, y in cases])
    out = TCV.add(torch.from_numpy(a), torch.from_numpy(b), TCV.FP2_OPS)
    for i, (x, y) in enumerate(cases):
        assert TI.arr_to_g2_affine(out[i]) == RC.g2.add(x, y), i
    out = TCV.dbl(torch.from_numpy(a), TCV.FP2_OPS)
    for i, (x, _) in enumerate(cases):
        assert TI.arr_to_g2_affine(out[i]) == RC.g2.dbl(x), i


def test_masked_sum_matches_jax():
    """Two keys: one tree level, so the JAX side compiles one add."""
    mask = [1, 1]
    t, j = _both(G1_PTS[:2])
    _same(TCV.masked_sum(t, torch.tensor(mask), TCV.FP_OPS),
          JCV.masked_sum(j, jnp.asarray(mask), JCV.FP_OPS))


@pytest.mark.parametrize("mask", [[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 1]])
def test_masked_sum_matches_bigint(mask):
    out = TCV.masked_sum(torch.from_numpy(G1_PTS), torch.tensor(mask),
                         TCV.FP_OPS)
    expect = None
    for i, m in enumerate(mask):
        if m:
            expect = RC.g1.add(expect, G1_REF[i])
    assert TI.arr_to_g1_affine(out) == expect


def test_batched_masked_sum_equals_one_sum_per_bitmap():
    """The (N, B) mask form (the JAX package's vmap, written out) against
    one sum per bitmap; duplicates hit the doubling path, and 3 keys pad
    to 4 with infinity."""
    pts = torch.from_numpy(np.concatenate([G1_PTS[:2], G1_PTS[:1]]))
    bitmaps = torch.tensor([[1, 0, 1], [0, 1, 0], [1, 1, 1], [0, 0, 0]])
    out = TCV.masked_sum(pts[:, None], bitmaps.T, TCV.FP_OPS)
    for b in range(4):
        _same(out[b], TCV.masked_sum(pts, bitmaps[b], TCV.FP_OPS).numpy())


def test_to_affine_matches_bigint():
    ax, ay = TCV.to_affine(torch.from_numpy(G1_PTS), TCV.FP_OPS)
    for i in range(4):
        assert (TI.arr_to_fp(ax[i]), TI.arr_to_fp(ay[i])) == G1_REF[i]


def test_generators_match_jax():
    _same(TCV.G1_GEN, JCV.G1_GEN)
    _same(TCV.G2_GEN, JCV.G2_GEN)
