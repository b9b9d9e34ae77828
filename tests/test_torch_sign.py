"""The port's signing ops (ops/curve.py neg, scalar_mul, the G2
masked_sum; ops/bls.py sk_to_bits, derive_pubkeys, clear_cofactor_g2,
sign, aggregate_sigs) on the CPU.

The plain versions against the JAX package's ``ops.curve`` run eagerly,
bit for bit (Jacobian limbs, tolerance 0: exact integer work whose limbs
depend on the formula, which the port keeps), at one short shape per op.
Each JAX program of the group law takes some 30 to 50 s to compile on
this CPU, so there are three, one a file so that they can run side by
side: here the G1 ladder with per-lane bits (and neg); in
tests/test_torch_sign_g2.py the G2 ladder with shared bits; in
tests/test_torch_sign_aggregate.py the G2 sum of two points (run on
several pairs).  Then the ops at full width (255-bit keys, the 507-bit
cofactor) against the port's bigint reference (``ref.curve``), in
affine: derive_pubkeys here, sign and clear_cofactor_g2 and
aggregate_sigs beside their JAX programs.  Inputs come from a seeded
``random`` and reach both packages as the same numpy limb arrays.  A CPU
tensor takes the plain version and launches nothing; a tensor off the
CPU reaches the kernel's wrapper, which here (no card) raises.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harmony_tpu.ops import bls as JB
from harmony_tpu.ops import curve as JCV
from harmony_tpu_torch.kernels import g2_masked_sum as KG2
from harmony_tpu_torch.kernels import scalar_mul as KS
from harmony_tpu_torch.ops import bls as TB
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ref import fields as RF
from harmony_tpu_torch.ref.curve import G1_GEN, G2_GEN, g1, g2
from harmony_tpu_torch.ref.params import P, R_ORDER

rng = random.Random(0x516)


def _same(t_out, j_out):
    t = t_out.numpy()
    j = np.asarray(j_out)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def _jacobian(field, pts, rng=rng):
    """Host affine points (None: infinity) as Jacobian limbs of the same
    points with Z != 1: (x l^2, y l^3, l) for a random l; infinity as
    (1, 1, 0)."""
    rows = []
    for pt in pts:
        if field == "g1":
            if pt is None:
                rows.append(TI.g1_affine_to_jacobian_arr(None))
                continue
            lam = rng.randrange(2, P)
            rows.append(torch.stack([TI.fp_to_arr(c) for c in (
                pt[0] * lam ** 2 % P, pt[1] * lam ** 3 % P, lam)]))
        else:
            if pt is None:
                rows.append(TI.g2_affine_to_jacobian_arr(None))
                continue
            lam = (rng.randrange(P), rng.randrange(1, P))
            lam2 = RF.fp2_sqr(lam)
            rows.append(torch.stack([TI.fp2_to_arr(c) for c in (
                RF.fp2_mul(pt[0], lam2),
                RF.fp2_mul(pt[1], RF.fp2_mul(lam2, lam)), lam)]))
    return torch.stack(rows)


def _random(group, gen, rng=rng):
    return group.mul(gen, rng.randrange(1, R_ORDER))


BITS = np.array([[0, 1, 1, 0, 1, 0, 0, 1], [1, 1, 0, 2, 1, -1, 1, 0]],
                dtype=np.int32)


def test_sk_to_bits_equals_the_jax_helper():
    sks = [0, 1, R_ORDER - 1, rng.randrange(R_ORDER), (1 << 254) + 3]
    got = TB.sk_to_bits(sks)
    np.testing.assert_array_equal(got, JB.sk_to_bits(sks))
    assert got.dtype == np.int32 and got.shape == (5, TB.SK_BITS)
    assert TB.SK_BITS == JB.SK_BITS == 255


def test_neg_matches_jax():
    for field, ops, jops in (("g1", TCV.FP_OPS, JCV.FP_OPS),
                             ("g2", TCV.FP2_OPS, JCV.FP2_OPS)):
        group, gen = (g1, G1_GEN) if field == "g1" else (g2, G2_GEN)
        pts = _jacobian(field, [_random(group, gen), None])
        out = TCV.neg(pts, ops)
        _same(out, JCV.neg(jnp.asarray(pts.numpy()), jops))
        to_aff = TI.arr_to_g1_affine if field == "g1" else \
            TI.arr_to_g2_affine
        assert to_aff(out[0]) == group.neg(to_aff(pts[0]))


def test_g1_scalar_mul_matches_jax_with_per_lane_bits():
    """Two lanes of 8 bits (leading zeros; a 2 and a -1, which do not
    add, as bit == 1); the shared form is the per-lane form with every
    row the same."""
    pts = _jacobian("g1", [_random(g1, G1_GEN), _random(g1, G1_GEN)])
    out = TCV.scalar_mul(pts, torch.from_numpy(BITS), TCV.FP_OPS)
    _same(out, JCV.scalar_mul(jnp.asarray(pts.numpy()), jnp.asarray(BITS),
                              JCV.FP_OPS))
    shared = TCV.scalar_mul(pts, torch.from_numpy(BITS[0]), TCV.FP_OPS)
    _same(shared, TCV.scalar_mul(
        pts, torch.from_numpy(np.stack([BITS[0]] * 2)), TCV.FP_OPS).numpy())


# -- full width against the bigint reference ----------------------------------


def test_derive_pubkeys_at_full_width_gives_the_reference_keys():
    sks = [rng.randrange(1, R_ORDER), R_ORDER - 1]
    pks = TB.derive_pubkeys(TB.sk_to_bits(sks), device="cpu")
    assert pks.shape == (2, 3, 32) and pks.device.type == "cpu"
    for pk, sk in zip(pks, sks):
        assert TI.arr_to_g1_affine(pk) == g1.mul(G1_GEN, sk)


def _twist_point():
    """A point of the twist outside G2, as the host's map to the twist
    gives them: the first x = (k, 1) with x^3 + b a square."""
    for k in range(1, 100):
        x = (k, 1)
        y = RF.fp2_sqrt(RF.fp2_add(RF.fp2_mul(RF.fp2_sqr(x), x), g2.b))
        if y is not None:
            return (x, y)
    raise AssertionError("no twist point")


# -- dispatch: the CPU takes the plain versions; off the CPU, the kernels -----


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(monkeypatch):
    calls = []
    for name in ("scalar_mul_reference", "masked_sum_reference"):
        real = getattr(TCV, name)
        monkeypatch.setattr(TCV, name, lambda *a, real=real, name=name:
                            calls.append(name) or real(*a))
    before = dict(KS.LAUNCHES), KG2.LAUNCHES
    pts = TCV.infinity(TCV.FP2_OPS, (2,))
    bits = torch.tensor([1, 0, 1])
    # the cofactor's 507 steps are slow on the CPU: three bits here
    monkeypatch.setattr(TB, "_H2_BITS", bits.to(torch.int32))
    TB.sign(pts, torch.stack([bits, bits]))
    TB.clear_cofactor_g2(pts[:1])
    TB.derive_pubkeys(torch.stack([bits] * 2))
    TB.aggregate_sigs(torch.zeros(3, 2, 2, 32, dtype=torch.int32))
    assert calls == ["scalar_mul_reference"] * 3 + ["masked_sum_reference"]
    assert (KS.LAUNCHES, KG2.LAUNCHES) == before


@pytest.mark.parametrize("entry", ["scalar_mul_g1", "scalar_mul_g2",
                                   "masked_sum_g2", "derive_pubkeys",
                                   "clear_cofactor_g2", "sign",
                                   "aggregate_sigs"])
def test_tensors_off_the_cpu_go_to_the_kernels_and_never_fall_back(
        entry, monkeypatch):
    """Tensors that are not on the CPU reach the kernel's wrapper, which
    launches or raises: here (no card) it raises, and no plain version is
    called."""
    calls = []
    for name in ("scalar_mul_reference", "masked_sum_reference"):
        monkeypatch.setattr(TCV, name, lambda *a, name=name:
                            calls.append(name))
    meta = {"device": "meta", "dtype": torch.int32}
    g2_pts = torch.empty(4, 3, 2, 32, **meta)
    bits = torch.empty(4, 255, **meta)
    run = {
        "scalar_mul_g1": lambda: TCV.scalar_mul(
            torch.empty(4, 3, 32, **meta), bits, TCV.FP_OPS),
        "scalar_mul_g2": lambda: TCV.scalar_mul(g2_pts, bits[0],
                                                TCV.FP2_OPS),
        "masked_sum_g2": lambda: TCV.masked_sum(
            g2_pts, torch.ones(4, **meta), TCV.FP2_OPS),
        "derive_pubkeys": lambda: TB.derive_pubkeys(bits),
        "clear_cofactor_g2": lambda: TB.clear_cofactor_g2(g2_pts),
        "sign": lambda: TB.sign(g2_pts, bits),
        "aggregate_sigs": lambda: TB.aggregate_sigs(
            torch.empty(4, 2, 2, 32, **meta)),
    }[entry]
    before = dict(KS.LAUNCHES), KG2.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        run()
    assert calls == []
    assert (KS.LAUNCHES, KG2.LAUNCHES) == before


def test_derive_pubkeys_of_host_bits_runs_on_cuda_or_raises(monkeypatch):
    """Bits that are no tensor run on CUDA unless the caller passes a
    device: without CUDA that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.derive_pubkeys(TB.sk_to_bits([5]))


def test_kernels_refuse_cpu_tensors_dtypes_and_shapes():
    cpu_g1 = torch.zeros(2, 3, 32, dtype=torch.int32)
    bits = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        KS.scalar_mul_g1(cpu_g1, bits)
    with pytest.raises(TypeError, match="int32"):
        KS.scalar_mul_g1(cpu_g1.long(), bits)
    meta = {"device": "meta", "dtype": torch.int32}
    g1_pts, g2_pts = torch.empty(2, 3, 32, **meta), \
        torch.empty(2, 3, 2, 32, **meta)
    mbits = torch.empty(2, 8, **meta)
    for fn, pts, b in ((KS.scalar_mul_g1, g2_pts, mbits),  # G2 to G1
                       (KS.scalar_mul_g2, g1_pts, mbits),  # G1 to G2
                       (KS.scalar_mul_g1, g1_pts, mbits[:1]),  # lanes
                       (KS.scalar_mul_g1, g1_pts,
                        torch.empty((), **meta)),  # no bit axis
                       (KS.scalar_mul_g2, g2_pts[..., :16], mbits)):
        with pytest.raises(ValueError, match=r"\(\.\.\., 3"):
            fn(pts, b)
    with pytest.raises(ValueError, match="CUDA"):
        KG2.g2_masked_sum(torch.zeros(2, 3, 2, 32, dtype=torch.int32),
                          torch.ones(2))
    with pytest.raises(TypeError, match="int32"):
        KG2.g2_masked_sum(g2_pts.long(), torch.ones(2, device="meta"))
    for pts, m in ((g2_pts, torch.ones(3, device="meta")),  # N disagrees
                   (g2_pts[:, None], torch.ones(2, 1, device="meta")),
                   (g1_pts, torch.ones(2, device="meta")),  # G1 points
                   (torch.empty(1025, 3, 2, 32, **meta),
                    torch.ones(1025, device="meta"))):  # past 1024
        with pytest.raises(ValueError, match=r"\(N, 3, 2, 32\)"):
            KG2.g2_masked_sum(pts, m)
    assert KS.LAUNCHES == {"scalar_mul_g1": 0, "scalar_mul_g2": 0}
    assert KG2.LAUNCHES == 0
