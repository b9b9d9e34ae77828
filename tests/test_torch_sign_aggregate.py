"""The port's G2 masked sum (ops/curve.py masked_sum over FP2_OPS)
against the JAX package's, run eagerly, and ops/bls.py aggregate_sigs
and clear_cofactor_g2 at full width against the bigint reference; see
tests/test_torch_sign.py, which holds the helpers."""

import random

import jax.numpy as jnp
import numpy as np
import torch

from harmony_tpu.ops import curve as JCV
from harmony_tpu_torch.ops import bls as TB
from harmony_tpu_torch.ops import curve as TCV
from harmony_tpu_torch.ops import interop as TI
from harmony_tpu_torch.ref.curve import G2_GEN, g2
from harmony_tpu_torch.ref.params import R_ORDER
from test_torch_sign import _jacobian, _random, _same, _twist_point

rng = random.Random(0x5163)


def test_g2_masked_sum_matches_jax():
    """Two signatures: one tree level, one JAX program, run on a pair of
    distinct points, a point twice (the doubling), a point and its
    negative (infinity), a pair with infinity, and masks of one or none."""
    a, b = _random(g2, G2_GEN, rng), _random(g2, G2_GEN, rng)
    cases = [((a, b), (1, 1)), ((a, a), (1, 1)), ((a, g2.neg(a)), (1, 1)),
             ((None, b), (1, 1)), ((a, b), (0, 1)), ((a, b), (0, 2))]
    for (p, q), mask in cases:
        pts = _jacobian("g2", [p, q], rng)
        m = np.asarray(mask, dtype=np.int32)
        out = TCV.masked_sum(pts, torch.from_numpy(m), TCV.FP2_OPS)
        _same(out, JCV.masked_sum(jnp.asarray(pts.numpy()), jnp.asarray(m),
                                  JCV.FP2_OPS))
        want = None
        for pt, bit in zip((p, q), mask):
            if bit == 1:
                want = g2.add(want, pt)
        assert TI.arr_to_g2_affine(out) == want, mask


def test_aggregate_sigs_gives_the_reference_sum():
    """Affine signatures with a duplicate, a point and its negative and
    infinity (0, 0), with and without a bitmap."""
    sigs = [_random(g2, G2_GEN, rng) for _ in range(3)]
    sigs += [sigs[0], g2.neg(sigs[1]), None]
    aff = torch.stack([TI.g2_affine_to_arr(s) if s is not None else
                       torch.zeros(2, 2, 32, dtype=torch.int32)
                       for s in sigs])
    for bitmap in (None, [1, 0, 1, 1, 0, 1], [0, 1, 0, 0, 1, 0]):
        out = TB.aggregate_sigs(aff, None if bitmap is None else
                                torch.tensor(bitmap))
        assert out.shape == (3, 2, 32)
        want = None
        for sig, bit in zip(sigs, bitmap or [1] * 6):
            if bit == 1:
                want = g2.add(want, sig)
        assert TI.arr_to_g2_affine(out) == want, bitmap


def test_clear_cofactor_g2_at_full_width_gives_the_reference_point():
    tw = _twist_point()
    out = TB.clear_cofactor_g2(TI.g2_affine_to_jacobian_arr(tw)[None])
    assert out.shape == (1, 3, 2, 32)
    h = TI.arr_to_g2_affine(out[0])
    assert h == g2.mul(tw, TB.C.H2) and g2.mul(h, R_ORDER) is None
