"""The port's G2 ladder (ops/curve.py scalar_mul over FP2_OPS) against the
JAX package's, run eagerly, with shared bits, and ops/bls.py sign at full
width against the bigint reference; see tests/test_torch_sign.py, which
holds the helpers and the G1 ladder."""

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
from test_torch_sign import BITS, _jacobian, _random, _same

rng = random.Random(0x5162)


def test_g2_scalar_mul_matches_jax_with_shared_bits():
    pts = _jacobian("g2", [_random(g2, G2_GEN, rng), None], rng)
    out = TCV.scalar_mul(pts, torch.from_numpy(BITS[1]), TCV.FP2_OPS)
    _same(out, JCV.scalar_mul(jnp.asarray(pts.numpy()),
                              jnp.asarray(BITS[1]), JCV.FP2_OPS))
    k = int("".join("1" if b == 1 else "0" for b in BITS[1]), 2)
    assert TI.arr_to_g2_affine(out[0]) == g2.mul(TI.arr_to_g2_affine(pts[0]),
                                                 k)
    _same(out, TCV.scalar_mul(
        pts, torch.from_numpy(np.stack([BITS[1]] * 2)), TCV.FP2_OPS).numpy())


def test_sign_at_full_width_gives_the_reference_signatures():
    """sign on a hashed message (a point of G2) made Jacobian with Z != 1,
    as clear_cofactor_g2 hands it on: sk H(m)."""
    h = _random(g2, G2_GEN, rng)
    sks = [rng.randrange(1, R_ORDER), 1]
    sigs = TB.sign(_jacobian("g2", [h, h], rng), torch.from_numpy(
        TB.sk_to_bits(sks)))
    for sig, sk in zip(sigs, sks):
        assert TI.arr_to_g2_affine(sig) == g2.mul(h, sk)
