"""Batched BLS signature checks: the quorum-verify path.

    check                               op here
    --------------------------------------------------------------------
    single verify (Sign.VerifyHash)     verify (batched 2-pairing check)
    aggregate verify vs a bitmap        agg_verify (masked G1 sum +
                                          one 2-pairing product)
    B aggregate verifies, one table     agg_verify_batch
    PublicKey.Add over a mask           aggregate_pubkeys

Conventions: points are affine limb tensors in the Montgomery domain (G1
(B, 2, 32), G2 (B, 2, 2, 32)); infinity is affine (0, 0).  Hashed
messages arrive as twist points produced on the host
(ref/hash_to_curve.py).  Every function runs on the device of its inputs.
"""

import torch

from . import curve as CV
from . import fp
from . import pairing as PR
from . import towers as T

# (x, -y) of the G1 generator, affine, built once on the host
_NEG_G1_GEN_AFF = torch.stack([CV.G1_GEN[0], fp.neg(CV.G1_GEN[1])])


@torch.inference_mode()
def verify(pk_aff, h_aff, sig_aff):
    """Batched single verify: e(-G1, sig) * e(pk, H(m)) == 1.

    All inputs affine: pk (B, 2, 32), h and sig (B, 2, 2, 32).
    Returns a (B,) boolean mask.  Infinity is encoded as (0, 0) and
    rejected.
    """
    neg_g1 = fp.on_device(_NEG_G1_GEN_AFF, pk_aff.device).expand(pk_aff.shape)
    ps = torch.stack([neg_g1, pk_aff])  # (2, B, 2, 32)
    qs = torch.stack([sig_aff, h_aff])  # (2, B, 2, 2, 32)
    gt = PR.pairing_product(ps, qs)
    ok = PR.is_one(gt)
    pk_finite = ~fp.is_zero(pk_aff[..., 1, :])
    sig_finite = ~T.fp2_is_zero(sig_aff[..., 1, :, :])
    return ok & pk_finite & sig_finite


@torch.inference_mode()
def agg_verify(pk_affs, bitmap, h_aff, agg_sig_aff):
    """The FBFT quorum check: aggregate the bitmap-selected public keys in
    G1 and verify the aggregate signature with ONE pairing product.

    pk_affs: (N, 2, 32) committee pubkeys (affine), bitmap: (N,),
    h_aff / agg_sig_aff: single affine points (2, 2, 32).
    Returns a 0-dim bool tensor.
    """
    jac = _affine_to_jacobian_g1(pk_affs)
    agg_pk = CV.masked_sum(jac, bitmap, CV.FP_OPS)
    ax, ay = CV.to_affine(agg_pk, CV.FP_OPS)
    pk_aff = torch.stack([ax, ay])[None]  # (1, 2, 32)
    return verify(pk_aff, h_aff[None], agg_sig_aff[None])[0]


@torch.inference_mode()
def agg_verify_batch(pk_affs, bitmaps, h_affs, agg_sig_affs):
    """Batched quorum checks against ONE committee table: B headers,
    each with its own participation bitmap, hashed payload, and
    aggregate signature — the block-replay shape.

    pk_affs: (N, 2, 32) committee pubkeys; bitmaps: (B, N);
    h_affs / agg_sig_affs: (B, 2, 2, 32).  Returns (B,) bools.

    All B masked sums run as one tree reduction over an (N, B) stack
    (the JAX package's vmap, written out), then one batched verify.
    """
    jac = _affine_to_jacobian_g1(pk_affs)  # (N, 3, 32)
    bitmaps = torch.as_tensor(bitmaps, device=jac.device)
    agg = CV.masked_sum(jac[:, None], bitmaps.T, CV.FP_OPS)  # (B, 3, 32)
    ax, ay = CV.to_affine(agg, CV.FP_OPS)  # (B, 32) each
    pk_aff = torch.stack([ax, ay], dim=-2)  # (B, 2, 32)
    return verify(pk_aff, h_affs, agg_sig_affs)


@torch.inference_mode()
def aggregate_pubkeys(pk_affs, bitmap):
    """Mask.AggregatePublic analog: bitmap-masked G1 sum (Jacobian out)."""
    return CV.masked_sum(_affine_to_jacobian_g1(pk_affs), bitmap, CV.FP_OPS)


def _affine_to_jacobian_g1(aff):
    x = aff[..., 0, :]
    y = aff[..., 1, :]
    finite = ~(fp.is_zero(x) & fp.is_zero(y))
    one = fp.on_device(fp.ONE_MONT, x.device).expand(x.shape)
    z = torch.where(finite[..., None], one, torch.zeros_like(one))
    return torch.stack([x, y, z], dim=-2)


def _affine_to_jacobian_g2(aff):
    x = aff[..., 0, :, :]
    y = aff[..., 1, :, :]
    finite = ~(T.fp2_is_zero(x) & T.fp2_is_zero(y))
    one = T.fp2_one(x.shape[:-2], x.device)
    z = torch.where(finite[..., None, None], one, torch.zeros_like(one))
    return torch.stack([x, y, z], dim=-3)
