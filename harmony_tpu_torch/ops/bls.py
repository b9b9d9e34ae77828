"""Batched BLS signature ops: the quorum-verify path and the signing ops.

    op                                  op here
    --------------------------------------------------------------------
    single verify (Sign.VerifyHash)     verify (batched 2-pairing check)
    aggregate verify vs a bitmap        agg_verify (masked G1 sum +
                                          one 2-pairing product)
    B aggregate verifies, one table     agg_verify_batch
    PublicKey.Add over a mask           aggregate_pubkeys
    SecretKey.SignHash                  sign (batched scalar-mul on G2)
    keygen's public keys                derive_pubkeys (scalar-mul on G1)
    hashAndMapToG2 (cofactor part)      clear_cofactor_g2
    Sign.Add                            aggregate_sigs (masked G2 sum)

Conventions: secret keys are MSB-first bit tensors (B, 255); points are
limb tensors in the Montgomery domain, affine (G1 (B, 2, 32), G2
(B, 2, 2, 32), infinity (0, 0)) or, where a function says so, Jacobian
(G1 (B, 3, 32), G2 (B, 3, 2, 32)).  Hashed messages arrive as twist points
produced on the host (ref/hash_to_curve.py).  Every function runs on the
device of its input tensors; ``derive_pubkeys``, whose only input is the
bits, takes a device.  The node signs on the host (``ref``); these are
the batched device forms of the same operations.
"""

import numpy as np
import torch

from . import _constants as C
from . import curve as CV
from . import fp
from . import pairing as PR
from . import towers as T

SK_BITS = 255  # ceil(log2 r)

# the G2 cofactor's bits, MSB first (507 of them)
_H2_BITS = torch.tensor([int(b) for b in bin(C.H2)[2:]], dtype=torch.int32)

# (x, -y) of the G1 generator, affine, built once on the host
_NEG_G1_GEN_AFF = torch.stack([CV.G1_GEN[0], fp.neg(CV.G1_GEN[1])])


def sk_to_bits(sk_ints) -> np.ndarray:
    """Host helper: list of scalar ints -> (B, 255) MSB-first bit matrix."""
    out = np.zeros((len(sk_ints), SK_BITS), dtype=np.int32)
    for row, sk in enumerate(sk_ints):
        for j in range(SK_BITS):
            out[row, j] = (sk >> (SK_BITS - 1 - j)) & 1
    return out


@torch.inference_mode()
def derive_pubkeys(sk_bits, device=None):
    """pk = sk * G1 for a batch of secret keys; returns Jacobian (B, 3, 32).

    Runs on ``device``; by default on the bits' device where they are a
    tensor, else on CUDA, which must exist (pass device="cpu" for the
    plain version on the CPU)."""
    if device is None:
        if isinstance(sk_bits, torch.Tensor):
            device = sk_bits.device
        elif torch.cuda.is_available():
            device = "cuda"
        else:
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
    bits = torch.as_tensor(sk_bits, dtype=torch.int32, device=device)
    base = fp.on_device(CV.G1_GEN, bits.device).expand(
        bits.shape[0], *CV.G1_GEN.shape)
    return CV.scalar_mul(base, bits, CV.FP_OPS)


@torch.inference_mode()
def clear_cofactor_g2(pts):
    """Multiply twist points (B, 3, 2, 32) Jacobian by the G2 cofactor —
    the device half of hash-to-G2 (the host maps to the twist).  One bit
    string for every point."""
    return CV.scalar_mul(pts, fp.on_device(_H2_BITS, pts.device),
                         CV.FP2_OPS)


@torch.inference_mode()
def sign(h_points, sk_bits):
    """sig = sk * H(m): batched SignHash.  h_points are Jacobian G2
    (B, 3, 2, 32) hashed-message points; returns Jacobian signatures."""
    return CV.scalar_mul(h_points, sk_bits, CV.FP2_OPS)


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
    pk_aff = CV.masked_sum_to_affine(pk_affs, bitmap)[None]  # (1, 2, 32)
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
    bitmaps = torch.as_tensor(bitmaps, device=pk_affs.device)
    # (B, 2, 32)
    pk_aff = CV.masked_sum_to_affine(pk_affs[:, None], bitmaps.T)
    return verify(pk_aff, h_affs, agg_sig_affs)


@torch.inference_mode()
def aggregate_sigs(sig_affs, bitmap=None):
    """Sign.Add analog: sum signatures (N, 2, 2, 32) in G2, optionally
    bitmap-masked; returns a Jacobian point (3, 2, 32)."""
    n = sig_affs.shape[0]
    jac = _affine_to_jacobian_g2(sig_affs)
    if bitmap is None:
        bitmap = torch.ones((n,), dtype=torch.int32, device=sig_affs.device)
    return CV.masked_sum(jac, bitmap, CV.FP2_OPS)


@torch.inference_mode()
def aggregate_pubkeys(pk_affs, bitmap):
    """Mask.AggregatePublic analog: bitmap-masked G1 sum (Jacobian out)."""
    return CV.masked_sum(pk_affs, bitmap, CV.FP_OPS)


def _affine_to_jacobian_g2(aff):
    x = aff[..., 0, :, :]
    y = aff[..., 1, :, :]
    finite = ~(T.fp2_is_zero(x) & T.fp2_is_zero(y))
    one = T.fp2_one(x.shape[:-2], x.device)
    z = torch.where(finite[..., None, None], one, torch.zeros_like(one))
    return torch.stack([x, y, z], dim=-3)
