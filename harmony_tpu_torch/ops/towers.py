"""Batched tower fields Fp2 / Fp6 / Fp12 over the limb substrate (ops/fp.py).

Tower (the same as the JAX package's and ref/fields.py):

    Fp2  = Fp [u] / (u^2 + 1)          tensor (..., 2, 32)
    Fp6  = Fp2[v] / (v^3 - (u+1))      tensor (..., 3, 2, 32)
    Fp12 = Fp6[w] / (w^2 - v)          tensor (..., 2, 3, 2, 32)

Every mul at every level is Karatsuba with *independent* sub-products,
written shape-polymorphically, so the sub-products stack onto a new
leading axis.  A single Fp12 multiplication in the plain composition
therefore reaches ops/fp.py as ONE mont_mul call on a (3, 6, 3, ..., 32)
stack: 54 Fp products in one call instead of 54 small ones.

``fp12_mul``, ``fp12_sqr``, ``fp12_cyclo_sqr`` and ``fp12_cyclo_sqr_n``
dispatch on their tensors' device, as ops/fp.py ``mont_mul`` does: a CUDA
tensor launches one fused kernel for the whole operation
(kernels/fp12_mul.py, kernels/fp12_cyclo_sqr.py), which raises if it
cannot; a CPU tensor runs the plain composition, ``fp12_mul_reference``,
``fp12_sqr_reference`` and ``fp12_cyclo_sqr_reference``.

Montgomery domain throughout.  Functions that create tensors take the
device explicitly; the others run where their inputs lie.
"""

import numpy as np
import torch

from ..kernels import fp12_cyclo_sqr as K_CYCLO
from ..kernels import fp12_mul as K_FP12
from . import _constants as C
from . import fp

# --- Fp2 -------------------------------------------------------------------


def fp2_add(a, b):
    return fp.add(a, b)


def fp2_sub(a, b):
    return fp.sub(a, b)


def fp2_neg(a):
    return fp.neg(a)


def _split2(a):
    return a[..., 0, :], a[..., 1, :]


def fp2_mul(a, b):
    """Karatsuba: 3 stacked Fp muls."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = _split2(a)
    b0, b1 = _split2(b)
    lhs = torch.stack([a0, a1, fp.add(a0, a1)])
    rhs = torch.stack([b0, b1, fp.add(b0, b1)])
    v = fp.mont_mul(lhs, rhs)
    c0 = fp.sub(v[0], v[1])
    c1 = fp.sub(v[2], fp.add(v[0], v[1]))
    return torch.stack([c0, c1], dim=-2)


def fp2_sqr(a):
    """Complex squaring: (a0+a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u —
    2 stacked Fp muls."""
    a0, a1 = _split2(a)
    lhs = torch.stack([fp.add(a0, a1), a0])
    rhs = torch.stack([fp.sub(a0, a1), fp.add(a1, a1)])
    v = fp.mont_mul(lhs, rhs)
    return torch.stack([v[0], v[1]], dim=-2)


def fp2_conj(a):
    a0, a1 = _split2(a)
    return torch.stack([a0, fp.neg(a1)], dim=-2)


def fp2_mul_xi(a):
    """Multiply by xi = u + 1: (a0 - a1) + (a0 + a1) u."""
    a0, a1 = _split2(a)
    return torch.stack([fp.sub(a0, a1), fp.add(a0, a1)], dim=-2)


def fp2_inv(a):
    a0, a1 = _split2(a)
    sq = fp.mont_mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    ninv = fp.inv(fp.add(sq[0], sq[1]))
    prod = fp.mont_mul(torch.stack([a0, a1]), torch.stack([ninv, ninv]))
    return torch.stack([prod[0], fp.neg(prod[1])], dim=-2)


def fp2_zero(batch_shape=(), device="cpu"):
    return torch.zeros((*batch_shape, 2, fp.N_LIMBS), dtype=torch.int32,
                       device=device)


def fp2_one(batch_shape=(), device="cpu"):
    one = fp.on_device(fp.ONE_MONT, device).expand(*batch_shape, fp.N_LIMBS)
    return torch.stack([one, torch.zeros_like(one)], dim=-2)


def fp2_is_zero(a):
    return (a == 0).all(dim=-1).all(dim=-1)


def fp2_select(mask, x, y):
    return torch.where(mask[..., None, None], x, y)


# --- Fp6 -------------------------------------------------------------------


def _split3(a):
    return a[..., 0, :, :], a[..., 1, :, :], a[..., 2, :, :]


def fp6_add(a, b):
    return fp.add(a, b)


def fp6_sub(a, b):
    return fp.sub(a, b)


def fp6_neg(a):
    return fp.neg(a)


def fp6_mul(a, b):
    """Karatsuba-3: 6 stacked Fp2 muls (18 Fp muls in one call)."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1, a2 = _split3(a)
    b0, b1, b2 = _split3(b)
    lhs = torch.stack(
        [a0, a1, a2, fp.add(a1, a2), fp.add(a0, a1), fp.add(a0, a2)]
    )
    rhs = torch.stack(
        [b0, b1, b2, fp.add(b1, b2), fp.add(b0, b1), fp.add(b0, b2)]
    )
    v = fp2_mul(lhs, rhs)
    v0, v1, v2, v12, v01, v02 = (v[i] for i in range(6))
    c0 = fp.add(v0, fp2_mul_xi(fp.sub(v12, fp.add(v1, v2))))
    c1 = fp.add(fp.sub(v01, fp.add(v0, v1)), fp2_mul_xi(v2))
    c2 = fp.add(fp.sub(v02, fp.add(v0, v2)), v1)
    return torch.stack([c0, c1, c2], dim=-3)


def fp6_mul_v(a):
    """Multiply by v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    a0, a1, a2 = _split3(a)
    return torch.stack([fp2_mul_xi(a2), a0, a1], dim=-3)


def fp6_inv(a):
    a0, a1, a2 = _split3(a)
    sq = fp2_mul(torch.stack([a0, a2, a1]), torch.stack([a0, a2, a1]))
    cr = fp2_mul(torch.stack([a1, a0, a0]), torch.stack([a2, a1, a2]))
    t0 = fp.sub(sq[0], fp2_mul_xi(cr[0]))  # a0^2 - xi a1 a2
    t1 = fp.sub(fp2_mul_xi(sq[1]), cr[1])  # xi a2^2 - a0 a1
    t2 = fp.sub(sq[2], cr[2])  # a1^2 - a0 a2
    m = fp2_mul(torch.stack([a0, a2, a1]), torch.stack([t0, t1, t2]))
    norm = fp.add(m[0], fp2_mul_xi(fp.add(m[1], m[2])))
    ninv = fp2_inv(norm)
    out = fp2_mul(torch.stack([t0, t1, t2]), torch.stack([ninv, ninv, ninv]))
    return torch.stack([out[0], out[1], out[2]], dim=-3)


def fp6_zero(batch_shape=(), device="cpu"):
    return torch.zeros((*batch_shape, 3, 2, fp.N_LIMBS), dtype=torch.int32,
                       device=device)


def fp6_one(batch_shape=(), device="cpu"):
    return torch.stack(
        [fp2_one(batch_shape, device), fp2_zero(batch_shape, device),
         fp2_zero(batch_shape, device)],
        dim=-3,
    )


# --- Fp12 ------------------------------------------------------------------


def _split12(a):
    return a[..., 0, :, :, :], a[..., 1, :, :, :]


def fp12_add(a, b):
    return fp.add(a, b)


def fp12_sub(a, b):
    return fp.sub(a, b)


def fp12_mul(a, b):
    """The Fp12 product: one fused kernel launch for CUDA tensors, the
    plain composition for CPU tensors."""
    if a.is_cpu and b.is_cpu:
        return fp12_mul_reference(a, b)
    return K_FP12.fp12_mul(a, b)


def fp12_mul_reference(a, b):
    """Karatsuba-2 over Fp6: 3 stacked Fp6 muls = one 54-product call."""
    a, b = torch.broadcast_tensors(a, b)
    a0, a1 = _split12(a)
    b0, b1 = _split12(b)
    lhs = torch.stack([a0, a1, fp.add(a0, a1)])
    rhs = torch.stack([b0, b1, fp.add(b0, b1)])
    v = fp6_mul(lhs, rhs)
    c0 = fp.add(v[0], fp6_mul_v(v[1]))  # w^2 = v
    c1 = fp.sub(v[2], fp.add(v[0], v[1]))
    return torch.stack([c0, c1], dim=-4)


def fp12_sqr(a):
    """The Fp12 square, dispatched as ``fp12_mul``; on the card it is the
    fused product kernel on (a, a)."""
    if a.is_cpu:
        return fp12_sqr_reference(a)
    return K_FP12.fp12_mul(a, a)


def fp12_sqr_reference(a):
    """Complex-method squaring: (a0 + a1 w)^2 with w^2 = v needs only
    TWO Fp6 products (vs three for a general mul):

        v0 = a0 a1
        c0 = (a0 + a1)(a0 + v a1) - v0 - v v0
        c1 = 2 v0

    Both products are independent and stack into one 36-product call.
    """
    a0, a1 = _split12(a)
    va1 = fp6_mul_v(a1)
    lhs = torch.stack([a0, fp.add(a0, a1)])
    rhs = torch.stack([a1, fp.add(a0, va1)])
    m = fp6_mul(lhs, rhs)
    v0, cross = m[0], m[1]
    c0 = fp.sub(fp.sub(cross, v0), fp6_mul_v(v0))
    c1 = fp.add(v0, v0)
    return torch.stack([c0, c1], dim=-4)


def fp12_conj(a):
    """x -> x^(p^6): negate the w coefficient."""
    a0, a1 = _split12(a)
    return torch.stack([a0, fp.neg(a1)], dim=-4)


def fp12_cyclo_sqr(a):
    """One cyclotomic squaring, dispatched as ``fp12_mul``."""
    return fp12_cyclo_sqr_n(a, 1)


def fp12_cyclo_sqr_n(a, n):
    """``n`` cyclotomic squarings in a row, a^(2^n) for unitary a: one
    fused kernel launch for a CUDA tensor, ``n`` calls of
    ``fp12_cyclo_sqr_reference`` for a CPU tensor."""
    if not a.is_cpu:
        return K_CYCLO.fp12_cyclo_sqr_n(a, n)
    for _ in range(n):
        a = fp12_cyclo_sqr_reference(a)
    return a


def fp12_cyclo_sqr_reference(a):
    """Granger-Scott squaring for UNITARY elements (the cyclotomic
    subgroup every final-exp intermediate lives in after the easy part):
    9 Fp2 squarings in ONE stacked mont_mul — 18 Fp products vs the 36
    of the generic fp12_sqr.

    With w^2 = v, v^3 = xi the tower is also Fp12 = Fp2[w]/(w^6 - xi);
    for unitary z the Fp4 squarings collapse to the identities below
    (c_i are the Fp2 coefficients
    z = (c0 + c1 v + c2 v^2) + (c3 + c4 v + c5 v^2) w).
    """
    c0 = a[..., 0, 0, :, :]
    c1 = a[..., 0, 1, :, :]
    c2 = a[..., 0, 2, :, :]
    c3 = a[..., 1, 0, :, :]
    c4 = a[..., 1, 1, :, :]
    c5 = a[..., 1, 2, :, :]
    # 9 independent Fp2 squarings, one stacked call
    sq = fp2_sqr(torch.stack([
        c4, c0, fp.add(c4, c0),
        c3, c2, fp.add(c3, c2),
        c5, c1, fp.add(c5, c1),
    ]))
    s_c4, s_c0, s_40 = sq[0], sq[1], sq[2]
    s_c3, s_c2, s_32 = sq[3], sq[4], sq[5]
    s_c5, s_c1, s_51 = sq[6], sq[7], sq[8]
    t6 = fp.sub(s_40, fp.add(s_c4, s_c0))  # 2 c0 c4
    t7 = fp.sub(s_32, fp.add(s_c3, s_c2))  # 2 c2 c3
    t8 = fp2_mul_xi(fp.sub(s_51, fp.add(s_c5, s_c1)))  # 2 xi c1 c5
    t0 = fp.add(fp2_mul_xi(s_c4), s_c0)  # xi c4^2 + c0^2
    t2 = fp.add(fp2_mul_xi(s_c2), s_c3)  # xi c2^2 + c3^2
    t4 = fp.add(fp2_mul_xi(s_c5), s_c1)  # xi c5^2 + c1^2
    z0 = fp.add(fp.add(fp.sub(t0, c0), fp.sub(t0, c0)), t0)
    z1 = fp.add(fp.add(fp.sub(t2, c1), fp.sub(t2, c1)), t2)
    z2 = fp.add(fp.add(fp.sub(t4, c2), fp.sub(t4, c2)), t4)
    z3 = fp.add(fp.add(fp.add(t8, c3), fp.add(t8, c3)), t8)
    z4 = fp.add(fp.add(fp.add(t6, c4), fp.add(t6, c4)), t6)
    z5 = fp.add(fp.add(fp.add(t7, c5), fp.add(t7, c5)), t7)
    lo = torch.stack([z0, z1, z2], dim=-3)
    hi = torch.stack([z3, z4, z5], dim=-3)
    return torch.stack([lo, hi], dim=-4)


def fp12_inv(a):
    a0, a1 = _split12(a)
    sq = fp6_mul(torch.stack([a0, a1]), torch.stack([a0, a1]))
    norm = fp.sub(sq[0], fp6_mul_v(sq[1]))
    ninv = fp6_inv(norm)
    out = fp6_mul(torch.stack([a0, a1]), torch.stack([ninv, ninv]))
    return torch.stack([out[0], fp6_neg(out[1])], dim=-4)


def fp12_zero(batch_shape=(), device="cpu"):
    return torch.zeros((*batch_shape, 2, 3, 2, fp.N_LIMBS),
                       dtype=torch.int32, device=device)


def fp12_one(batch_shape=(), device="cpu"):
    return torch.stack([fp6_one(batch_shape, device),
                        fp6_zero(batch_shape, device)], dim=-4)


def fp12_select(mask, x, y):
    return torch.where(mask[..., None, None, None, None], x, y)


# --- Frobenius -------------------------------------------------------------

# FROB_GAMMA[k-1][m] = xi^(m (p^k - 1)/6) as Fp2; coefficient of w^i v^j
# gets multiplied by gamma_k[i + 2 j] after k-fold conjugation.
_GAMMA = np.array(C.FROB_GAMMA, dtype=np.int32)  # (3, 6, 2, 32)

# rearranged to (k, i_w, j_v, 2, 32) with m = i + 2 j
_GAMMA_TENSOR = torch.from_numpy(np.ascontiguousarray(np.stack(
    [
        np.stack([_GAMMA[:, 0 + 2 * j] for j in range(3)], axis=1),  # i=0
        np.stack([_GAMMA[:, 1 + 2 * j] for j in range(3)], axis=1),  # i=1
    ],
    axis=1,
)))  # (3, 2, 3, 2, 32)


def fp12_frobenius(a, k=1):
    """a^(p^k) for k = 1, 2, 3 via precomputed gamma constants."""
    if k not in (1, 2, 3):
        raise ValueError("frobenius power must be 1, 2 or 3")
    if k % 2 == 1:
        # conjugate every Fp2 coefficient (negate u-part)
        a0 = a[..., 0:1, :]
        a1 = fp.neg(a[..., 1:2, :])
        a = torch.cat([a0, a1], dim=-2)
    return fp2_mul(a, fp.on_device(_GAMMA_TENSOR, a.device)[k - 1])


def fp12_pow(a, exponent_bits):
    """a^e for a static MSB-first bit sequence (host bits: a zero bit
    skips its multiply)."""
    acc = fp12_one(a.shape[:-4], a.device)
    for bit in exponent_bits:
        acc = fp12_sqr(acc)
        if bit:
            acc = fp12_mul(acc, a)
    return acc
