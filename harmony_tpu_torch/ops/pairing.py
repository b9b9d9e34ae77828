"""Batched optimal ate pairing: Miller loop + final exponentiation.

The op the path exists for: one pairing check per FBFT vote, quorum
certificate and replayed header.  The same algorithm as the JAX package's
ops/pairing.py, step for step:

- Miller loop over the bits of |x| following its static square-and-
  multiply schedule (ops/schedule.py): 6 segments of double-steps, each
  but the last closed by an add-step.  The JAX package runs the schedule as a
  scan over segments with a fori_loop inside.  ``miller_loop`` dispatches
  on its tensors' device: a CUDA tensor runs the whole loop in one
  kernel launch (kernels/miller_loop.py), which raises if it cannot; a
  CPU tensor runs the plain ``miller_loop_reference``, where both loops
  are Python loops over the same host schedule.
- Twist-Jacobian line construction with denominator elimination; lines
  live in the sparse Fp12 basis {v^2, w, w v}.
- Final exponentiation to the power 3 (p^12 - 1)/r: the CUBED pairing,
  as in the JAX package and its bigint reference.  Easy part by
  conjugate / inverse / Frobenius^2, hard part by the x-chain with
  cyclotomic squarings.  ``final_exponentiation`` dispatches as
  ``miller_loop`` does: a CUDA tensor runs the whole of it in one kernel
  launch (kernels/final_exp.py); a CPU tensor runs the plain
  ``final_exponentiation_reference``, one run of squarings per call (the
  JAX package's fori_loop inside its scan).

Batching: points are batched over leading axes; products of pairings
(the aggregate-verify shape) share one final exponentiation.
"""

import torch

from ..kernels import final_exp as K_FINAL_EXP
from ..kernels import miller_loop as K_MILLER
from . import fp
from . import towers as T
from .schedule import X_SCHED, XM1_SCHED


def _fp2_scale_fp(a, s):
    """Multiply an Fp2 element (..., 2, 32) by an Fp scalar (..., 32)."""
    return fp.mont_mul(a, s[..., None, :])


def _small(a, k):
    """Multiply by a tiny integer constant via doubling chains."""
    if k == 2:
        return fp.add(a, a)
    if k == 3:
        return fp.add(fp.add(a, a), a)
    if k == 8:
        t2 = fp.add(a, a)
        t4 = fp.add(t2, t2)
        return fp.add(t4, t4)
    raise ValueError(k)


def _sparse_line_to_fp12(c_v2, c_w, c_wv):
    """Assemble c_v2*v^2 + c_w*w + c_wv*(w v) into a dense Fp12 tensor."""
    z = torch.zeros_like(c_v2)
    c0 = torch.stack([z, z, c_v2], dim=-3)  # coefficients of 1, v, v^2
    c1 = torch.stack([c_w, c_wv, z], dim=-3)  # w, w v, w v^2
    return torch.stack([c0, c1], dim=-4)


def _dbl_step(x, y, z, xp3, yp2):
    """Twist-Jacobian doubling + tangent line at P (precomputed 3xp, 2yp)."""
    sq = T.fp2_sqr(torch.stack([x, y, z]))
    xsq, ysq, zsq = sq[0], sq[1], sq[2]
    m = T.fp2_mul(torch.stack([zsq, xsq]), torch.stack([z, x]))
    z3p, x3p = m[0], m[1]  # Z^3, X^3
    m = T.fp2_mul(
        torch.stack([T.fp2_add(y, y), xsq]),
        torch.stack([z3p, zsq]),
    )
    c_v2 = _fp2_scale_fp(m[0], yp2)  # 2 Y Z^3 * yp  (yp2 = yp, x2 folded)
    c_wv = fp.neg(_fp2_scale_fp(m[1], xp3))  # -3 X^2 Z^2 * xp
    c_w = fp.sub(_small(x3p, 3), _small(ysq, 2))  # 3 X^3 - 2 Y^2
    # dbl-2009-l
    b = ysq
    csq = T.fp2_sqr(torch.stack([b, T.fp2_add(x, b)]))
    c, t = csq[0], csq[1]
    d = _small(fp.sub(fp.sub(t, xsq), c), 2)
    e = _small(xsq, 3)
    m = T.fp2_mul(torch.stack([e, y]), torch.stack([e, z]))
    f_, yz = m[0], m[1]
    x3 = fp.sub(f_, _small(d, 2))
    y3 = fp.sub(T.fp2_mul(e, fp.sub(d, x3)), _small(c, 8))
    z3 = _small(yz, 2)
    return (x3, y3, z3), (c_v2, c_w, c_wv)


def _add_step(x, y, z, xq, yq, xp_m, yp_m):
    """Twist-Jacobian mixed addition of the affine base Q + chord line."""
    zsq = T.fp2_sqr(z)
    z3p = T.fp2_mul(zsq, z)
    m = T.fp2_mul(torch.stack([yq, xq]), torch.stack([z3p, zsq]))
    s2, u2 = m[0], m[1]
    num = fp.sub(y, s2)  # Y - yq Z^3
    h = fp.sub(u2, x)
    den = T.fp2_mul(z, fp.neg(h))  # Z (X - xq Z^2) = -Z*H
    c_v2 = _fp2_scale_fp(den, yp_m)
    c_wv = fp.neg(_fp2_scale_fp(num, xp_m))
    m = T.fp2_mul(torch.stack([xq, yq]), torch.stack([num, den]))
    c_w = fp.sub(m[0], m[1])
    # madd-2007-bl (Z2 = 1)
    r = _small(fp.sub(s2, y), 2)
    sq = T.fp2_sqr(torch.stack([_small(h, 2), r, T.fp2_add(z, h)]))
    i, rsq, zh = sq[0], sq[1], sq[2]
    m = T.fp2_mul(torch.stack([h, x]), torch.stack([i, i]))
    j, v = m[0], m[1]
    x3 = fp.sub(fp.sub(rsq, j), _small(v, 2))
    m = T.fp2_mul(torch.stack([r, y]), torch.stack([fp.sub(v, x3), j]))
    y3 = fp.sub(m[0], _small(m[1], 2))
    z3 = fp.sub(fp.sub(zh, zsq), T.fp2_sqr(h))
    return (x3, y3, z3), (c_v2, c_w, c_wv)


@torch.inference_mode()
def miller_loop(p_aff, q_aff):
    """f_{|x|,Q}(P), conjugated for x < 0: one kernel launch for CUDA
    tensors, the plain ``miller_loop_reference`` for CPU tensors.  Finite
    affine inputs (an infinity lane, (0, 0), gives a value that the
    caller masks): p_aff (..., 2, 32) over Fp, q_aff (..., 2, 2, 32) over
    Fp2."""
    if p_aff.is_cpu and q_aff.is_cpu:
        return miller_loop_reference(p_aff, q_aff)
    return K_MILLER.miller_loop(p_aff, q_aff)


@torch.inference_mode()
def miller_loop_reference(p_aff, q_aff):
    """The plain PyTorch Miller loop over the Fp and Fp12 dispatchers.

    Follows |x|'s static schedule: each segment runs its double-steps,
    then the add-step where the schedule has one (the JAX package
    computes the last segment's add-step and masks it off; the result is
    the same)."""
    xp = p_aff[..., 0, :]
    yp = p_aff[..., 1, :]
    xq = q_aff[..., 0, :, :]
    yq = q_aff[..., 1, :, :]
    xp3 = _small(xp, 3)
    batch = xp.shape[:-1]
    f = T.fp12_one(batch, xp.device)
    x, y, z = xq, yq, T.fp2_one(batch, xp.device)
    for n_dbl, do_add in zip(*X_SCHED):
        for _ in range(n_dbl):
            (x, y, z), (c_v2, c_w, c_wv) = _dbl_step(x, y, z, xp3, yp)
            f = T.fp12_mul(T.fp12_sqr(f),
                           _sparse_line_to_fp12(c_v2, c_w, c_wv))
        if do_add:
            (x, y, z), (a_v2, a_w, a_wv) = _add_step(x, y, z, xq, yq, xp, yp)
            f = T.fp12_mul(f, _sparse_line_to_fp12(a_v2, a_w, a_wv))
    return T.fp12_conj(f)


def _cyclo_pow_abs(a, sched):
    """a^e for a STATIC positive exponent given as its square-and-
    multiply schedule, with Granger-Scott cyclotomic squarings — valid
    only for unitary a (everything after the easy part)."""
    acc = a
    for n_sqr, do_mul in zip(*sched):
        acc = T.fp12_cyclo_sqr_n(acc, n_sqr)  # one launch on the card
        if do_mul:
            acc = T.fp12_mul(acc, a)
    return acc


@torch.inference_mode()
def final_exponentiation(f):
    """f^(3 (p^12-1)/r): one kernel launch for a CUDA tensor, the plain
    ``final_exponentiation_reference`` for a CPU tensor."""
    if f.is_cpu:
        return final_exponentiation_reference(f)
    return K_FINAL_EXP.final_exp(f)


@torch.inference_mode()
def final_exponentiation_reference(f):
    """The plain PyTorch f^(3 (p^12-1)/r) over the Fp and Fp12
    dispatchers: easy part exactly, hard part by the x-chain.

    Hard part uses 3 lambda = (x-1)^2 (x+p)(x^2+p^2-1) + 3; the cubed
    pairing is the framework's canonical pairing.  Inversions after the
    easy part are conjugations (unitary elements), squarings are
    cyclotomic, and the x-powers follow |x|'s static schedule.
    """
    f1 = T.fp12_mul(T.fp12_conj(f), T.fp12_inv(f))  # ^(p^6 - 1)
    f2 = T.fp12_mul(T.fp12_frobenius(f1, 2), f1)  # ^(p^2 + 1), unitary now
    m1 = T.fp12_conj(_cyclo_pow_abs(f2, XM1_SCHED))  # f2^(x-1)
    m2 = T.fp12_conj(_cyclo_pow_abs(m1, XM1_SCHED))  # ^(x-1)^2
    m3 = T.fp12_mul(
        T.fp12_conj(_cyclo_pow_abs(m2, X_SCHED)),  # m2^x
        T.fp12_frobenius(m2, 1),  # m2^p
    )
    m3_x2 = _cyclo_pow_abs(
        _cyclo_pow_abs(m3, X_SCHED), X_SCHED
    )  # m3^(x^2) — two |x| powers; the two conjugations cancel
    m4 = T.fp12_mul(
        T.fp12_mul(m3_x2, T.fp12_frobenius(m3, 2)),
        T.fp12_conj(m3),  # m3^-1 (unitary)
    )
    return T.fp12_mul(m4, T.fp12_mul(T.fp12_sqr(f2), f2))  # * f2^3


@torch.inference_mode()
def pairing(p_aff, q_aff):
    """Batched full pairing e(P, Q)."""
    return final_exponentiation(miller_loop(p_aff, q_aff))


@torch.inference_mode()
def pairing_product(p_aff, q_aff):
    """prod_k e(P_k, Q_k) over the FIRST axis, one shared final
    exponentiation — the aggregate-verify shape."""
    fs = miller_loop(p_aff, q_aff)  # (K, ..., fp12)
    return final_exponentiation(fp12_tree_reduce(fs))


def fp12_tree_reduce(fs):
    """Log-depth product of Fp12 elements over the first axis."""
    while fs.shape[0] > 1:
        k = fs.shape[0]
        half = k // 2
        merged = T.fp12_mul(fs[:half], fs[half: 2 * half])
        fs = torch.cat([merged, fs[2 * half:]]) if k % 2 else merged
    return fs[0]


def is_one(gt):
    """Boolean mask: GT element == 1 (canonical Montgomery digits)."""
    one = T.fp12_one(gt.shape[:-4], gt.device)
    return (gt == one).flatten(-4).all(dim=-1)
