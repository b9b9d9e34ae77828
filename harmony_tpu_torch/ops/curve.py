"""Batched Jacobian group law on G1 (over Fp) and G2 (over the Fp2 twist).

Design, as in the JAX package:
- Jacobian coordinates (X, Y, Z), infinity encoded as Z = 0 — the group
  law is branchless: both the add and double results are computed and the
  special cases (either operand at infinity, P + P, P + (-P)) are fixed up
  with vectorized selects, so one pass serves the whole batch.
- a = 0 short-Weierstrass formulas (dbl-2009-l / add-2007-bl structure),
  with independent products stacked into shared mont_mul calls (4 stacked
  calls per double, 6 per add).
- Generic over the coordinate field via a small op table; G1 and G2 share
  all the code.
- The masked sum over G1 (``FP_OPS``) dispatches on its tensors' device:
  a CUDA tensor launches the hand-written kernel of
  ``kernels/g1_masked_sum.py`` (the select, padding, tree and, in
  ``masked_sum_to_affine``, the affine form, in one launch) or raises; a
  CPU tensor runs the plain ``masked_sum_reference`` (and ``to_affine``).
  Over G2 the plain body runs everywhere.
"""

import numpy as np
import torch

from ..kernels import g1_masked_sum as K_G1
from . import _constants as C
from . import fp
from . import towers as T


class FieldOps:
    """Vectorized field-op table the generic group law is written against.

    ``one(shape, device)`` and ``zero(shape, device)`` build constants of
    the coordinate field with the given batch shape."""

    def __init__(self, *, mul, sqr, add, sub, neg, inv, is_zero, select,
                 one, zero, coord_axes):
        self.mul, self.sqr = mul, sqr
        self.add, self.sub, self.neg = add, sub, neg
        self.inv, self.is_zero, self.select = inv, is_zero, select
        self.one, self.zero = one, zero
        # number of trailing axes of one field element (1 for Fp, 2 for Fp2)
        self.coord_axes = coord_axes

    def dbl_(self, a):
        return self.add(a, a)

    def stack(self, items):
        return torch.stack(items)


FP_OPS = FieldOps(
    mul=fp.mont_mul,
    sqr=fp.sqr,
    add=fp.add,
    sub=fp.sub,
    neg=fp.neg,
    inv=fp.inv,
    is_zero=fp.is_zero,
    select=fp.select,
    one=lambda shape=(), device="cpu": fp.on_device(fp.ONE_MONT, device)
    .expand(*shape, fp.N_LIMBS),
    zero=lambda shape=(), device="cpu": torch.zeros(
        (*shape, fp.N_LIMBS), dtype=torch.int32, device=device),
    coord_axes=1,
)

FP2_OPS = FieldOps(
    mul=T.fp2_mul,
    sqr=T.fp2_sqr,
    add=T.fp2_add,
    sub=T.fp2_sub,
    neg=T.fp2_neg,
    inv=T.fp2_inv,
    is_zero=T.fp2_is_zero,
    select=T.fp2_select,
    one=T.fp2_one,
    zero=T.fp2_zero,
    coord_axes=2,
)


def _coords(pt, ops):
    """Split a point tensor (..., 3, <field>) into X, Y, Z."""
    return pt.unbind(dim=-(ops.coord_axes + 1))


def _point(x, y, z, ops):
    return torch.stack([x, y, z], dim=-(ops.coord_axes + 1))


def infinity(ops, batch_shape=(), device="cpu"):
    """Canonical infinity (1, 1, 0)."""
    one = ops.one(batch_shape, device)
    return _point(one, one, ops.zero(batch_shape, device), ops)


def _select_point(mask, a, b, ops):
    return torch.where(mask[(...,) + (None,) * (ops.coord_axes + 1)], a, b)


def dbl(pt, ops):
    """Jacobian doubling, a = 0 (dbl-2009-l).  Handles infinity (Z3 = 0
    follows from Z = 0 automatically)."""
    x, y, z = _coords(pt, ops)
    s1 = ops.sqr(ops.stack([x, y]))
    a, b = s1[0], s1[1]  # X^2, Y^2
    s2 = ops.sqr(ops.stack([b, ops.add(x, b)]))
    c, t = s2[0], s2[1]  # Y^4, (X + Y^2)^2
    d = ops.dbl_(ops.sub(ops.sub(t, a), c))  # 2((X+B)^2 - A - C)
    e = ops.add(ops.dbl_(a), a)  # 3 X^2
    m = ops.mul(ops.stack([e, y]), ops.stack([e, z]))
    f, yz = m[0], m[1]  # E^2, Y Z
    x3 = ops.sub(f, ops.dbl_(d))
    y3_part = ops.mul(e, ops.sub(d, x3))
    c8 = ops.dbl_(ops.dbl_(ops.dbl_(c)))
    y3 = ops.sub(y3_part, c8)
    z3 = ops.dbl_(yz)
    return _point(x3, y3, z3, ops)


def add(p1, p2, ops, handle_equal=True):
    """Branchless Jacobian addition (add-2007-bl structure) with select-based
    handling of infinity / equal / opposite inputs.

    ``handle_equal=False`` drops the embedded doubling for callers that
    can prove p1 != p2 for finite inputs.
    """
    x1, y1, z1 = _coords(p1, ops)
    x2, y2, z2 = _coords(p2, ops)

    s = ops.sqr(ops.stack([z1, z2]))
    z1z1, z2z2 = s[0], s[1]
    m = ops.mul(
        ops.stack([x1, x2, z2, z1]),
        ops.stack([z2z2, z1z1, z2z2, z1z1]),
    )
    u1, u2, t1, t2 = m[0], m[1], m[2], m[3]
    m = ops.mul(ops.stack([y1, y2]), ops.stack([t1, t2]))
    s1, s2 = m[0], m[1]

    h = ops.sub(u2, u1)
    r = ops.dbl_(ops.sub(s2, s1))
    s = ops.sqr(ops.stack([ops.dbl_(h), r, ops.add(z1, z2)]))
    i, rsq, zz = s[0], s[1], s[2]
    m = ops.mul(ops.stack([h, u1]), ops.stack([i, i]))
    j, v = m[0], m[1]
    x3 = ops.sub(ops.sub(rsq, j), ops.dbl_(v))
    m = ops.mul(
        ops.stack([r, s1, ops.sub(ops.sub(zz, z1z1), z2z2)]),
        ops.stack([ops.sub(v, x3), j, h]),
    )
    y3 = ops.sub(m[0], ops.dbl_(m[1]))
    z3 = m[2]
    added = _point(x3, y3, z3, ops)

    p1_inf = ops.is_zero(z1)
    p2_inf = ops.is_zero(z2)
    both_finite = ~p1_inf & ~p2_inf
    same_x = ops.is_zero(h) & both_finite
    same_y = ops.is_zero(r)

    out = added
    if handle_equal:
        out = _select_point(same_x & same_y, dbl(p1, ops), out, ops)
    out = _select_point(
        same_x & ~same_y,
        infinity(ops, _batch_shape(p1, ops), p1.device), out, ops
    )
    out = _select_point(p1_inf, p2, out, ops)
    out = _select_point(p2_inf & ~p1_inf, p1, out, ops)
    return out


def _batch_shape(pt, ops):
    return pt.shape[: pt.dim() - (ops.coord_axes + 1)]


def to_affine(pt, ops):
    """Jacobian -> affine (x, y); infinity maps to (0, 0)."""
    x, y, z = _coords(pt, ops)
    inf = ops.is_zero(z)
    zi = ops.inv(z)
    zi2 = ops.sqr(zi)
    m = ops.mul(ops.stack([x, ops.mul(y, zi)]), ops.stack([zi2, zi2]))
    ax, ay = m[0], m[1]
    zero = torch.zeros_like(ax)
    inf = inf[(...,) + (None,) * ops.coord_axes]
    return torch.where(inf, zero, ax), torch.where(inf, zero, ay)


def masked_sum(points, mask, ops):
    """Sum of points[i] where mask[i] == 1, via log-depth tree reduction.

    ``points`` has the batch axis FIRST: (N, ..., 3, <field>); over G1 they
    may also be affine, (N, ..., 2, 32) with (0, 0) for infinity (the
    resident key table).  ``mask`` is (N,) or, for B sums over one
    committee at once, (N, B) with points (N, 1, 3 or 2, <field>).  Over
    G1, a tensor off the CPU goes to the kernel's wrapper, which launches
    it (the sum alone, no affine form) or raises; everything else runs
    ``masked_sum_reference``.
    """
    if ops is FP_OPS:
        if not points.is_cpu:
            return K_G1.g1_masked_sum(
                points, torch.as_tensor(mask, device=points.device),
                affine=False)[0]
        if points.shape[-2] == 2:
            points = affine_to_jacobian_g1(points)
    return masked_sum_reference(points, mask, ops)


def masked_sum_to_affine(points, mask):
    """``to_affine(masked_sum(points, mask, FP_OPS))`` over G1, stacked as
    (..., 2, 32), infinity as (0, 0).  ``points`` are Jacobian (..., 3, 32)
    or affine (..., 2, 32) with (0, 0) for infinity, shaped as
    ``masked_sum`` takes them.  One kernel launch for a tensor off the
    CPU; ``masked_sum_to_affine_reference`` for a CPU tensor."""
    if not points.is_cpu:
        return K_G1.g1_masked_sum(
            points, torch.as_tensor(mask, device=points.device))[1]
    return masked_sum_to_affine_reference(points, mask)


def masked_sum_to_affine_reference(points, mask):
    """The plain version of ``masked_sum_to_affine``."""
    if points.shape[-2] == 2:
        points = affine_to_jacobian_g1(points)
    ax, ay = to_affine(masked_sum_reference(points, mask, FP_OPS), FP_OPS)
    return torch.stack([ax, ay], dim=-2)


def masked_sum_reference(points, mask, ops):
    """The plain ``masked_sum``: the JAX package's body, with the (N, B)
    mask form that the JAX package gets from vmap written out."""
    n = points.shape[0]
    mask = torch.as_tensor(mask, device=points.device)
    shape = tuple(mask.shape)
    pts = _select_point(
        mask.to(torch.int32) == 1,
        points,
        infinity(ops, shape, points.device),
        ops,
    )
    # pad to a power of two with infinity
    size = 1
    while size < n:
        size *= 2
    if size != n:
        pad = infinity(ops, (size - n,) + shape[1:], points.device)
        pts = torch.cat([pts, pad])
    while size > 1:
        half = size // 2
        pts = add(pts[:half], pts[half:size], ops)
        size = half
    return pts[0]


def affine_to_jacobian_g1(aff):
    """Affine G1 points (..., 2, 32) as Jacobian (..., 3, 32): Z = 1, and
    (0, 0) (infinity) as (0, 0, 0)."""
    x = aff[..., 0, :]
    y = aff[..., 1, :]
    finite = ~(fp.is_zero(x) & fp.is_zero(y))
    one = fp.on_device(fp.ONE_MONT, x.device).expand(x.shape)
    z = torch.where(finite[..., None], one, torch.zeros_like(one))
    return torch.stack([x, y, z], dim=-2)


# --- generators ------------------------------------------------------------

G1_GEN = torch.from_numpy(
    np.stack(
        [
            np.array(C.G1_GEN_MONT[0], dtype=np.int32),
            np.array(C.G1_GEN_MONT[1], dtype=np.int32),
            np.array(C.ONE_MONT, dtype=np.int32),
        ]
    )
)

G2_GEN = torch.from_numpy(
    np.stack(
        [
            np.array(C.G2_GEN_X_MONT, dtype=np.int32),
            np.array(C.G2_GEN_Y_MONT, dtype=np.int32),
            np.stack(
                [np.array(C.ONE_MONT, dtype=np.int32),
                 np.zeros(fp.N_LIMBS, dtype=np.int32)]
            ),
        ]
    )
)
