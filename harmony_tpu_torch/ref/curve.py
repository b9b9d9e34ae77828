"""Affine group law on BLS12-381's G1, G2 and E(Fp12), over bigints.

Points are ``(x, y)`` tuples in the respective field, with ``None`` as the
point at infinity.  All three curves share a = 0 short-Weierstrass form:

    E  / Fp  : y^2 = x^3 + 4            (G1)
    E' / Fp2 : y^2 = x^3 + 4 (u + 1)    (G2, M-twist)
    E  / Fp12: y^2 = x^3 + 4            (untwist target for pairing)

Mirrors the reference's use of herumi G1/G2 ops (PublicKey.Add/Sub,
Sign.Add — reference: crypto/bls/mask.go:113-153, consensus/quorum/
quorum.go:164-196).  The port's own copy: it builds committee keys and
signatures, clears the G2 cofactor of hashed payloads (hash_to_curve.py)
and serves the host pairing (pairing.py); the batched group law runs on
tensors in ops/curve.py.
"""

from . import fields as F
from .params import B_G1, G1_X, G1_Y, G2_X, G2_Y, H1, H2, P, R_ORDER, XI


class CurveOps:
    """Affine a=0 curve over a field described by a small op table."""

    def __init__(self, add, sub, mul, inv, neg, zero, one, b):
        self.fadd, self.fsub, self.fmul = add, sub, mul
        self.finv, self.fneg = inv, neg
        self.zero, self.one, self.b = zero, one, b

    def is_on_curve(self, pt):
        if pt is None:
            return True
        x, y = pt
        lhs = self.fmul(y, y)
        rhs = self.fadd(self.fmul(self.fmul(x, x), x), self.b)
        return lhs == rhs

    def neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.fneg(pt[1]))

    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 != y2 or y1 == self.zero:
                return None  # p1 == -p2
            return self.dbl(p1)
        lam = self.fmul(self.fsub(y2, y1), self.finv(self.fsub(x2, x1)))
        x3 = self.fsub(self.fsub(self.fmul(lam, lam), x1), x2)
        y3 = self.fsub(self.fmul(lam, self.fsub(x1, x3)), y1)
        return (x3, y3)

    def dbl(self, pt):
        if pt is None:
            return None
        x, y = pt
        if y == self.zero:
            return None
        three_x2 = self.fmul(self.fadd(self.fadd(x, x), x), x)
        lam = self.fmul(three_x2, self.finv(self.fadd(y, y)))
        x3 = self.fsub(self.fsub(self.fmul(lam, lam), x), x)
        y3 = self.fsub(self.fmul(lam, self.fsub(x, x3)), y)
        return (x3, y3)

    def mul(self, pt, k):
        """Scalar multiplication (double-and-add, MSB first).

        Scalars are NOT reduced mod r — cofactor clearing passes scalars
        far larger than the subgroup order.
        """
        if k < 0:
            return self.mul(self.neg(pt), -k)
        acc = None
        for bit in bin(k)[2:] if k else "":
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add(acc, pt)
        return acc


# --- concrete curves -------------------------------------------------------

g1 = CurveOps(
    add=F.fp_add,
    sub=F.fp_sub,
    mul=F.fp_mul,
    inv=F.fp_inv,
    neg=F.fp_neg,
    zero=0,
    one=1,
    b=B_G1 % P,
)

g2 = CurveOps(
    add=F.fp2_add,
    sub=F.fp2_sub,
    mul=F.fp2_mul,
    inv=F.fp2_inv,
    neg=F.fp2_neg,
    zero=F.FP2_ZERO,
    one=F.FP2_ONE,
    b=F.fp2_scalar(XI, B_G1),  # 4 (u + 1)
)

e12 = CurveOps(
    add=F.fp12_add,
    sub=F.fp12_sub,
    mul=F.fp12_mul,
    inv=F.fp12_inv,
    neg=lambda a: F.fp12_sub(F.FP12_ZERO, a),
    zero=F.FP12_ZERO,
    one=F.FP12_ONE,
    b=F.fp_to_fp12(B_G1),
)

G1_GEN = (G1_X, G1_Y)
G2_GEN = (G2_X, G2_Y)


# --- untwist E'(Fp2) -> E(Fp12) -------------------------------------------
# psi(x, y) = (x / w^2, y / w^3); with w^6 = xi this maps the M-twist onto
# E(Fp12): y^2 = x^3 + 4.  Precompute the two inverse powers of w once.

_W2_INV = F.fp12_inv(F.fp12_mul(F.FP12_W, F.FP12_W))
_W3_INV = F.fp12_inv(F.fp12_mul(F.fp12_mul(F.FP12_W, F.FP12_W), F.FP12_W))


def untwist(q):
    """Map a G2 (twist) point into E(Fp12)."""
    if q is None:
        return None
    x = F.fp12_mul(F.fp2_to_fp12(q[0]), _W2_INV)
    y = F.fp12_mul(F.fp2_to_fp12(q[1]), _W3_INV)
    return (x, y)


def g1_embed(p):
    """Embed a G1 point into E(Fp12) coordinate-wise."""
    if p is None:
        return None
    return (F.fp_to_fp12(p[0]), F.fp_to_fp12(p[1]))


def clear_cofactor_g1(pt):
    return g1.mul(pt, H1)


def clear_cofactor_g2(pt):
    return g2.mul(pt, H2)


__all__ = [
    "g1",
    "g2",
    "e12",
    "G1_GEN",
    "G2_GEN",
    "untwist",
    "g1_embed",
    "clear_cofactor_g1",
    "clear_cofactor_g2",
    "R_ORDER",
]
