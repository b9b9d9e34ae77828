"""Affine group law on BLS12-381's G1 and G2, over bigints.

Points are ``(x, y)`` tuples in the respective field, with ``None`` as the
point at infinity.  Both curves share a = 0 short-Weierstrass form:

    E  / Fp  : y^2 = x^3 + 4            (G1)
    E' / Fp2 : y^2 = x^3 + 4 (u + 1)    (G2, M-twist)

The port's host side: it builds committee keys and signatures and clears
the G2 cofactor of hashed payloads (hash_to_curve.py).  The batched group
law runs on tensors in ops/curve.py.
"""

from . import fields as F
from .params import B_G1, G1_X, G1_Y, G2_X, G2_Y, H2, P, XI


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

G1_GEN = (G1_X, G1_Y)
G2_GEN = (G2_X, G2_Y)


def clear_cofactor_g2(pt):
    return g2.mul(pt, H2)
