"""Optimal ate pairing on BLS12-381 over bigints (ground truth).

e(P, Q) for P in G1, Q in G2 is computed as f_{|x|, psi(Q)}(P) raised to
(p^12 - 1)/r, conjugated once because the BLS parameter x is negative.

This implementation optimises for auditability, not speed: the Miller loop
uses affine line functions on the untwisted curve E(Fp12), and the final
exponentiation's hard part is a generic square-and-multiply by the integer
(p^4 - p^2 + 1)/r.  The device path (ops/pairing.py and its kernels) uses
projective twist coordinates, sparse line multiplication and the
x-addition-chain hard part, and gives the same verdicts.  The port's own
copy: the host path that device.py falls back to when no native library
loads.

Replaces the reference's pairing entry points Sign.VerifyHash /
aggregate-verify (reference: consensus/leader.go:173, consensus/
validator.go:228, internal/chain/engine.go:640), which live inside herumi's
C++ mcl library.
"""

from . import fields as F
from .curve import e12, g1_embed, untwist
from .params import P, R_ORDER, X

_ABS_X_BITS = bin(-X)[2:]  # x < 0 for BLS12-381


def _line(t, r_pt, p_pt):
    """Evaluate at p_pt the line through t and r_pt (tangent if t == r_pt).

    All points are affine on E(Fp12).  Vertical lines (r == -t) evaluate as
    x_P - x_T; they appear only at the very last add step when the scalar is
    the group order, which |x| is not, but the case is handled for safety.
    """
    xt, yt = t
    xp, yp = p_pt
    if t == r_pt:
        # tangent: lambda = 3 x^2 / 2 y
        num = e12.fmul(F.fp_to_fp12(3), e12.fmul(xt, xt))
        den = e12.fmul(F.fp_to_fp12(2), yt)
    else:
        xr, yr = r_pt
        if xt == xr:
            return e12.fsub(xp, xt)  # vertical
        num = e12.fsub(yr, yt)
        den = e12.fsub(xr, xt)
    lam = e12.fmul(num, e12.finv(den))
    # l(P) = lambda (x_P - x_T) - (y_P - y_T)
    return e12.fsub(e12.fmul(lam, e12.fsub(xp, xt)), e12.fsub(yp, yt))


def miller_loop(p_pt, q_pt):
    """f_{|x|, Q'}(P') on E(Fp12); returns an Fp12 element (pre-final-exp)."""
    if p_pt is None or q_pt is None:
        return F.FP12_ONE
    pp = g1_embed(p_pt)
    qq = untwist(q_pt)
    f = F.FP12_ONE
    t = qq
    for bit in _ABS_X_BITS[1:]:
        f = F.fp12_mul(F.fp12_sqr(f), _line(t, t, pp))
        t = e12.dbl(t)
        if bit == "1":
            f = F.fp12_mul(f, _line(t, qq, pp))
            t = e12.add(t, qq)
    # x < 0: f_{-|x|} ~ conj(f_{|x|}) up to factors killed by the final exp.
    return F.fp12_conj(f)


def final_exponentiation(f):
    """f^(3 (p^12 - 1) / r) — the framework's canonical pairing power.

    Easy part: f^(p^6 - 1) = conj(f)/f, then ^(p^2 + 1) by generic pow.
    Hard part: generic pow by 3 (p^4 - p^2 + 1)/r.

    The CUBE of the textbook reduced pairing is used throughout (both
    here and the device path): the device hard part runs the x-addition chain
    3 lambda = (x-1)^2 (x+p)(x^2+p^2-1) + 3 (identity checked in
    tests), and since gcd(3, r) = 1 the cubed pairing is an equally
    valid bilinear non-degenerate pairing — standard practice for BLS12
    final-exponentiation chains.
    """
    f1 = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))  # ^(p^6 - 1)
    f2 = F.fp12_mul(F.fp12_pow(f1, P * P), f1)  # ^(p^2 + 1)
    hard = 3 * ((P**4 - P**2 + 1) // R_ORDER)
    return F.fp12_pow(f2, hard)


def pairing(p_pt, q_pt):
    """Full optimal ate pairing e(P, Q) in GT."""
    return final_exponentiation(miller_loop(p_pt, q_pt))


# --- projective-twist Miller loop (the device algorithm, validated here) ---
#
# The device kernel (ops/pairing.py) cannot afford per-step inversions, so it
# works on the twist in Jacobian coordinates with denominator-eliminated
# line functions.  Lines are scaled by arbitrary Fp2 factors (killed by the
# final exponentiation) and expressed in the sparse basis {v^2, w, w v}:
#
#   line*v^2 = yp*v^2 - (lambda xp)*(w v) + (lambda x_T - y_T)*w
#
# with, after clearing Jacobian denominators (T = (X, Y, Z), x = X/Z^2):
#   dbl:  c_v2 = 2 Y Z^3 yp,  c_w = 3 X^3 - 2 Y^2,  c_wv = -3 X^2 Z^2 xp
#   add:  c_v2 = yp Z (X - xq Z^2),  c_wv = -xp (Y - yq Z^3),
#         c_w = xq (Y - yq Z^3) - yq Z (X - xq Z^2)
#
# This bigint twin exists so the device implementation can be debugged
# step-by-step against exact integers; it agrees with the affine
# miller_loop after final exponentiation.


def _sparse_line_to_fp12(c_v2, c_w, c_wv):
    """Assemble c_v2*v^2 + c_w*w + c_wv*w*v as a full Fp12 element."""
    c0 = (F.FP2_ZERO, F.FP2_ZERO, c_v2)  # 1, v, v^2
    c1 = (c_w, c_wv, F.FP2_ZERO)  # w, w v, w v^2
    return (c0, c1)


def miller_loop_projective(p_pt, q_pt):
    """f_{|x|,Q}(P) with twist-Jacobian steps; equals miller_loop up to
    subfield factors (identical pairing after final exponentiation)."""
    if p_pt is None or q_pt is None:
        return F.FP12_ONE
    xp, yp = p_pt
    xq, yq = q_pt
    x, y, z = xq, yq, F.FP2_ONE  # Jacobian T = Q

    def dbl_step(x, y, z):
        # line coefficients
        zsq = F.fp2_sqr(z)
        z3 = F.fp2_mul(zsq, z)
        xsq = F.fp2_sqr(x)
        ysq = F.fp2_sqr(y)
        c_v2 = F.fp2_scalar(F.fp2_mul(y, z3), 2 * yp % P)
        c_w = F.fp2_sub(
            F.fp2_scalar(F.fp2_mul(xsq, x), 3), F.fp2_scalar(ysq, 2)
        )
        c_wv = F.fp2_neg(F.fp2_scalar(F.fp2_mul(xsq, zsq), 3 * xp % P))
        # dbl-2009-l
        a = xsq
        b = ysq
        c = F.fp2_sqr(b)
        d = F.fp2_scalar(
            F.fp2_sub(F.fp2_sub(F.fp2_sqr(F.fp2_add(x, b)), a), c), 2
        )
        e = F.fp2_scalar(a, 3)
        f_ = F.fp2_sqr(e)
        x3 = F.fp2_sub(f_, F.fp2_scalar(d, 2))
        y3 = F.fp2_sub(F.fp2_mul(e, F.fp2_sub(d, x3)), F.fp2_scalar(c, 8))
        z3_ = F.fp2_scalar(F.fp2_mul(y, z), 2)
        return (x3, y3, z3_), (c_v2, c_w, c_wv)

    def add_step(x, y, z):
        zsq = F.fp2_sqr(z)
        z3 = F.fp2_mul(zsq, z)
        num = F.fp2_sub(y, F.fp2_mul(yq, z3))  # Y - yq Z^3
        den = F.fp2_mul(z, F.fp2_sub(x, F.fp2_mul(xq, zsq)))  # Z(X - xq Z^2)
        c_v2 = F.fp2_scalar(den, yp)
        c_wv = F.fp2_neg(F.fp2_scalar(num, xp))
        c_w = F.fp2_sub(F.fp2_mul(xq, num), F.fp2_mul(yq, den))
        # Jacobian + affine (add-2007-bl with Z2 = 1)
        u2 = F.fp2_mul(xq, zsq)
        s2 = F.fp2_mul(yq, z3)
        h = F.fp2_sub(u2, x)
        r = F.fp2_scalar(F.fp2_sub(s2, y), 2)
        i = F.fp2_sqr(F.fp2_scalar(h, 2))
        j = F.fp2_mul(h, i)
        v = F.fp2_mul(x, i)
        x3 = F.fp2_sub(F.fp2_sub(F.fp2_sqr(r), j), F.fp2_scalar(v, 2))
        y3 = F.fp2_sub(
            F.fp2_mul(r, F.fp2_sub(v, x3)),
            F.fp2_scalar(F.fp2_mul(y, j), 2),
        )
        z3_ = F.fp2_sub(
            F.fp2_sub(F.fp2_sqr(F.fp2_add(z, h)), zsq), F.fp2_sqr(h)
        )
        return (x3, y3, z3_), (c_v2, c_w, c_wv)

    f = F.FP12_ONE
    for bit in _ABS_X_BITS[1:]:
        (x, y, z), (c_v2, c_w, c_wv) = dbl_step(x, y, z)
        f = F.fp12_mul(F.fp12_sqr(f), _sparse_line_to_fp12(c_v2, c_w, c_wv))
        if bit == "1":
            (x, y, z), (c_v2, c_w, c_wv) = add_step(x, y, z)
            f = F.fp12_mul(f, _sparse_line_to_fp12(c_v2, c_w, c_wv))
    return F.fp12_conj(f)  # x < 0


def pairing_projective(p_pt, q_pt):
    return final_exponentiation(miller_loop_projective(p_pt, q_pt))


def multi_pairing(pairs):
    """prod_i e(P_i, Q_i): shared final exponentiation over the products of
    Miller loops — the structure the batch-verify kernels exploit."""
    f = F.FP12_ONE
    for p_pt, q_pt in pairs:
        f = F.fp12_mul(f, miller_loop(p_pt, q_pt))
    return final_exponentiation(f)
