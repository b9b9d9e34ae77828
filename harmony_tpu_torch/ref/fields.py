"""Tower field arithmetic for BLS12-381 over Python bigints.

Tower (the one every BLS12-381 deployment uses, herumi/mcl included):

    Fp2  = Fp [u] / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),   xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Representation: Fp is ``int`` in [0, p); Fp2 is ``(c0, c1)``; Fp6 is
``(c0, c1, c2)`` of Fp2; Fp12 is ``(c0, c1)`` of Fp6.  All functions are
pure.  The port's own copy of the bigint ground truth: it builds keys,
signatures and hashed payloads on the host side (ops/interop.py).
"""

from .params import P

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------

def fp_add(a, b):
    return (a + b) % P


def fp_sub(a, b):
    return (a - b) % P


def fp_mul(a, b):
    return (a * b) % P


def fp_neg(a):
    return (-a) % P


def fp_inv(a):
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, P - 2, P)


def fp_sqrt(a):
    """Square root in Fp (p = 3 mod 4), or None if a is a non-residue."""
    a %= P
    cand = pow(a, (P + 1) // 4, P)
    return cand if cand * cand % P == a else None


def fp_is_neg(a):
    """Lexicographic 'sign': True if a > (p-1)/2 (the larger of {a, -a})."""
    return a % P > (P - 1) // 2


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1)
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = a0 b0 - a1 b1 + (a0 b1 + a1 b0) u
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def fp2_sqr(a):
    return fp2_mul(a, a)


def fp2_scalar(a, k):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    """Frobenius x -> x^p on Fp2: conjugation a0 - a1 u."""
    return (a[0], (-a[1]) % P)


def fp2_inv(a):
    # (a0 + a1 u)^-1 = (a0 - a1 u) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = fp_inv(norm)
    return (a[0] * ninv % P, -a[1] * ninv % P)


def fp2_mul_xi(a):
    """Multiply by xi = u + 1: (a0 + a1 u)(1 + u) = a0 - a1 + (a0 + a1) u."""
    return ((a[0] - a[1]) % P, (a[0] + a[1]) % P)


def fp2_sqrt(a):
    """Square root in Fp2 via the norm trick, or None if non-square.

    For x = x0 + x1 u with x^2 = a:  norm(a) = a0^2 + a1^2 must be a QR in
    Fp; with alpha = sqrt(norm), x0^2 = (a0 + alpha)/2 or (a0 - alpha)/2.
    """
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        s = fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue => sqrt is purely imaginary: (x1 u)^2 = -x1^2
        s = fp_sqrt((-a0) % P)
        return None if s is None else (0, s)
    alpha = fp_sqrt((a0 * a0 + a1 * a1) % P)
    if alpha is None:
        return None
    inv2 = fp_inv(2)
    delta = (a0 + alpha) * inv2 % P
    x0 = fp_sqrt(delta)
    if x0 is None:
        delta = (a0 - alpha) * inv2 % P
        x0 = fp_sqrt(delta)
        if x0 is None:
            return None
    x1 = a1 * fp_inv(2 * x0 % P) % P
    cand = (x0, x1)
    return cand if fp2_sqr(cand) == (a0, a1) else None


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    t00 = fp2_mul(a[0], b[0])
    t11 = fp2_mul(a[1], b[1])
    t22 = fp2_mul(a[2], b[2])
    # c0 = a0 b0 + xi (a1 b2 + a2 b1)
    c0 = fp2_add(t00, fp2_mul_xi(fp2_add(fp2_mul(a[1], b[2]), fp2_mul(a[2], b[1]))))
    # c1 = a0 b1 + a1 b0 + xi a2 b2
    c1 = fp2_add(fp2_add(fp2_mul(a[0], b[1]), fp2_mul(a[1], b[0])), fp2_mul_xi(t22))
    # c2 = a0 b2 + a1 b1 + a2 b0
    c2 = fp2_add(fp2_add(fp2_mul(a[0], b[2]), t11), fp2_mul(a[2], b[0]))
    return (c0, c1, c2)


def fp6_mul_v(a):
    """Multiply by v: (c0, c1, c2) -> (xi c2, c0, c1)."""
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    # Standard formula (e.g. Beuchat et al.): with
    #   t0 = a0^2 - xi a1 a2, t1 = xi a2^2 - a0 a1, t2 = a1^2 - a0 a2
    # a^-1 = (t0, t1, t2) / (a0 t0 + xi a2 t1 + xi a1 t2)
    a0, a1, a2 = a
    t0 = fp2_sub(fp2_sqr(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    t1 = fp2_sub(fp2_mul_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    t2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    norm = fp2_add(
        fp2_mul(a0, t0),
        fp2_add(fp2_mul_xi(fp2_mul(a2, t1)), fp2_mul_xi(fp2_mul(a1, t2))),
    )
    ninv = fp2_inv(norm)
    return (fp2_mul(t0, ninv), fp2_mul(t1, ninv), fp2_mul(t2, ninv))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_mul(a, b):
    t0 = fp6_mul(a[0], b[0])
    t1 = fp6_mul(a[1], b[1])
    c0 = fp6_add(t0, fp6_mul_v(t1))  # w^2 = v
    c1 = fp6_sub(
        fp6_mul(fp6_add(a[0], a[1]), fp6_add(b[0], b[1])), fp6_add(t0, t1)
    )
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """x -> x^(p^6): conjugation over Fp6 (negate the w coefficient)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    # (d0 + d1 w)^-1 = (d0 - d1 w) / (d0^2 - v d1^2)
    norm = fp6_sub(fp6_mul(a[0], a[0]), fp6_mul_v(fp6_mul(a[1], a[1])))
    ninv = fp6_inv(norm)
    return (fp6_mul(a[0], ninv), fp6_neg(fp6_mul(a[1], ninv)))


def fp12_pow(a, e):
    if e < 0:
        a, e = fp12_inv(a), -e
    result = FP12_ONE
    base = a
    while e:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


# --- embeddings ------------------------------------------------------------

def fp2_to_fp12(a):
    return ((a, FP2_ZERO, FP2_ZERO), FP6_ZERO)


def fp_to_fp12(a):
    return fp2_to_fp12((a % P, 0))


# w as an Fp12 element (0, 1): used to untwist G2 points.
FP12_W = (FP6_ZERO, FP6_ONE)
