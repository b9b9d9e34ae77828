"""alt_bn128 (BN254): the EVM's pairing curve, plus the blake2 F core.

The reference serves precompiles 0x6-0x9 through go-ethereum's cgo
crypto (core/vm/contracts.go bn256Add/ScalarMul/Pairing + blake2F).
This is a from-scratch bigint implementation in the same style as
the ``ref`` package's BLS12-381 twin:

* G1 over Fp (y^2 = x^3 + 3), G2 over Fp2 on the D-type sextic twist
  (b' = 3/(9+u));
* optimal Ate pairing: Miller loop over 6z+2 (z the BN parameter),
  the two Frobenius line corrections, BN final exponentiation;
* EIP-196/197 semantics: subgroup/field validation and the big-endian
  32-byte coordinate wire format handled by the precompile layer in
  core/vm.py;
* EIP-152 blake2 F compression function.

Pairing checks here are consensus-critical host work, like the EVM
interpreter itself (SURVEY §7.2): contract gas prices them, the card's
kernels stay dedicated to BLS12-381.

The port's copy of the JAX package's ``crypto_bn256.py``.
"""

from __future__ import annotations

# BN254 parameters
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
N = 21888242871839275222246405745257275088548364400416034343698204186575808495617
Z = 4965661367192848881  # the BN parameter (Miller loop over 6z+2)
B = 3

# Fp2 = Fp[u]/(u^2 + 1); the twist divides by xi = 9 + u
XI = (9, 1)


def _inv(a: int) -> int:
    return pow(a, -1, P)


# -- Fp2 ---------------------------------------------------------------------


def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u), u^2 = -1
    t0 = a[0] * b[0] % P
    t1 = a[1] * b[1] % P
    return ((t0 - t1) % P, ((a[0] + a[1]) * (b[0] + b[1]) - t0 - t1) % P)


def f2_sqr(a):
    return f2_mul(a, a)


def f2_inv(a):
    d = _inv((a[0] * a[0] + a[1] * a[1]) % P)
    return (a[0] * d % P, (-a[1]) * d % P)


def f2_scalar(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
B2 = f2_mul((B, 0), f2_inv(XI))  # twist b' = 3/(9+u)

# -- Fp12 as pairs of Fp6, Fp6 as triples of Fp2 (v^3 = xi, w^2 = v) --------


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def _mul_xi(a):
    return f2_mul(a, XI)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, _mul_xi(f2_sub(
        f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2)
    )))
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        _mul_xi(t2),
    )
    c2 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)),
        t1,
    )
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_inv(f2_add(
        f2_mul(a0, c0),
        f2_add(_mul_xi(f2_mul(a2, c1)), _mul_xi(f2_mul(a1, c2))),
    ))
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    # w^2 = v: (t1 shifted by v)
    shifted = (_mul_xi(t1[2]), t1[0], t1[1])
    c0 = f6_add(t0, shifted)
    c1 = f6_sub(
        f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1)
    )
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_inv(a):
    a0, a1 = a
    sq = f6_sqr(a1)
    shifted = (_mul_xi(sq[2]), sq[0], sq[1])
    t = f6_inv(f6_sub(f6_sqr(a0), shifted))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(a):
    return (a[0], f6_neg(a[1]))


def f12_pow(a, e: int):
    result = F12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = f12_mul(result, base)
        base = f12_sqr(base)
        e >>= 1
    return result


F12_ONE = (F6_ONE, F6_ZERO)

# Frobenius coefficients: gamma1[i] = xi^((p-1) * i / 6)
_G1FROB = [pow((9 * 9 + 1) % P, 0, P)]  # placeholder, computed below


def _f2_pow(a, e: int):
    r = F2_ONE
    b = a
    while e > 0:
        if e & 1:
            r = f2_mul(r, b)
        b = f2_sqr(b)
        e >>= 1
    return r


_XI_P_SIXTH = _f2_pow(XI, (P - 1) // 6)
_FROB_GAMMA = [_f2_pow(XI, (P - 1) * i // 6) for i in range(6)]


def f2_frob(a):
    """a^p in Fp2: conjugation."""
    return (a[0], (-a[1]) % P)


def f6_frob(a):
    return (
        f2_frob(a[0]),
        f2_mul(f2_frob(a[1]), _FROB_GAMMA[2]),
        f2_mul(f2_frob(a[2]), _FROB_GAMMA[4]),
    )


def f12_frob(a):
    """(b0 + b1 w)^p = b0^p + (b1^p * gamma1) w — b^p within Fp6 is
    f6_frob (which carries the v-power coefficients); the w-part then
    takes ONE uniform factor gamma1 = xi^((p-1)/6) from w^p."""
    a0, a1 = a
    b1 = f6_frob(a1)
    return (
        f6_frob(a0),
        (
            f2_mul(b1[0], _FROB_GAMMA[1]),
            f2_mul(b1[1], _FROB_GAMMA[1]),
            f2_mul(b1[2], _FROB_GAMMA[1]),
        ),
    )


# -- G1 ----------------------------------------------------------------------


def g1_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B) % P == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1) % P
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_mul(pt, k: int):
    k %= N
    out = None
    while k:
        if k & 1:
            out = g1_add(out, pt)
        pt = g1_add(pt, pt)
        k >>= 1
    return out


# -- G2 (on the twist, Fp2 coordinates) -------------------------------------


def g2_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == F2_ZERO


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(
            f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2))
        )
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sqr(lam), f2_add(x1, x2))
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_mul(pt, k: int):
    k %= N
    out = None
    while k:
        if k & 1:
            out = g2_add(out, pt)
        pt = g2_add(pt, pt)
        k >>= 1
    return out


def g2_neg(pt):
    return None if pt is None else (pt[0], f2_neg(pt[1]))


def g2_in_subgroup(pt) -> bool:
    return g2_on_curve(pt) and g2_mul(pt, N) is None


G1_GEN = (1, 2)
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


# -- optimal Ate pairing -----------------------------------------------------
#
# Formulation: UNTWIST both points into E(Fp12) and run the textbook
# Miller loop with the general affine line function over Fp12 (the
# py_ecc-style arrangement — slower than sparse twist-coefficient
# tricks, but unambiguous; tests pin bilinearity + EIP-197 identities).
# With the tower Fp12 = Fp6[w]/(w^2 - v), v^3 = xi: w^6 = xi, so the
# D-twist untwist is psi(x', y') = (x' w^2, y' w^3).


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_neg(a):
    return (f6_neg(a[0]), f6_neg(a[1]))


F12_ZERO = (F6_ZERO, F6_ZERO)


def _embed_fp(x: int):
    """Fp -> Fp12."""
    return (((x % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


def _untwist_g2(q):
    """Twist point (Fp2 coords) -> E(Fp12): (x' v, y' v w)."""
    x2, y2 = q
    return (
        ((F2_ZERO, x2, F2_ZERO), F6_ZERO),       # x' * w^2 = x' * v
        (F6_ZERO, (F2_ZERO, y2, F2_ZERO)),       # y' * w^3 = y' * v * w
    )


def _embed_g1(p):
    return (_embed_fp(p[0]), _embed_fp(p[1]))


def _e12_add(p1, p2):
    """Affine addition on E(Fp12): y^2 = x^3 + 3."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f12_add(y1, y2) == F12_ZERO:
            return None
        lam = f12_mul(
            f12_mul(_embed_fp(3), f12_sqr(x1)),
            f12_inv(f12_add(y1, y1)),
        )
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sqr(lam), f12_add(x1, x2))
    return (x3, f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1))


def _linefunc(p1, p2, t):
    """Line through p1, p2 evaluated at t (all on E(Fp12))."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
        return f12_sub(
            f12_mul(lam, f12_sub(xt, x1)), f12_sub(yt, y1)
        )
    if y1 == y2:
        lam = f12_mul(
            f12_mul(_embed_fp(3), f12_sqr(x1)),
            f12_inv(f12_add(y1, y1)),
        )
        return f12_sub(
            f12_mul(lam, f12_sub(xt, x1)), f12_sub(yt, y1)
        )
    return f12_sub(xt, x1)  # vertical


def _frob_point(pt):
    """Coordinate-wise x -> x^p on E(Fp12)."""
    return (f12_frob(pt[0]), f12_frob(pt[1]))


ATE_LOOP_COUNT = 6 * Z + 2


def miller_loop(q, p):
    """f_{6z+2, Q}(P) with the two Frobenius correction steps."""
    if q is None or p is None:
        return F12_ONE
    qe = _untwist_g2(q)
    pe = _embed_g1(p)
    f = F12_ONE
    r = qe
    for bit in bin(ATE_LOOP_COUNT)[3:]:
        f = f12_mul(f12_sqr(f), _linefunc(r, r, pe))
        r = _e12_add(r, r)
        if bit == "1":
            f = f12_mul(f, _linefunc(r, qe, pe))
            r = _e12_add(r, qe)
    q1 = _frob_point(qe)
    nq2 = _frob_point(q1)
    nq2 = (nq2[0], f12_neg(nq2[1]))
    f = f12_mul(f, _linefunc(r, q1, pe))
    r = _e12_add(r, q1)
    f = f12_mul(f, _linefunc(r, nq2, pe))
    return f


def final_exponentiation(f):
    """f^((p^12 - 1) / n) — easy part via conjugation/inversion, hard
    part by plain exponentiation of the cofactor (slow but simple and
    obviously correct; contract gas prices the call, not us)."""
    # easy: f^(p^6 - 1) * ... ; do the whole exponent directly but use
    # the easy part to shrink the base first
    f = f12_mul(f12_conj(f), f12_inv(f))          # f^(p^6 - 1)
    f = f12_mul(f12_frob(f12_frob(f)), f)         # ^(p^2 + 1)
    e = (P ** 4 - P ** 2 + 1) // N
    return f12_pow(f, e)


def pairing(p, q):
    """e(P, Q) for P in G1, Q in G2 (twist coords)."""
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 (the 0x8 precompile's question)."""
    f = F12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f12_mul(f, miller_loop(q, p))
    return final_exponentiation(f) == F12_ONE


# -- EIP-152: blake2 F compression ------------------------------------------

_BLAKE2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B,
    0xA54FF53A5F1D36F1, 0x510E527FADE682D1, 0x9B05688C2B3E6C1F,
    0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

_M64 = (1 << 64) - 1


def _rotr(x, n):
    return ((x >> n) | (x << (64 - n))) & _M64


def blake2f(rounds: int, h: list, m: list, t: list, flag: bool) -> list:
    """The blake2b F function (RFC 7693 sec 3.2), EIP-152 semantics."""
    v = h[:] + _BLAKE2B_IV[:]
    v[12] ^= t[0] & _M64
    v[13] ^= t[1] & _M64
    if flag:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = _rotr(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = _rotr(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]
