"""BLS12-381 curve parameters, derived from the single BLS parameter ``x``.

BLS12 curves are parameterised by one integer x (here negative, low Hamming
weight).  Every other constant — the base field prime p, the subgroup order
r, cofactors, trace of Frobenius — is a polynomial in x:

    r(x) = x^4 - x^2 + 1
    p(x) = (x - 1)^2 * r(x) / 3 + x
    t(x) = x + 1                      (trace of Frobenius of E(Fp))
    h1   = (x - 1)^2 / 3              (G1 cofactor)

Deriving instead of hard-coding means the only constant that has to be
trusted is ``X`` itself; everything else is checked by the identities below
and by the test suite (subgroup order annihilates generators, pairing is
bilinear and non-degenerate).

Sizes match the reference's wire format: pubkeys are G1 / 48 B, signatures
are G2 / 96 B, i.e. herumi's BLS_SWAP_G=1 build (reference:
crypto/bls/bls.go:17-20, Makefile:70).
"""

# The BLS parameter. Low Hamming weight (6 set bits) => short Miller loop.
X = -0xD201000000010000

_xa = -X  # |x|

# Subgroup order r = x^4 - x^2 + 1 (255 bits, prime).
R_ORDER = X**4 - X**2 + 1

# Base field prime p = (x-1)^2 * r / 3 + x (381 bits).
P = (X - 1) ** 2 * R_ORDER // 3 + X

# Cross-checks against the published constants (independent transcription).
assert R_ORDER == 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
assert P == int(
    "1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
    "1eabfffeb153ffffb9feffffffffaaab",
    16,
)
assert P % 4 == 3  # sqrt in Fp is a single exponentiation
assert P % 6 == 1

# Trace of Frobenius: #E(Fp) = p + 1 - t.
TRACE = X + 1

# G1 cofactor h1 = (x-1)^2 / 3; #E(Fp) = h1 * r.
H1 = (X - 1) ** 2 // 3
assert P + 1 - TRACE == H1 * R_ORDER

# Curve equation: E/Fp : y^2 = x^3 + 4, twist E'/Fp2 : y^2 = x^3 + 4(u+1).
B_G1 = 4
# Fp2 is Fp[u]/(u^2 + 1); the twist constant xi = u + 1 (the M-twist used by
# every BLS12-381 deployment, herumi/mcl included).
XI = (1, 1)  # as an Fp2 element (c0, c1)

# --- G2 cofactor -----------------------------------------------------------
# Derived, not transcribed.  E has CM discriminant D = -3, so
# t^2 - 4p = -3 f^2 for an integer f.  The sextic twists of E(Fp2) have
# orders p^2 + 1 - t' with t' in {t2, -t2, (t2 +/- 3 f2)/2, (-t2 +/- 3 f2)/2}
# where t2 = t^2 - 2p is the trace over Fp2 and t2^2 - 4 p^2 = -3 f2^2.
# Exactly one candidate order is divisible by r; that twist is the one G2
# lives on, and H2 = order / r.  The derivation (and the check that the
# candidate annihilates sample points) lives in tests/test_ref_params.py and
# constants_gen.py; the resulting value is fixed here.


def _derive_h2() -> int:
    import math

    t2 = TRACE * TRACE - 2 * P  # trace of Frobenius over Fp2
    d = 4 * P * P - t2 * t2
    assert d % 3 == 0
    f2sq = d // 3
    f2 = math.isqrt(f2sq)
    assert f2 * f2 == f2sq
    assert (t2 + 3 * f2) % 2 == 0
    candidates = [
        (t2 + 3 * f2) // 2,
        (t2 - 3 * f2) // 2,
        (-t2 + 3 * f2) // 2,
        (-t2 - 3 * f2) // 2,
    ]
    divisible = [
        P * P + 1 - tp for tp in candidates if (P * P + 1 - tp) % R_ORDER == 0
    ]
    assert len(divisible) == 1, divisible
    return divisible[0] // R_ORDER


H2 = _derive_h2()

# --- Generators ------------------------------------------------------------
# The standard generators (IETF / ZCash choice; herumi uses the same points).
# Checked for curve membership and order in the test suite.
G1_X = int(
    "17f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905a14e3a3f171bac58"
    "6c55e83ff97a1aeffb3af00adb22c6bb",
    16,
)
G1_Y = int(
    "08b3f481e3aaa0f1a09e30ed741d8ae4fcf5e095d5d00af600db18cb2c04b3ed"
    "d03cc744a2888ae40caa232946c5e7e1",
    16,
)

G2_X = (
    int(
        "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02b4510b647ae3d177"
        "0bac0326a805bbefd48056c8c121bdb8",
        16,
    ),
    int(
        "13e02b6052719f607dacd3a088274f65596bd0d09920b61ab5da61bbdc7f5049"
        "334cf11213945d57e5ac7d055d042b7e",
        16,
    ),
)
G2_Y = (
    int(
        "0ce5d527727d6e118cc9cdc6da2e351aadfd9baa8cbdd3a76d429a695160d12c"
        "923ac9cc3baca289e193548608b82801",
        16,
    ),
    int(
        "0606c4a02ea734cc32acd2b02bc28b99cb3e287e85a763af267492ab572e99ab"
        "3f370d275cec1da1aaa9075ff05f79be",
        16,
    ),
)

# Serialized sizes (reference: crypto/bls/bls.go:68-71).
PUBKEY_BYTES = 48  # G1 compressed
SIG_BYTES = 96  # G2 compressed
