"""herumi/mcl interop ciphersuite: the reference chain's wire format.

The reference signs and verifies through the herumi bls library built
with BLS_SWAP_G=1 — pubkeys in G1 (48 B), signatures in G2 (96 B)
(reference: crypto/bls/bls.go:17-20, Makefile:70) — using mcl's
*default* (pre-IETF) serialization, NOT the ZCash/IETF encoding that
``ref/serialize.py`` implements.  This module provides the mcl side as
a selectable ciphersuite so keys and committee tables produced by the
real chain load byte-for-byte.

Empirically pinned conventions (validated in tests/test_herumi.py
against data vendored from the reference repo — no herumi code was
available or consulted, only its outputs):

* Field elements serialize LITTLE-endian (Fp: 48 B, Fr: 32 B).
  Validated: all foundational-committee pubkeys in
  reference internal/genesis/foundational.go decode to curve points
  under LE (and none do under BE, which overflows p).
* G1/G2 compressed form: x little-endian with the y-parity flag in the
  MOST significant bit of the final byte (0x80 of byte 47 / 95); the
  all-zero buffer is the point at infinity.  Parity semantics: flag set
  <=> y is odd (mcl convention); our vendored (sk, pk) vector decodes
  with all flag bits clear and an even y, consistent with it.
* G2 x = a + b*u serializes a (real component) first, then b, each
  48 B LE, flag on the global final byte.
* The BLS_SWAP_G G1 base point is NOT the standard BLS12-381 generator.
  HERUMI_G1 below is derived from the reference's test vector pair
  (core/tx_pool_test.go:52-53): G = sk^-1 * pk with sk read LE — the
  unique point satisfying pk = sk*G for that pair.

* 26 more (sk, pk) pairs decrypted from the reference's localnet key
  files (.hmy/*.key, AES-GCM under the empty passphrase — see
  tests/vectors_herumi_localnet.py) all reproduce the herumi pubkey
  bytes exactly under the conventions above.

NOT yet vector-validated (requires herumi-produced signatures; an
exhaustive round-4 mine of the reference tree — every >=190-hex-char
constant, every binary fixture, every *_test.go using SignHash — found
NONE: all reference signatures are generated at runtime from random
keys, and no committed-block fixture carries a lastCommitSignature):
the SignHash map-to-G2 — mcl's try-and-increment from the 32-byte
message hash — specifically its sqrt-root choice and cofactor-clearing
method.  ``map_to_g2_herumi`` implements the documented mcl "original"
shape (x = hash-as-Fp + 0*u; x += 1 until x^3 + 4(u+1) is square) with
BOTH open conventions carried behind ``MAP_CONVENTION`` /
``set_map_convention`` so pinning is a config flip, never a code
change.  Analytic note: with p = 3 mod 4, Tonelli-Shanks in Fp
degenerates to the principal power a^((p+1)/4), and the complex-method
Fp2 sqrt composed from it is fully deterministic with no
canonicalization step; mcl's sqrt is also consumed by point
deserialization where the CALLER fixes parity from the wire flag
afterwards, so the "algorithmic" (uncanonicalized) root is the
best-guess mcl convention.  Signatures produced and verified WITHIN
this framework are self-consistent under every carried convention
(tests/test_herumi.py::test_map_conventions_all_self_consistent).

The port's copy of the JAX package's ``ref/herumi.py``.
"""

from . import fields as F
from . import native as NB
from .curve import g1, g2
from .params import H2, P, R_ORDER

# The BLS_SWAP_G base point (see module docstring for derivation).
HERUMI_G1 = (
    763293344507811477046371684537583630275805851521468330676434473029673297697877452371442185900362942157156173349093,
    2781315704910118183567811941392363931476590133721789378765638560267023127619616760929191718052242275548019548370600,
)

_ODD_FLAG = 0x80  # MSB of the final byte: y is odd


# ----------------------------------------------------------------------
# scalars
# ----------------------------------------------------------------------


def fr_to_bytes(sk: int) -> bytes:
    return (sk % R_ORDER).to_bytes(32, "little")


def fr_from_bytes(data: bytes) -> int:
    if len(data) != 32:
        raise ValueError("herumi Fr must be 32 bytes")
    v = int.from_bytes(data, "little")
    if v >= R_ORDER:
        raise ValueError("herumi Fr out of range")
    return v


# ----------------------------------------------------------------------
# points
# ----------------------------------------------------------------------


def g1_serialize(pt) -> bytes:
    if pt is None:
        return bytes(48)
    x, y = pt
    out = bytearray(x.to_bytes(48, "little"))
    if y & 1:
        out[47] |= _ODD_FLAG
    return bytes(out)


def g1_deserialize(data: bytes, check_subgroup: bool = True):
    if len(data) != 48:
        raise ValueError("herumi G1 must be 48 bytes")
    if not any(data):
        return None
    odd = bool(data[47] & _ODD_FLAG)
    x = int.from_bytes(data[:47] + bytes([data[47] & 0x7F]), "little")
    if x >= P:
        raise ValueError("herumi G1 x out of range")
    rhs = (x * x % P * x + g1.b) % P
    y = NB.fp_sqrt(rhs) if NB.available() else F.fp_sqrt(rhs)
    if y is None:
        raise ValueError("herumi G1 x not on curve")
    if bool(y & 1) != odd:
        y = (-y) % P
    pt = (x, y)
    # rogue-point defense, as in serialize.py: mcl's verifyOrder
    from .serialize import _g1_subgroup_ok

    if check_subgroup and not _g1_subgroup_ok(pt):
        raise ValueError("herumi G1 point not in the r-torsion subgroup")
    return pt


def _fp2_is_odd(a) -> bool:
    """mcl Fp2 parity: the parity of the real component unless it is
    zero, in which case the imaginary component's (isOdd of a.a or,
    when a.a == 0, of a.b)."""
    return bool((a[0] & 1) if a[0] else (a[1] & 1))


def g2_serialize(pt) -> bytes:
    if pt is None:
        return bytes(96)
    x, y = pt
    out = bytearray(
        x[0].to_bytes(48, "little") + x[1].to_bytes(48, "little")
    )
    if _fp2_is_odd(y):
        out[95] |= _ODD_FLAG
    return bytes(out)


def g2_deserialize(data: bytes, check_subgroup: bool = True):
    if len(data) != 96:
        raise ValueError("herumi G2 must be 96 bytes")
    if not any(data):
        return None
    odd = bool(data[95] & _ODD_FLAG)
    a = int.from_bytes(data[:48], "little")
    b = int.from_bytes(data[48:95] + bytes([data[95] & 0x7F]), "little")
    if a >= P or b >= P:
        raise ValueError("herumi G2 x out of range")
    x = (a, b)
    rhs = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), g2.b)
    y = NB.fp2_sqrt(rhs) if NB.available() else F.fp2_sqrt(rhs)
    if y is None:
        raise ValueError("herumi G2 x not on curve")
    if _fp2_is_odd(y) != odd:
        y = F.fp2_neg(y)
    pt = (x, y)
    from .serialize import _g2_subgroup_ok

    if check_subgroup and not _g2_subgroup_ok(pt):
        raise ValueError("herumi G2 point not in the r-torsion subgroup")
    return pt


# ----------------------------------------------------------------------
# SignHash-shaped map to G2 (see module docstring: pending vectors)
# ----------------------------------------------------------------------

# The two unpinned mcl conventions, carried as CONFIG so that when a
# herumi-produced signature vector surfaces, pinning is a one-line
# config flip, never a code change.
#
# ``root`` — which square root fp2_sqrt's candidate pair the map keeps:
#   "algorithmic"  the raw complex-method root built from principal Fp
#                  roots a^((p+1)/4) (p = 3 mod 4, so Tonelli-Shanks
#                  degenerates to the direct power — deterministic with
#                  no canonicalization step).  Analytic best guess for
#                  mcl: its Fp2 squareRoot is consumed by deserialization
#                  too, where the caller fixes parity from the wire flag
#                  afterwards — i.e. the sqrt itself has no reason to
#                  canonicalize, and a canonicalizing sqrt would make the
#                  caller's explicit parity fix-up redundant.
#   "even"/"odd"   parity-canonicalized under mcl Fp2 parity
#                  (_fp2_is_odd): keep the root whose parity matches.
#
# ``cofactor`` — how the candidate is pushed into the r-torsion:
#   "h2"    plain multiply by the full G2 cofactor h2.
#   "heff"  multiply by the Budroni-Pintore effective cofactor
#           h_eff (RFC 9380 §8.8.2) — what the psi-based "fast"
#           clearing computes.  Verified in tests: lands in the
#           r-torsion, is NOT the same point as h2*P, and h_eff != 0
#           mod r, so the two methods are genuinely distinct
#           conventions that a signature vector will disambiguate.
# Default = the mcl-source best guess: "algorithmic"
# root because mcl's Fp2 sqrt is the raw complex-method composition of
# the principal Fp power with no canonicalization pass (the module
# docstring's analytic argument), and plain-"h2" cofactor because mcl's
# pre-IETF hashAndMapToG2 multiplies by the precomputed cofactor
# constant rather than the psi-based effective-cofactor route it
# reserves for the IETF ciphersuites.  RESIDUAL RISK (PARITY.md): both
# choices are reasoned, not vector-pinned — the moment ANY herumi
# signature vector exists, run tools/pin_herumi.py and it emits the
# definitive pin (env override, no code change).
MAP_CONVENTION = {"root": "algorithmic", "cofactor": "h2"}

# RFC 9380 §8.8.2 effective cofactor for BLS12-381 G2 (Budroni-Pintore
# psi-based clearing as a single scalar).
H2_EFF = int(
    "0xbc69f08f2ee75b3584c6a0ea91b352888e2a8e9145ad7689986ff03150"
    "8ffe1329c2f178731db956d82bf015d1212b02ec0ec69d7477c1ae954cbc"
    "06689f6a359894c0adebbf6b4e8020005aaa95551",
    16,
)


def set_map_convention(root=None, cofactor=None):
    """Select the SignHash map conventions (see MAP_CONVENTION)."""
    if root is not None:
        if root not in ("algorithmic", "even", "odd"):
            raise ValueError(f"unknown root convention {root!r}")
        MAP_CONVENTION["root"] = root
    if cofactor is not None:
        if cofactor not in ("h2", "heff"):
            raise ValueError(f"unknown cofactor convention {cofactor!r}")
        MAP_CONVENTION["cofactor"] = cofactor


# Operational override without a code change (e.g. under a node config
# that must interop with a herumi vector discovered later).
import os as _os  # noqa: E402

if _os.environ.get("HERUMI_MAP_ROOT") or _os.environ.get("HERUMI_MAP_COFACTOR"):
    set_map_convention(
        root=_os.environ.get("HERUMI_MAP_ROOT") or None,
        cofactor=_os.environ.get("HERUMI_MAP_COFACTOR") or None,
    )


def _choose_root(y):
    """Apply the configured root convention to fp2_sqrt's output."""
    conv = MAP_CONVENTION["root"]
    if conv == "algorithmic":
        return y
    odd = _fp2_is_odd(y)
    if (conv == "odd") == odd:
        return y
    return F.fp2_neg(y)


def _clear_cofactor(pt):
    h = H2 if MAP_CONVENTION["cofactor"] == "h2" else H2_EFF
    if NB.available():
        return NB.g2_mul(pt, h)
    return g2.mul(pt, h)


def map_to_g2_herumi(msg_hash: bytes):
    """mcl-original-shaped SignHash map: interpret the hash LE as an Fp
    element t (mcl setArrayMask), start from x = t + 0*u, and increment
    by one until x^3 + 4(u+1) is a square; clear the cofactor.  Root and
    cofactor-clearing conventions per MAP_CONVENTION.

    Reference call shape: consensus/construct.go:99-114 signs 32-byte
    block hashes via priKey.SignHash."""
    if not msg_hash:
        raise ValueError("empty message hash")
    # setArrayMask: LE interpretation masked below 2^380 (< p)
    t = int.from_bytes(msg_hash, "little")
    t &= (1 << 380) - 1
    t %= P
    x = (t, 0)
    native = NB.available()
    for _ in range(512):
        rhs = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), g2.b)
        y = NB.fp2_sqrt(rhs) if native else F.fp2_sqrt(rhs)
        if y is not None:
            pt = _clear_cofactor((x, _choose_root(y)))
            if pt is not None:
                return pt
        x = (F.fp_add(x[0], 1), x[1])
    raise ValueError("map_to_g2_herumi: no point found (p < 2^-512)")


# ----------------------------------------------------------------------
# BLS over the herumi suite
# ----------------------------------------------------------------------


def pubkey(sk: int):
    if NB.available():
        return NB.g1_mul(HERUMI_G1, sk % R_ORDER)
    return g1.mul(HERUMI_G1, sk % R_ORDER)


def sign_hash(sk: int, msg_hash: bytes):
    if NB.available():
        return NB.g2_mul(map_to_g2_herumi(msg_hash), sk % R_ORDER)
    return g2.mul(map_to_g2_herumi(msg_hash), sk % R_ORDER)


def verify_hash(pk, msg_hash: bytes, sig) -> bool:
    """e(-G_herumi, sig) * e(pk, H(m)) == 1."""
    from . import pairing as RP
    from .fields import FP12_ONE

    if pk is None or sig is None:
        return False
    h = map_to_g2_herumi(msg_hash)
    if NB.available():
        return NB.pairing_check([(g1.neg(HERUMI_G1), sig), (pk, h)])
    gt = RP.multi_pairing([(g1.neg(HERUMI_G1), sig), (pk, h)])
    return gt == FP12_ONE
