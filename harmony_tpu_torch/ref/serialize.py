"""Compressed point serialization: G1 pubkeys 48 B, G2 signatures 96 B.

Wire sizes match the reference's BLS_SWAP_G=1 build (reference:
crypto/bls/bls.go:17-20 — pubkeys G1/48B, sigs G2/96B; Makefile:70).
The byte layout is the ZCash/IETF compressed encoding (big-endian field
elements, 3 flag bits in the top byte):

    bit 7 (0x80): compression flag, always set here
    bit 6 (0x40): infinity flag
    bit 5 (0x20): sign flag — y is the lexicographically larger root

G2 serializes x = x0 + x1 u as  x1 || x0  (imaginary limb first), sign from
(y1, y0) lexicographic order.
"""

from . import fields as F
from . import native as NB
from .curve import g1, g2
from .params import P
from .params import R_ORDER as _R_ORDER


def _g1_subgroup_ok(pt) -> bool:
    """r-torsion membership; native when available (the affine bigint
    mul-by-r costs ~40 ms per decompressed point, the native one ~0.2)."""
    if NB.available():
        return NB.g1_in_subgroup(pt)
    return g1.mul(pt, _R_ORDER) is None


def _g2_subgroup_ok(pt) -> bool:
    if NB.available():
        return NB.g2_in_subgroup(pt)
    return g2.mul(pt, _R_ORDER) is None


def _fp_to_bytes(a: int) -> bytes:
    return (a % P).to_bytes(48, "big")


def g1_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    out = bytearray(_fp_to_bytes(x))
    out[0] |= 0x80
    if F.fp_is_neg(y):
        out[0] |= 0x20
    return bytes(out)


def g1_decompress(data: bytes, check_subgroup: bool = True):
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G1 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("malformed G1 infinity")
        return None
    x = int.from_bytes(bytes([flags & 0x1F]) + data[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    rhs = (x * x % P * x + g1.b) % P
    y = NB.fp_sqrt(rhs) if NB.available() else F.fp_sqrt(rhs)
    if y is None:
        raise ValueError("G1 x not on curve")
    if F.fp_is_neg(y) != bool(flags & 0x20):
        y = (-y) % P
    pt = (x, y)
    # Rogue-point defense: a curve point need not lie in the r-torsion
    # subgroup (cofactor h1 > 1).  mcl rejects such points on deserialize;
    # so do we (reference behavior: herumi verifyOrder).
    if check_subgroup and not _g1_subgroup_ok(pt):
        raise ValueError("G1 point not in the r-torsion subgroup")
    return pt


def _fp2_is_neg(a) -> bool:
    """Lexicographic sign of an Fp2 element: compare (c1, c0)."""
    if a[1] != 0:
        return F.fp_is_neg(a[1])
    return F.fp_is_neg(a[0])


def g2_compress(pt) -> bytes:
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    x, y = pt
    out = bytearray(_fp_to_bytes(x[1]) + _fp_to_bytes(x[0]))
    out[0] |= 0x80
    if _fp2_is_neg(y):
        out[0] |= 0x20
    return bytes(out)


def g2_decompress(data: bytes, check_subgroup: bool = True):
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & 0x80:
        raise ValueError("uncompressed G2 encoding not supported")
    if flags & 0x40:
        if any(data[1:]) or flags & 0x3F:
            raise ValueError("malformed G2 infinity")
        return None
    x1 = int.from_bytes(bytes([flags & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    x = (x0, x1)
    rhs = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), g2.b)
    y = NB.fp2_sqrt(rhs) if NB.available() else F.fp2_sqrt(rhs)
    if y is None:
        raise ValueError("G2 x not on curve")
    if _fp2_is_neg(y) != bool(flags & 0x20):
        y = F.fp2_neg(y)
    pt = (x, y)
    # Rogue-point defense (see g1_decompress): the twist's cofactor is huge;
    # unchecked points enable invalid-curve-style forgeries.
    if check_subgroup and not _g2_subgroup_ok(pt):
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt
