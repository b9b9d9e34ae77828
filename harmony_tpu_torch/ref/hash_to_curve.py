"""Deterministic hash-to-G2 for BLS signatures.

The same map as the JAX package's host side, so both packages verify the
same signatures:

    for ctr = 0, 1, 2, ...:
        x = (H(msg || ctr || 0), H(msg || ctr || 1)) interpreted in Fp2
        if x^3 + 4(u+1) is a square: y = sqrt, pick lexicographically-even y
        clear the G2 cofactor; if non-infinity, done

The branchy search stays on the host; only the curve and pairing
arithmetic runs on the device.  Two branches give the same point: the
native library (ref/native.py: ``g2_map_tai`` for each try, ``g2_mul`` by
the cofactor) when it loads, and pure Python (about half a second per
payload) otherwise.
"""

import hashlib

from . import fields as F
from . import native as NB
from .curve import clear_cofactor_g2, g2
from .params import H2, P

_DST = b"HARMONY-TPU-BLS12381G2-TAI-SHA256-V1"


def _hash_to_fp(msg: bytes, ctr: int, idx: int) -> int:
    """Derive one Fp coordinate from 2 sha256 blocks (uniform enough mod p)."""
    h0 = hashlib.sha256(_DST + msg + bytes([ctr, idx, 0])).digest()
    h1 = hashlib.sha256(_DST + msg + bytes([ctr, idx, 1])).digest()
    return int.from_bytes(h0 + h1, "big") % P


def map_to_twist(msg: bytes):
    """Try-and-increment: find the first counter yielding a twist point.

    Returns an E'(Fp2) point NOT yet in the r-torsion subgroup.
    """
    native = NB.available()
    for ctr in range(256):
        x = (_hash_to_fp(msg, ctr, 0), _hash_to_fp(msg, ctr, 1))
        if native:
            pt = NB.g2_map_tai(x)  # same sqrt + canonical-y conventions
            if pt is not None:
                return pt
            continue
        rhs = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), g2.b)
        y = F.fp2_sqrt(rhs)
        if y is None:
            continue
        # canonical y choice: lexicographically smaller of {y, -y}
        neg = F.fp2_neg(y)
        if (y[1], y[0]) > (neg[1], neg[0]):
            y = neg
        return (x, y)
    raise ValueError("map_to_twist: no point found in 256 tries (p=2^-256)")


def hash_to_g2(msg: bytes):
    """Full hash-to-G2: map to the twist, then clear the cofactor."""
    tw = map_to_twist(msg)
    if NB.available():
        pt = NB.g2_mul(tw, H2)
    else:
        pt = clear_cofactor_g2(tw)
    if pt is None:  # astronomically unlikely (prob 1/r)
        raise ValueError("hash_to_g2 produced infinity")
    return pt
