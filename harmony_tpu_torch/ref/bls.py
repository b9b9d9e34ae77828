"""BLS signatures over BLS12-381: the host-side ground-truth API.

Mirrors the herumi surface the reference calls through cgo (SURVEY.md
§2.1): SignHash, Sign.Add, Sign.VerifyHash, PublicKey.Add/Sub, serialize /
deserialize — with pubkeys in G1 (48 B) and signatures in G2 (96 B), i.e.
the BLS_SWAP_G=1 convention (reference: crypto/bls/bls.go:17-20).

Scheme:  sk in [1, r);  pk = sk * G1;  sig = sk * H(msg) in G2;
verify:  e(G1_gen, sig) == e(pk, H(msg)).
Aggregation (same message, the FBFT case — reference:
consensus/quorum/quorum.go:164-196): sum sigs in G2, sum pubkeys in G1,
verify once.
"""

import hashlib
import os

from . import fields as F
from . import native as NB
from .curve import G1_GEN, g1, g2
from .pairing import multi_pairing
from .params import R_ORDER
from .serialize import g1_compress, g1_decompress, g2_compress, g2_decompress

_KEYGEN_DST = b"HARMONY-TPU-BLS-KEYGEN-V1"


def keygen(seed: bytes | None = None) -> int:
    """Derive a secret key: random, or deterministic from a seed."""
    if seed is None:
        seed = os.urandom(48)
    counter = 0
    while True:
        h = hashlib.sha256(_KEYGEN_DST + seed + bytes([counter])).digest()
        h2 = hashlib.sha256(_KEYGEN_DST + h + b"\x01").digest()
        sk = int.from_bytes(h + h2, "big") % R_ORDER
        if sk != 0:
            return sk
        counter += 1


def pubkey(sk: int):
    if NB.available():
        return NB.g1_mul(G1_GEN, sk % R_ORDER)
    return g1.mul(G1_GEN, sk % R_ORDER)


def sign(sk: int, msg_hash: bytes):
    """SignHash analog: sign a (typically 32-byte) message hash."""
    from .hash_to_curve import hash_to_g2

    if NB.available():
        return NB.g2_mul(hash_to_g2(msg_hash), sk % R_ORDER)
    return g2.mul(hash_to_g2(msg_hash), sk % R_ORDER)


def verify(pk, msg_hash: bytes, sig) -> bool:
    """VerifyHash analog: e(G1, sig) == e(pk, H(m)).

    Computed as one product of pairings with a shared final exponentiation:
    e(-G1, sig) * e(pk, H(m)) == 1.
    """
    from .hash_to_curve import hash_to_g2

    if pk is None or sig is None:
        return False
    h = hash_to_g2(msg_hash)
    if NB.available():
        return NB.pairing_check([(g1.neg(G1_GEN), sig), (pk, h)])
    gt = multi_pairing([(g1.neg(G1_GEN), sig), (pk, h)])
    return gt == F.FP12_ONE


def aggregate_sigs(sigs):
    """Sign.Add analog: sum signatures in G2."""
    sigs = list(sigs)
    if NB.available():
        return NB.g2_sum(sigs)
    acc = None
    for s in sigs:
        acc = g2.add(acc, s)
    return acc


def aggregate_pubkeys(pks):
    """PublicKey.Add analog: sum public keys in G1 (mask aggregation)."""
    pks = list(pks)
    if NB.available():
        return NB.g1_sum(pks)
    acc = None
    for p in pks:
        acc = g1.add(acc, p)
    return acc


def verify_hashed(pk, h_point, sig) -> bool:
    """verify() for a message already mapped to G2 (callers that hash
    once and verify many — the engine's batch replay path)."""
    if pk is None or sig is None:
        return False
    if NB.available():
        return NB.pairing_check([(g1.neg(G1_GEN), sig), (pk, h_point)])
    gt = multi_pairing([(g1.neg(G1_GEN), sig), (pk, h_point)])
    return gt == F.FP12_ONE


def verify_aggregate(pks, msg_hash: bytes, agg_sig) -> bool:
    """Aggregate verify for one message: the FBFT quorum check
    (reference: consensus/validator.go:228, internal/chain/engine.go:640)."""
    return verify(aggregate_pubkeys(pks), msg_hash, agg_sig)


# --- serialization convenience --------------------------------------------

def pubkey_to_bytes(pk) -> bytes:
    return g1_compress(pk)


def pubkey_from_bytes(data: bytes):
    return g1_decompress(data)


def sig_to_bytes(sig) -> bytes:
    return g2_compress(sig)


def sig_from_bytes(data: bytes):
    return g2_decompress(data)


def sk_to_bytes(sk: int) -> bytes:
    return (sk % R_ORDER).to_bytes(32, "big")


def sk_from_bytes(data: bytes) -> int:
    return int.from_bytes(data, "big") % R_ORDER
