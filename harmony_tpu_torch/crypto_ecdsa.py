"""secp256k1 ECDSA: transaction signing, recovery, and addresses.

The role of the reference's transaction-crypto layer (reference:
vendored go-ethereum secp256k1 C library, used by accounts/ and
core/types tx signing — SURVEY.md §2.1): sign a 32-byte digest, recover
the signer's public key from the 65-byte [R || S || V] signature, and
derive the 20-byte address as keccak256(uncompressed-pubkey)[12:].

Deliberately CPU-side (SURVEY.md §7 keeps ECDSA off the device path):
single-signature latency is trivial and the branchy scalar arithmetic
has no batch structure in the node's workload.  Deterministic nonces per
RFC 6979 (HMAC-SHA256) — no RNG dependency, bitwise-reproducible
signatures.  Low-S normalization is enforced on sign and required on
verify, matching Ethereum's homestead rule.

The port's copy of the JAX package's ``crypto_ecdsa.py``.
"""

from __future__ import annotations

import hashlib
import hmac

from .ref.keccak import keccak256

# secp256k1 domain parameters
P = 2**256 - 2**32 - 977
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
_G = (GX, GY)


def _inv(a: int, m: int) -> int:
    return pow(a, -1, m)


def _add(p1, p2):
    """Affine point add on y^2 = x^3 + 7 (None = infinity)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * _inv(2 * y1, P) % P
    else:
        lam = (y2 - y1) * _inv(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    return x3, (lam * (x1 - x3) - y1) % P


def _mul(k: int, pt):
    acc = None
    add = pt
    while k:
        if k & 1:
            acc = _add(acc, add)
        add = _add(add, add)
        k >>= 1
    return acc


def _rfc6979_k(digest: bytes, sk: int) -> int:
    """Deterministic nonce (RFC 6979 §3.2, HMAC-SHA256)."""
    x = sk.to_bytes(32, "big")
    v = b"\x01" * 32
    key = b"\x00" * 32
    key = hmac.new(key, v + b"\x00" + x + digest, hashlib.sha256).digest()
    v = hmac.new(key, v, hashlib.sha256).digest()
    key = hmac.new(key, v + b"\x01" + x + digest, hashlib.sha256).digest()
    v = hmac.new(key, v, hashlib.sha256).digest()
    while True:
        v = hmac.new(key, v, hashlib.sha256).digest()
        k = int.from_bytes(v, "big")
        if 1 <= k < N:
            return k
        key = hmac.new(key, v + b"\x00", hashlib.sha256).digest()
        v = hmac.new(key, v, hashlib.sha256).digest()


class ECDSAKey:
    """A secp256k1 private key with its derived public point/address."""

    __slots__ = ("secret", "pub")

    def __init__(self, secret: int):
        if not 1 <= secret < N:
            raise ValueError("secret out of range")
        self.secret = secret
        self.pub = _mul(secret, _G)

    @classmethod
    def from_bytes(cls, data: bytes) -> "ECDSAKey":
        if len(data) != 32:
            raise ValueError("want 32-byte secret")
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def from_seed(cls, seed: bytes) -> "ECDSAKey":
        """Derive a valid key by hashing the seed (test/keygen helper)."""
        d = seed
        while True:
            d = hashlib.sha256(d).digest()
            x = int.from_bytes(d, "big")
            if 1 <= x < N:
                return cls(x)

    @property
    def bytes(self) -> bytes:
        return self.secret.to_bytes(32, "big")

    def address(self) -> bytes:
        return pub_to_address(self.pub)

    def sign(self, digest: bytes) -> bytes:
        """65-byte [R(32) || S(32) || V(1)] recoverable signature."""
        if len(digest) != 32:
            raise ValueError("want 32-byte digest")
        z = int.from_bytes(digest, "big")
        k = _rfc6979_k(digest, self.secret)
        while True:
            kg = _mul(k, _G)
            r = kg[0] % N
            s = _inv(k, N) * (z + r * self.secret) % N
            # kg.x >= N would need recovery bit 2 (prob ~2^-128); retry
            # instead so V always fits the {0,1} id recover() accepts.
            if r != 0 and s != 0 and kg[0] < N:
                break
            k = (k + 1) % N or 1
        recid = kg[1] & 1
        if s > N // 2:  # low-S; flipping s mirrors the nonce point's y
            s = N - s
            recid ^= 1
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([recid])


def decompress_pubkey(data: bytes):
    """SEC1 compressed 33-byte key (02/03 || X) -> the (x, y) point.

    The standard Rosetta/Coinbase wire format (the reference accepts it
    via go-ethereum's DecompressPubkey in rosetta construction)."""
    if len(data) != 33 or data[0] not in (2, 3):
        raise ValueError("want a 33-byte 02/03-prefixed compressed key")
    x = int.from_bytes(data[1:], "big")
    if not (0 < x < P):
        raise ValueError("compressed key x out of range")
    y = pow(x * x * x + 7, (P + 1) // 4, P)  # sqrt: P % 4 == 3
    if y * y % P != (x * x * x + 7) % P:
        raise ValueError("compressed key x not on curve")
    if (y & 1) != (data[0] & 1):
        y = P - y
    return x, y


def pub_to_address(pub) -> bytes:
    """keccak256(X || Y)[12:] — the Ethereum-style 20-byte address."""
    x, y = pub
    return keccak256(x.to_bytes(32, "big") + y.to_bytes(32, "big"))[12:]


def recover(digest: bytes, sig: bytes):
    """Recover the signer's public point from a 65-byte signature.

    Returns the (x, y) point or raises ValueError.  The V byte is the
    recovery id in {0, 1} ({27, 28} accepted for legacy encodings).
    """
    if len(sig) != 65 or len(digest) != 32:
        raise ValueError("want 65-byte sig + 32-byte digest")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    recid = sig[64]
    if recid >= 27:
        recid -= 27
    if recid not in (0, 1):
        raise ValueError("bad recovery id")
    if not (1 <= r < N and 1 <= s <= N // 2):
        raise ValueError("signature values out of range (low-S required)")
    # lift R.x to a curve point
    x = r
    y_sq = (pow(x, 3, P) + 7) % P
    y = pow(y_sq, (P + 1) // 4, P)
    if y * y % P != y_sq:
        raise ValueError("r is not an x-coordinate on the curve")
    if y & 1 != recid:
        y = P - y
    z = int.from_bytes(digest, "big")
    rinv = _inv(r, N)
    # Q = r^-1 (sR - zG)
    q = _add(_mul(s * rinv % N, (x, y)), _mul((-z * rinv) % N, _G))
    if q is None:
        raise ValueError("recovered point at infinity")
    return q


def verify(digest: bytes, sig: bytes, address: bytes) -> bool:
    """True iff sig recovers to the given 20-byte address."""
    try:
        return pub_to_address(recover(digest, sig)) == address
    except ValueError:
        return False
