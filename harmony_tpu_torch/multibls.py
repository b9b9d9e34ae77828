"""Multi-BLS key containers: one node operating several committee slots.

Behavioral parity with the reference's multibls package (reference:
multibls/multibls.go:13-74): ordered key lists with dedup on append,
serialized-key lookups, and "sign with every local key then locally
aggregate" — the per-phase behavior of consensus message construction
(reference: consensus/construct.go:99-114).
"""

from __future__ import annotations

from .bls import PrivateKey, PublicKey, Signature, aggregate_sigs
from .ref.params import R_ORDER


class PublicKeys(list):
    """Ordered list of PublicKey with containment helpers."""

    def contains(self, pub: PublicKey) -> bool:
        return any(k.bytes == pub.bytes for k in self)

    def serialized(self) -> list:
        return [k.bytes for k in self]


class PrivateKeys(list):
    """Ordered list of PrivateKey; one process, K committee slots."""

    @classmethod
    def from_keys(cls, keys) -> "PrivateKeys":
        out = cls()
        for k in keys:
            out.append_dedup(k)
        return out

    def append_dedup(self, key: PrivateKey):
        if not any(k.pub.bytes == key.pub.bytes for k in self):
            self.append(key)

    def public_keys(self) -> PublicKeys:
        return PublicKeys(k.pub for k in self)

    def sign_hash_aggregated(self, msg_hash: bytes) -> Signature:
        """Sign with every local key and aggregate — what the reference
        does when constructing PREPARE/COMMIT messages
        (construct.go:99-114: SignHash per key + Sign.Add).  The sum of
        the per-key signatures sk_i·H(m) is (Σ sk_i)·H(m): one hash and
        one scalar multiplication by the keys' sum give the same point,
        and so the same bytes."""
        if not self:
            raise ValueError("no keys")
        total = sum(k.scalar for k in self) % R_ORDER
        if total == 0:  # the keys cancel: the aggregate is infinity
            return aggregate_sigs([k.sign_hash(msg_hash) for k in self])
        return PrivateKey(total).sign_hash(msg_hash)
