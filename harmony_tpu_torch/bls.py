"""User-facing BLS API: the framework's equivalent of the reference's
crypto/bls wrapper types (reference: crypto/bls/bls.go:23-33 —
PublicKeyWrapper / PrivateKeyWrapper pairing a deserialized object with
its serialized bytes) and the herumi object surface the node code calls.

Signing and single-key arithmetic run on the host path (``ref/``, native
when the library loads); the checks the node makes route through the
verification scheduler onto the device (``verify_point``) when
``device.device_enabled()`` — the boundary the reference crosses via
cgo.  The port's copy of the JAX package's ``bls.py``.
"""

from __future__ import annotations

import functools

from .ref import bls as RB
from .ref import curve as RC
from .ref.params import PUBKEY_BYTES, SIG_BYTES


class PublicKey:
    """Wrapper pairing the affine point with its 48-byte serialization."""

    __slots__ = ("point", "_bytes")

    def __init__(self, point, serialized: bytes | None = None):
        self.point = point
        self._bytes = serialized

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        return cls(RB.pubkey_from_bytes(data), bytes(data))

    @property
    def bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = RB.pubkey_to_bytes(self.point)
        return self._bytes

    def add(self, other: "PublicKey") -> "PublicKey":
        return PublicKey(RC.g1.add(self.point, other.point))

    def sub(self, other: "PublicKey") -> "PublicKey":
        return PublicKey(RC.g1.add(self.point, RC.g1.neg(other.point)))

    def __eq__(self, o) -> bool:
        return isinstance(o, PublicKey) and self.bytes == o.bytes

    def __hash__(self):
        return hash(self.bytes)

    def __repr__(self):
        return f"PublicKey({self.bytes[:4].hex()}..)"


class Signature:
    __slots__ = ("point", "_bytes")

    def __init__(self, point, serialized: bytes | None = None):
        self.point = point
        self._bytes = serialized

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        return cls(RB.sig_from_bytes(data), bytes(data))

    @property
    def bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = RB.sig_to_bytes(self.point)
        return self._bytes

    def add(self, other: "Signature") -> "Signature":
        """Aggregate (Sign.Add analog)."""
        return Signature(RC.g2.add(self.point, other.point))

    def verify(self, pub: PublicKey, msg_hash: bytes) -> bool:
        """VerifyHash analog."""
        return RB.verify(pub.point, msg_hash, self.point)

    def __eq__(self, o) -> bool:
        return isinstance(o, Signature) and self.bytes == o.bytes

    def __repr__(self):
        return f"Signature({self.bytes[:4].hex()}..)"


class PrivateKey:
    """Wrapper pairing the scalar with its derived public key (reference:
    crypto/bls/bls.go PrivateKeyWrapper)."""

    __slots__ = ("scalar", "pub")

    def __init__(self, scalar: int):
        self.scalar = scalar % RC.R_ORDER
        self.pub = PublicKey(RB.pubkey(self.scalar))

    @classmethod
    def generate(cls, seed: bytes | None = None) -> "PrivateKey":
        return cls(RB.keygen(seed))

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivateKey":
        return cls(RB.sk_from_bytes(data))

    @property
    def bytes(self) -> bytes:
        return RB.sk_to_bytes(self.scalar)

    def sign_hash(self, msg_hash: bytes) -> Signature:
        """SignHash analog: sign a (typically 32-byte) hash."""
        return Signature(RB.sign(self.scalar, msg_hash))


def aggregate_sigs(sigs) -> Signature:
    """Sum signatures (AggregateSig — reference: crypto/bls/mask.go:57-64)."""
    return Signature(RB.aggregate_sigs([s.point for s in sigs]))


def verify_point(pk_point, payload: bytes, sig_point, *,
                 lane=None) -> bool:
    """One aggregate-signature check, routed through the verification
    scheduler's shared device queue when the device path is live
    (device.device_enabled()) and to the host bigint twin otherwise —
    THE verification choke point every consensus check funnels
    through.  ``lane`` picks the scheduler priority lane (default:
    consensus — vote/proof checks gate live rounds)."""
    from . import device as DV

    if DV.device_enabled():
        from . import sched

        return sched.verify_single(
            pk_point, payload, sig_point,
            lane=sched.Lane.CONSENSUS if lane is None else lane,
        )
    return RB.verify(pk_point, payload, sig_point)


def verify_aggregate_bytes(
    pubkeys_bytes, payload: bytes, sig_bytes: bytes, *, lane=None
) -> bool:
    """Verify a 96-byte signature against the SUM of serialized pubkeys —
    the shape every multi-key vote check takes (consensus votes,
    view-change votes, slash evidence).  Malformed input returns False,
    never raises."""
    if not pubkeys_bytes:
        return False
    try:
        agg_pk = None
        for pk_bytes in pubkeys_bytes:
            pk = pubkey_from_bytes_cached(pk_bytes)
            agg_pk = pk if agg_pk is None else agg_pk.add(pk)
        sig = Signature.from_bytes(sig_bytes)
    except (ValueError, KeyError):
        return False
    return verify_point(agg_pk.point, payload, sig.point, lane=lane)


def proof_of_possession(priv: "PrivateKey") -> bytes:
    """BLS proof-of-possession: the key signs its own serialized public
    key (the reference's staking_verifier.go VerifyBLSKeys contract) —
    carried in create-validator / add-bls-key staking txs and checked
    at pool admission on the scheduler's ingress lane."""
    return priv.sign_hash(priv.pub.bytes).bytes


def verify_proof_of_possession(pub_bytes: bytes, sig_bytes: bytes, *,
                               lane=None) -> bool:
    """Check one key's proof-of-possession; malformed input returns
    False, never raises."""
    return verify_proofs_of_possession([(pub_bytes, sig_bytes)],
                                       lane=lane)


def verify_proofs_of_possession(pairs, *, lane=None) -> bool:
    """Check many (pubkey bytes, pop signature bytes) pairs: on the
    live device path every check is SUBMITTED to the scheduler before
    the first is awaited, so a multi-key create-validator (or a burst
    of staking submits) coalesces into one fused batch instead of N
    sequential round-trips.  False on any malformed or failing pair,
    never raises, except ``device.DeviceError`` when the card failed."""
    from . import device as DV

    decoded = []
    try:
        for pub_bytes, sig_bytes in pairs:
            pk = pubkey_from_bytes_cached(pub_bytes)
            sig = Signature.from_bytes(sig_bytes)
            if sig.point is None:
                return False
            decoded.append((pk.point, bytes(pub_bytes), sig.point))
    except (ValueError, KeyError):
        return False
    if not decoded:
        return True
    if DV.device_enabled():
        from . import sched

        if sched.enabled():
            from .ref.hash_to_curve import hash_to_g2

            s = sched.scheduler()
            use_lane = sched.Lane.INGRESS if lane is None else lane
            futures = [
                s.submit_single(pk, hash_to_g2(payload), sig,
                                lane=use_lane)
                for pk, payload, sig in decoded
            ]
            try:
                return all(f.result() for f in futures)
            except DV.DeviceError:
                raise  # the card failed: loud, never a quiet rejection
            except (RuntimeError, OSError):
                # scheduler stopped / deadline surfaced mid-await: an
                # unverifiable proof is a REJECTED proof — this
                # function never raises into admission paths
                return False
    return all(
        verify_point(pk, payload, sig, lane=lane)
        for pk, payload, sig in decoded
    )


@functools.lru_cache(maxsize=1024)
def _cached_pubkey_from_bytes(data: bytes):
    return RB.pubkey_from_bytes(data)


def pubkey_from_bytes_cached(data: bytes) -> PublicKey:
    """Deserialization with the reference's 1024-entry LRU semantics
    (reference: crypto/bls/mask.go:9-16)."""
    return PublicKey(_cached_pubkey_from_bytes(bytes(data)), bytes(data))


__all__ = [
    "PublicKey",
    "PrivateKey",
    "Signature",
    "aggregate_sigs",
    "proof_of_possession",
    "pubkey_from_bytes_cached",
    "verify_proof_of_possession",
    "PUBKEY_BYTES",
    "SIG_BYTES",
]
