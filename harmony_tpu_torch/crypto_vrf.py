"""BLS-based VRF: verifiable randomness from the signature pipeline.

Behavioral parity with the reference's BLS VRF (reference:
crypto/vrf/bls/bls_vrf.go:63-99): the proof IS a BLS signature over the
message, and the VRF output is its hash — uniqueness of BLS signatures
makes the output unpredictable-but-verifiable.  Rides the same
sign/verify path as consensus votes (SURVEY.md §2.1): signing on the
host, the check through ``bls`` onto the device when
``device.device_enabled()``.

The port's copy of the JAX package's ``crypto_vrf.py``.
"""

from __future__ import annotations

import hashlib

from .bls import PrivateKey, PublicKey, Signature

VRF_OUTPUT_BYTES = 32


def evaluate(sk: PrivateKey, message: bytes):
    """(vrf_output, proof): proof = BLS sig over message, output =
    sha256(proof bytes)."""
    proof = sk.sign_hash(message)
    return hashlib.sha256(proof.bytes).digest(), proof.bytes


def proof_to_hash(proof_bytes: bytes) -> bytes:
    """Derive the VRF output from a proof (no verification)."""
    if len(proof_bytes) != 96:
        raise ValueError("VRF proof must be a 96-byte signature")
    return hashlib.sha256(proof_bytes).digest()


def verify(pk: PublicKey, message: bytes, proof_bytes: bytes):
    """Check the proof and return the VRF output, or raise ValueError.
    A check bound for the card that cannot run raises
    ``device.DeviceError`` instead: never an invalid proof."""
    sig = Signature.from_bytes(proof_bytes)
    if not sig.verify(pk, message):
        raise ValueError("invalid VRF proof")
    return proof_to_hash(proof_bytes)
