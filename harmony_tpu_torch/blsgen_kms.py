"""KMS-style BLS key loading: envelope-encrypted keyfiles.

The role of the reference's internal/blsgen/kms.go: BLS secret keys
stored as ciphertext envelopes that only a key-management service can
open (AWS KMS Decrypt in the reference; the node config selects the
provider).  The provider is pluggable here:

* ``LocalKMSProvider`` — a master-key file plays the KMS: envelopes
  are keccak-CTR encrypted + HMAC-SHA256 authenticated under keys
  derived from the master secret.  Operationally equivalent shape
  (key material never sits in the keyfile), stdlib-only.
* ``AwsKMSProvider`` — the socket for the real service; raises with
  guidance when the AWS SDK is absent from the image (zero-egress
  build environments cannot reach KMS anyway).

Envelope format (JSON): {"version", "nonce", "ciphertext", "mac"},
hex-encoded fields.  Plaintext is the 32-byte BLS secret key exactly
as keystore.py stores it.

The port's copy of the JAX package's ``blsgen_kms.py``.
"""

from __future__ import annotations

import hmac
import json
import os
import secrets

from .ref.keccak import keccak256

ENVELOPE_VERSION = 1


class KMSError(ValueError):
    pass


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = b""
    ctr = 0
    while len(out) < n:
        out += keccak256(key + nonce + ctr.to_bytes(8, "big"))
        ctr += 1
    return out[:n]


class LocalKMSProvider:
    """Master-key-file provider (the 'KMS' is a root secret on disk
    with tighter permissions than the keyfiles it opens)."""

    def __init__(self, master_key_path: str):
        with open(master_key_path, "rb") as f:
            master = f.read().strip()
        if len(master) < 32:
            raise KMSError("master key must be >= 32 bytes")
        self._enc_key = keccak256(b"blsgen-enc" + master)
        self._mac_key = keccak256(b"blsgen-mac" + master)

    @staticmethod
    def generate_master(path: str):
        with open(path, "wb") as f:
            f.write(secrets.token_bytes(64))
        os.chmod(path, 0o600)

    def encrypt(self, plaintext: bytes) -> dict:
        nonce = secrets.token_bytes(16)
        ct = bytes(
            a ^ b for a, b in zip(
                plaintext, _keystream(self._enc_key, nonce, len(plaintext))
            )
        )
        mac = hmac.new(self._mac_key, nonce + ct, "sha256").digest()
        return {
            "version": ENVELOPE_VERSION,
            "nonce": nonce.hex(),
            "ciphertext": ct.hex(),
            "mac": mac.hex(),
        }

    def decrypt(self, envelope: dict) -> bytes:
        if envelope.get("version") != ENVELOPE_VERSION:
            raise KMSError("unknown envelope version")
        nonce = bytes.fromhex(envelope["nonce"])
        ct = bytes.fromhex(envelope["ciphertext"])
        want = hmac.new(self._mac_key, nonce + ct, "sha256").digest()
        if not hmac.compare_digest(want.hex(), envelope["mac"]):
            raise KMSError("envelope MAC mismatch (wrong master key?)")
        return bytes(
            a ^ b for a, b in zip(
                ct, _keystream(self._enc_key, nonce, len(ct))
            )
        )


class AwsKMSProvider:
    """The reference's provider (kms.go AwsConfig).  This image has no
    AWS SDK and no egress; constructing one states that plainly
    instead of half-working."""

    def __init__(self, *args, **kwargs):
        raise KMSError(
            "AWS KMS requires the AWS SDK and network egress; use "
            "LocalKMSProvider on this image or plug a client with a "
            ".decrypt(envelope)->bytes surface"
        )


def save_kms_key(path: str, sk_bytes: bytes, provider) -> None:
    """Write an envelope keyfile (reference: .bls ciphertext files)."""
    if len(sk_bytes) != 32:
        raise KMSError("BLS secret key must be 32 bytes")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(provider.encrypt(sk_bytes), f)
    os.chmod(path, 0o600)


def load_kms_key(path: str, provider) -> bytes:
    """Open an envelope keyfile; returns the 32-byte secret key."""
    with open(path, encoding="utf-8") as f:
        try:
            envelope = json.load(f)
        except json.JSONDecodeError as e:
            raise KMSError(f"malformed envelope: {e}") from e
    sk = provider.decrypt(envelope)
    if len(sk) != 32:
        raise KMSError("envelope did not contain a 32-byte key")
    return sk
