"""Encrypted BLS key files: loading and storing validator keys.

The role of the reference's blsgen (reference: internal/blsgen/loader.go,
passphrase.go — passphrase-encrypted .key files; the KMS path is cloud
glue out of scope here).  Stdlib-only authenticated encryption:

    key material = scrypt(passphrase, salt, n=2^15, r=8, p=1, 64 bytes)
                   -> 32B cipher key || 32B MAC key
    ciphertext   = sk XOR SHA256(cipher_key || counter) keystream
    tag          = HMAC-SHA256(mac_key, salt || ciphertext)   (EtM)

The file is JSON with hex fields, carrying the public key for
identification (as the reference's keyfile naming does).

The port's copy of the JAX package's ``keystore.py``.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os

from .bls import PrivateKey

_VERSION = 1
_SCRYPT_N = 1 << 15
_SCRYPT_R = 8
_SCRYPT_P = 1


def _derive(passphrase: bytes, salt: bytes):
    km = hashlib.scrypt(
        passphrase, salt=salt, n=_SCRYPT_N, r=_SCRYPT_R, p=_SCRYPT_P,
        maxmem=64 * 1024 * 1024, dklen=64,
    )
    return km[:32], km[32:]


def _keystream(cipher_key: bytes, length: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < length:
        out += hashlib.sha256(
            cipher_key + counter.to_bytes(8, "little")
        ).digest()
        counter += 1
    return bytes(out[:length])


def encrypt_key(sk: PrivateKey, passphrase: str) -> bytes:
    salt = os.urandom(16)
    cipher_key, mac_key = _derive(passphrase.encode(), salt)
    plaintext = sk.bytes
    ciphertext = bytes(
        a ^ b for a, b in zip(plaintext, _keystream(cipher_key, len(plaintext)))
    )
    tag = hmac.new(mac_key, salt + ciphertext, hashlib.sha256).digest()
    blob = {
        "version": _VERSION,
        "pubkey": sk.pub.bytes.hex(),
        "salt": salt.hex(),
        "ciphertext": ciphertext.hex(),
        "mac": tag.hex(),
    }
    return json.dumps(blob, indent=1).encode()


def decrypt_key(data: bytes, passphrase: str) -> PrivateKey:
    try:
        blob = json.loads(data)
        if blob["version"] != _VERSION:
            raise ValueError(f"unsupported keyfile version {blob['version']}")
        salt = bytes.fromhex(blob["salt"])
        ciphertext = bytes.fromhex(blob["ciphertext"])
        tag = bytes.fromhex(blob["mac"])
        expected_pub = bytes.fromhex(blob["pubkey"])
    except (KeyError, json.JSONDecodeError) as e:
        raise ValueError(f"malformed keyfile: {e}") from e
    cipher_key, mac_key = _derive(passphrase.encode(), salt)
    want = hmac.new(mac_key, salt + ciphertext, hashlib.sha256).digest()
    if not hmac.compare_digest(tag, want):
        raise ValueError("wrong passphrase or corrupted keyfile")
    plaintext = bytes(
        a ^ b
        for a, b in zip(ciphertext, _keystream(cipher_key, len(ciphertext)))
    )
    sk = PrivateKey.from_bytes(plaintext)
    if sk.pub.bytes != expected_pub:
        raise ValueError("keyfile pubkey mismatch after decryption")
    return sk


def save_key(path: str, sk: PrivateKey, passphrase: str):
    with open(path, "wb") as f:
        f.write(encrypt_key(sk, passphrase))


def load_key(path: str, passphrase: str) -> PrivateKey:
    with open(path, "rb") as f:
        return decrypt_key(f.read(), passphrase)


def load_keys(paths_and_passphrases) -> list:
    """Load several keyfiles (the multibls startup path — reference:
    internal/blsgen/loader.go:13 LoadKeys)."""
    return [load_key(p, pw) for p, pw in paths_and_passphrases]
