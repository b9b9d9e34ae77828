"""BIP-32/BIP-44 HD key derivation over secp256k1.

The role of the reference's HD wallet support (the hmy CLI derives
accounts at Harmony's registered coin type: m/44'/1023'/0'/0/index).
Implements:

* BIP-39 seed derivation: PBKDF2-HMAC-SHA512(mnemonic, "mnemonic" ||
  passphrase, 2048) — note the 2048-word checksum validation step is
  intentionally omitted (no vendored wordlist); any UTF-8 mnemonic
  string derives, exactly as BIP-39's seed step does;
* BIP-32 CKD: master key from HMAC-SHA512("Bitcoin seed", seed),
  hardened + normal child derivation;
* BIP-44 account paths with HARMONY_COIN_TYPE = 1023.

The port's copy of the JAX package's ``accounts/hd.py``.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
from dataclasses import dataclass

from ..crypto_ecdsa import GX, GY, N, _add, _mul

HARMONY_COIN_TYPE = 1023
HARDENED = 0x80000000


def mnemonic_to_seed(mnemonic: str, passphrase: str = "") -> bytes:
    return hashlib.pbkdf2_hmac(
        "sha512",
        mnemonic.encode("utf-8"),
        b"mnemonic" + passphrase.encode("utf-8"),
        2048,
        64,
    )


def _ser_point(pt) -> bytes:
    """Compressed SEC1: parity prefix + 32-byte x."""
    x, y = pt
    return bytes([2 + (y & 1)]) + x.to_bytes(32, "big")


@dataclass
class HDKey:
    key: int          # private scalar
    chain_code: bytes

    @classmethod
    def master(cls, seed: bytes) -> "HDKey":
        digest = hmac.new(b"Bitcoin seed", seed, hashlib.sha512).digest()
        k = int.from_bytes(digest[:32], "big")
        if not 0 < k < N:
            raise ValueError("unusable master seed (p < 2^-127)")
        return cls(k, digest[32:])

    def child(self, index: int) -> "HDKey":
        if index >= HARDENED:
            data = b"\x00" + self.key.to_bytes(32, "big")
        else:
            data = _ser_point(_mul(self.key, (GX, GY)))
        data += struct.pack(">I", index)
        digest = hmac.new(self.chain_code, data, hashlib.sha512).digest()
        il = int.from_bytes(digest[:32], "big")
        child_key = (il + self.key) % N
        if il >= N or child_key == 0:
            # per BIP-32: skip to the next index (p < 2^-127)
            return self.child(index + 1)
        return HDKey(child_key, digest[32:])

    def derive_path(self, path: str) -> "HDKey":
        """'m/44'/1023'/0'/0/7' -> the key at that path."""
        node = self
        parts = path.split("/")
        if parts and parts[0] in ("m", "M"):
            parts = parts[1:]
        for part in parts:
            if not part:
                continue
            hardened = part.endswith(("'", "h", "H"))
            idx = int(part.rstrip("'hH"))
            node = node.child(idx | (HARDENED if hardened else 0))
        return node

    def ecdsa_key(self):
        from ..crypto_ecdsa import ECDSAKey

        return ECDSAKey(self.key)


def derive_account(mnemonic: str, index: int = 0,
                   passphrase: str = ""):
    """The hmy CLI's default account path: m/44'/1023'/0'/0/index.
    Returns an ECDSAKey."""
    master = HDKey.master(mnemonic_to_seed(mnemonic, passphrase))
    return master.derive_path(
        f"m/44'/{HARMONY_COIN_TYPE}'/0'/0/{index}"
    ).ecdsa_key()
