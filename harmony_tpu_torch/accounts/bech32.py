"""Bech32 (BIP-173) + Harmony ``one1...`` address codec.

The reference addresses validators and genesis accounts by bech32 with
HRP "one" (reference: internal/common/address.go ParseAddr,
internal/bech32) — 20-byte ethereum-style payloads re-encoded for
display.  Implemented from the BIP-173 specification (generator
constants, polymod checksum, 5-bit regrouping); no external code.

The port's copy of the JAX package's ``accounts/bech32.py``.
"""

from __future__ import annotations

_CHARSET = "qpzry9x8gf2tvdw0s3jn54khce6mua7l"
_GEN = (0x3B6A57B2, 0x26508E6D, 0x1EA119FA, 0x3D4233DD, 0x2A1462B3)

HRP = "one"


def _polymod(values) -> int:
    chk = 1
    for v in values:
        top = chk >> 25
        chk = (chk & 0x1FFFFFF) << 5 ^ v
        for i in range(5):
            if (top >> i) & 1:
                chk ^= _GEN[i]
    return chk


def _hrp_expand(hrp: str) -> list:
    return [ord(c) >> 5 for c in hrp] + [0] + [ord(c) & 31 for c in hrp]


def _create_checksum(hrp: str, data: list) -> list:
    values = _hrp_expand(hrp) + data
    mod = _polymod(values + [0, 0, 0, 0, 0, 0]) ^ 1
    return [(mod >> 5 * (5 - i)) & 31 for i in range(6)]


def _convertbits(data, frombits: int, tobits: int, pad: bool) -> list:
    acc = 0
    bits = 0
    ret = []
    maxv = (1 << tobits) - 1
    for b in data:
        if b < 0 or b >> frombits:
            raise ValueError("invalid data byte")
        acc = (acc << frombits) | b
        bits += frombits
        while bits >= tobits:
            bits -= tobits
            ret.append((acc >> bits) & maxv)
    if pad:
        if bits:
            ret.append((acc << (tobits - bits)) & maxv)
    elif bits >= frombits or ((acc << (tobits - bits)) & maxv):
        raise ValueError("invalid bech32 padding")
    return ret


def bech32_encode(hrp: str, payload: bytes) -> str:
    data = _convertbits(payload, 8, 5, True)
    checksum = _create_checksum(hrp, data)
    return hrp + "1" + "".join(_CHARSET[d] for d in data + checksum)


def bech32_decode(addr: str) -> tuple[str, bytes]:
    if addr.lower() != addr and addr.upper() != addr:
        raise ValueError("mixed-case bech32")
    addr = addr.lower()
    pos = addr.rfind("1")
    if pos < 1 or pos + 7 > len(addr) or len(addr) > 90:
        raise ValueError("malformed bech32")
    hrp, rest = addr[:pos], addr[pos + 1:]
    if any(c not in _CHARSET for c in rest):
        raise ValueError("invalid bech32 character")
    data = [_CHARSET.index(c) for c in rest]
    if _polymod(_hrp_expand(hrp) + data) != 1:
        raise ValueError("bad bech32 checksum")
    return hrp, bytes(_convertbits(data[:-6], 5, 8, False))


def one_to_address(one_addr: str) -> bytes:
    """one1... -> 20-byte address (reference: common.ParseAddr)."""
    hrp, payload = bech32_decode(one_addr)
    if hrp != HRP:
        raise ValueError(f"not a harmony address (hrp {hrp!r})")
    if len(payload) != 20:
        raise ValueError("harmony address payload must be 20 bytes")
    return payload


def address_to_one(addr: bytes) -> str:
    """20-byte address -> one1... display form."""
    if len(addr) != 20:
        raise ValueError("address must be 20 bytes")
    return bech32_encode(HRP, addr)
