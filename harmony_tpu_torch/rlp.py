"""RLP encoding/decoding (reference: the go-ethereum rlp package the
whole reference serializes with — crypto/hash/rlp.go hashes RLP,
block/header.go v0-v3 headers are RLP, taggedrlp wraps RLP).

Canonical rules (Ethereum yellow paper appendix B):
- a single byte < 0x80 is its own encoding;
- a string of length <= 55 is [0x80 + len] || bytes;
- longer strings are [0xb7 + len(len)] || len || bytes;
- lists concatenate item encodings with [0xc0/0xf7...] headers.

Integers encode as big-endian with no leading zeros (0 -> empty
string).  Decoding is strict: non-canonical forms (leading zeros in
lengths, single bytes wrapped as strings) are rejected — consensus
objects must have ONE valid encoding.
"""

from __future__ import annotations


class RLPError(ValueError):
    pass


def encode(item) -> bytes:
    """item: bytes, int (non-negative), or list/tuple of items."""
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _len_prefix(len(payload), 0xC0) + payload
    if isinstance(item, bool):
        raise RLPError("bools are not RLP (encode as int explicitly)")
    if isinstance(item, int):
        if item < 0:
            raise RLPError("negative ints are not RLP")
        item = int_to_bytes(item)
    if isinstance(item, (bytes, bytearray, memoryview)):
        item = bytes(item)
        if len(item) == 1 and item[0] < 0x80:
            return item
        return _len_prefix(len(item), 0x80) + item
    raise RLPError(f"cannot RLP-encode {type(item).__name__}")


def _len_prefix(length: int, offset: int) -> bytes:
    if length <= 55:
        return bytes([offset + length])
    lb = int_to_bytes(length)
    return bytes([offset + 55 + len(lb)]) + lb


def int_to_bytes(v: int) -> bytes:
    if v == 0:
        return b""
    return v.to_bytes((v.bit_length() + 7) // 8, "big")


def bytes_to_int(b: bytes) -> int:
    return int.from_bytes(b, "big")


def decode(data: bytes):
    """Strict decode of ONE item; trailing bytes are an error.
    Returns nested bytes/list structure (ints are application-level)."""
    item, rest = _decode_one(memoryview(bytes(data)))
    if rest:
        raise RLPError("trailing bytes after RLP item")
    return item


def _read_length(view, offset_byte, base, long_base):
    tag = view[0]
    if tag <= base + 55:
        return tag - base, 1
    n_len = tag - (base + 55)
    if len(view) < 1 + n_len:
        raise RLPError("truncated length")
    lb = bytes(view[1:1 + n_len])
    if n_len == 0 or lb[0] == 0:
        raise RLPError("non-canonical length")
    length = bytes_to_int(lb)
    if length <= 55:
        raise RLPError("non-canonical long length")
    return length, 1 + n_len


def _decode_one(view):
    if len(view) == 0:
        raise RLPError("empty input")
    tag = view[0]
    if tag < 0x80:
        return bytes(view[0:1]), view[1:]
    if tag < 0xC0:
        length, hdr = _read_length(view, tag, 0x80, 0xB7)
        if len(view) < hdr + length:
            raise RLPError("truncated string")
        out = bytes(view[hdr:hdr + length])
        if length == 1 and out[0] < 0x80:
            raise RLPError("non-canonical single byte")
        return out, view[hdr + length:]
    length, hdr = _read_length(view, tag, 0xC0, 0xF7)
    if len(view) < hdr + length:
        raise RLPError("truncated list")
    body = view[hdr:hdr + length]
    items = []
    while len(body):
        item, body = _decode_one(body)
        items.append(item)
    return items, view[hdr + length:]


def decode_int(b) -> int:
    """Application-level int view of a decoded byte string (canonical:
    no leading zeros)."""
    if not isinstance(b, bytes):
        raise RLPError("int field is not a byte string")
    if b[:1] == b"\x00":
        raise RLPError("non-canonical int (leading zero)")
    return bytes_to_int(b)
