"""Contract ABI codec: Solidity argument encoding + selectors.

The role of the reference's accounts/abi (go-ethereum fork, consumed
by e.g. staking/precompile.go's method dispatch).  Supports the ABI
head/tail encoding for: address, bool, uintN/intN, bytesN, bytes,
string, fixed arrays T[k], dynamic arrays T[], and TUPLES
"(T1,T2,...)" nested arbitrarily — plus event topic/log codecs and
standard error decoding (Error(string), Panic(uint256), custom
4-byte-selector errors).  Types are given as strings ("uint256",
"address[]", "(uint256,bytes)[4]").

The port's copy of the JAX package's ``accounts/abi.py``.
"""

from __future__ import annotations

from ..ref.keccak import keccak256


def function_selector(signature: str) -> bytes:
    """keccak('Name(type1,type2)')[:4]."""
    return keccak256(signature.encode())[:4]


def split_types(inner: str) -> list:
    """Split a comma-joined type list respecting tuple parens:
    'uint256,(address,bytes)[],bool' -> 3 entries."""
    out, depth, cur = [], 0, []
    for ch in inner:
        if ch == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
            continue
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        cur.append(ch)
    if cur:
        out.append("".join(cur).strip())
    return [t for t in out if t]


def _tuple_inner(typ: str) -> list:
    """Component types of a tuple type '(...)'."""
    return split_types(typ[1:-1])


def _split_array(typ: str) -> tuple:
    """'T[..k]' -> (base, k|None); respects a trailing array suffix
    only (the base may itself be a tuple/array)."""
    base, _, count = typ.rpartition("[")
    return base, (None if count == "]" else int(count[:-1]))


def _is_dynamic(typ: str) -> bool:
    if typ.endswith("]"):
        base, k = _split_array(typ)
        if k is None:  # T[]
            return True
        return _is_dynamic(base)
    if typ.startswith("("):
        return any(_is_dynamic(t) for t in _tuple_inner(typ))
    return typ in ("bytes", "string")


def _head_words(typ: str) -> int:
    """Head size in 32-byte words for a STATIC type."""
    if _is_dynamic(typ):
        return 1
    if typ.endswith("]"):
        base, k = _split_array(typ)
        return k * _head_words(base)
    if typ.startswith("("):
        return sum(_head_words(t) for t in _tuple_inner(typ))
    return 1


def _pad32(b: bytes, left: bool = True) -> bytes:
    if len(b) > 32:
        raise ValueError("value exceeds one word")
    return b.rjust(32, b"\x00") if left else b.ljust(32, b"\x00")


def _enc_head(typ: str, value) -> bytes:
    if typ == "address":
        if isinstance(value, str):
            value = bytes.fromhex(value[2:] if value.startswith("0x")
                                  else value)
        if len(value) != 20:
            raise ValueError("address must be 20 bytes")
        return _pad32(value)
    if typ == "bool":
        return _pad32(b"\x01" if value else b"\x00")
    if typ.startswith("uint"):
        bits = int(typ[4:] or 256)
        v = int(value)
        if v < 0 or v >= 1 << bits:
            raise ValueError(f"{typ} out of range")
        return _pad32(v.to_bytes(32, "big"))
    if typ.startswith("int"):
        bits = int(typ[3:] or 256)
        v = int(value)
        if v < -(1 << (bits - 1)) or v >= 1 << (bits - 1):
            raise ValueError(f"{typ} out of range")
        return v.to_bytes(32, "big", signed=True)
    if typ.startswith("bytes") and typ != "bytes":
        n = int(typ[5:])
        if not 1 <= n <= 32 or len(value) != n:
            raise ValueError(f"bad {typ} value")
        return _pad32(value, left=False)
    raise ValueError(f"not a static head type: {typ}")


def _enc_dynamic(typ: str, value) -> bytes:
    if typ in ("bytes", "string"):
        raw = value.encode() if isinstance(value, str) else bytes(value)
        padded = raw.ljust((len(raw) + 31) // 32 * 32, b"\x00")
        return _pad32(len(raw).to_bytes(32, "big")) + padded
    if typ.endswith("]"):
        base, k = _split_array(typ)
        if k is None:
            return (
                _pad32(len(value).to_bytes(32, "big"))
                + abi_encode([base] * len(value), list(value))
            )
        if len(value) != k:
            raise ValueError(f"expected {k} elements")
        return abi_encode([base] * k, list(value))
    if typ.startswith("("):  # dynamic tuple: its own head/tail block
        inner = _tuple_inner(typ)
        return abi_encode(inner, list(value))
    raise ValueError(f"not a dynamic type: {typ}")


def abi_encode(types: list, values: list) -> bytes:
    """The head/tail tuple encoding."""
    if len(types) != len(values):
        raise ValueError("types/values length mismatch")
    heads, tails = [], []
    head_size = 32 * sum(_head_words(t) for t in types)
    offset = head_size
    for t, v in zip(types, values):
        if _is_dynamic(t):
            tail = _enc_dynamic(t, v)
            heads.append(_pad32(offset.to_bytes(32, "big")))
            tails.append(tail)
            offset += len(tail)
        elif t.endswith("]"):
            base, k = _split_array(t)
            if len(v) != k:
                raise ValueError(f"expected {k} elements")
            heads.append(abi_encode([base] * k, list(v)))
        elif t.startswith("("):  # static tuple: heads inline
            heads.append(abi_encode(_tuple_inner(t), list(v)))
        else:
            heads.append(_enc_head(t, v))
    return b"".join(heads) + b"".join(tails)


def encode_call(signature: str, values: list) -> bytes:
    """'Delegate(address,address,uint256)' + values -> calldata."""
    inner = signature[signature.index("(") + 1:signature.rindex(")")]
    types = split_types(inner)
    return function_selector(signature) + abi_encode(types, values)


# -- decoding ----------------------------------------------------------------


def _dec_head(typ: str, word: bytes):
    if typ == "address":
        return word[12:]
    if typ == "bool":
        return word[-1] != 0
    if typ.startswith("uint"):
        return int.from_bytes(word, "big")
    if typ.startswith("int"):
        return int.from_bytes(word, "big", signed=True)
    if typ.startswith("bytes") and typ != "bytes":
        return word[: int(typ[5:])]
    raise ValueError(f"not a static head type: {typ}")


def _dec_dynamic(typ: str, data: bytes, at: int):
    if typ in ("bytes", "string"):
        ln = int.from_bytes(data[at:at + 32], "big")
        raw = data[at + 32:at + 32 + ln]
        if len(raw) != ln:
            raise ValueError("truncated dynamic value")
        return raw.decode() if typ == "string" else raw
    if typ.endswith("]"):
        base, k = _split_array(typ)
        if k is None:
            n = int.from_bytes(data[at:at + 32], "big")
            if n > 1 << 20:
                raise ValueError("array length too large")
            return abi_decode([base] * n, data[at + 32:])
        return abi_decode([base] * k, data[at:])
    if typ.startswith("("):  # dynamic tuple: decode its own block
        return tuple(abi_decode(_tuple_inner(typ), data[at:]))
    raise ValueError(f"not a dynamic type: {typ}")


def abi_decode(types: list, data: bytes) -> list:
    out = []
    off = 0
    for t in types:
        if _is_dynamic(t):
            at = int.from_bytes(data[off:off + 32], "big")
            out.append(_dec_dynamic(t, data, at))
            off += 32
        elif t.endswith("]"):
            base, k = _split_array(t)
            out.append(abi_decode([base] * k, data[off:]))
            off += 32 * _head_words(t)
        elif t.startswith("("):
            out.append(tuple(abi_decode(_tuple_inner(t), data[off:])))
            off += 32 * _head_words(t)
        else:
            out.append(_dec_head(t, data[off:off + 32]))
            off += 32
    return out


# -- events ------------------------------------------------------------------


def event_topic(signature: str) -> bytes:
    """topic0 = keccak('Transfer(address,address,uint256)') — full 32B."""
    return keccak256(signature.encode())


def encode_log(signature: str, indexed: list, values: list):
    """Build (topics, data) for an event: indexed[i] marks which
    arguments become topics (dynamic indexed args are keccak-hashed per
    the ABI spec); the rest ABI-encode into the data blob."""
    inner = signature[signature.index("(") + 1:signature.rindex(")")]
    types = split_types(inner)
    if not (len(types) == len(indexed) == len(values)):
        raise ValueError("types/indexed/values length mismatch")
    topics = [event_topic(signature)]
    d_types, d_values = [], []
    for t, ix, v in zip(types, indexed, values):
        if not ix:
            d_types.append(t)
            d_values.append(v)
            continue
        if _is_dynamic(t) or t.endswith("]") or t.startswith("("):
            topics.append(keccak256(
                _enc_dynamic(t, v) if _is_dynamic(t)
                else abi_encode([t], [v])
            ))
        else:
            topics.append(_enc_head(t, v))
    return topics, abi_encode(d_types, d_values)


def decode_log(signature: str, indexed: list, topics: list, data: bytes):
    """Inverse of encode_log: returns the argument list in declaration
    order.  Indexed DYNAMIC arguments are unrecoverable (the log holds
    their hash) and come back as the 32-byte topic hash."""
    inner = signature[signature.index("(") + 1:signature.rindex(")")]
    types = split_types(inner)
    if topics and topics[0] != event_topic(signature):
        raise ValueError("topic0 does not match the event signature")
    d_types = [t for t, ix in zip(types, indexed) if not ix]
    d_vals = iter(abi_decode(d_types, data))
    t_vals = iter(topics[1:])
    out = []
    for t, ix in zip(types, indexed):
        if not ix:
            out.append(next(d_vals))
        elif _is_dynamic(t) or t.endswith("]") or t.startswith("("):
            out.append(next(t_vals))  # hash only, by design
        else:
            out.append(_dec_head(t, next(t_vals)))
    return out


# -- errors ------------------------------------------------------------------

ERROR_STRING_SELECTOR = function_selector("Error(string)")
PANIC_SELECTOR = function_selector("Panic(uint256)")


def decode_error(data: bytes, custom: dict | None = None):
    """Decode revert data: ('Error', message) for the standard string
    revert, ('Panic', code) for compiler panics, (name, args) for a
    custom error given as {selector_bytes: ('Name(sig)', [types])},
    else ('unknown', raw bytes)."""
    if data.startswith(ERROR_STRING_SELECTOR):
        return "Error", abi_decode(["string"], data[4:])[0]
    if data.startswith(PANIC_SELECTOR):
        return "Panic", abi_decode(["uint256"], data[4:])[0]
    if custom and data[:4] in custom:
        sig, types = custom[data[:4]]
        return sig, abi_decode(types, data[4:])
    return "unknown", data
