"""Sidecar wire protocol v1: length-prefixed binary frames.

Frame layout (little-endian):

    [u32 frame_len] [u8 msg_type] [u32 request_id] [body ...]

frame_len counts everything after itself.  Responses echo request_id and
set bit 7 of msg_type; body starts with a u8 status (0 = OK).

Bit 6 of msg_type (TRACE_FLAG) marks an OPTIONAL trace context: the
body is then prefixed with [u8 tc_len][tc_len bytes traceparent]
(trace.traceparent binary form).  Requests only; responses are always
sent with the base type | RESP_FLAG.  Clients that never set the bit
(the native C++ client) speak the v1 wire format unchanged.  The
reverse skew — a TRACED client against a server that predates the
bit — is NOT compatible: such a server would echo the flagged type in
its response and the client's type check would treat that as a stream
desync, so arm tracing only against a TRACE_FLAG-aware sidecar (both
halves live in this repo and ship together).

Message bodies:

    PING          -> empty; response body: protocol version u16
    SET_COMMITTEE -> u64 epoch, u32 shard, u32 n, n * 48B pubkeys
                     (the epoch-keyed device table upload; steady-state
                     requests then carry only bitmaps + signatures,
                     SURVEY.md §7.3)
    AGG_VERIFY    -> u64 epoch, u32 shard, u16 payload_len, payload,
                     u16 bitmap_len, bitmap, 96B aggregate signature
                     response: u8 ok
    VERIFY_BATCH  -> u32 n, n * (48B pubkey, u16 payload_len, payload,
                     96B signature); response: u32 n, n * u8 ok

Max frame 2 MB — mirroring the reference's libp2p message cap
(reference: p2p/host.go:98-99).
"""

from __future__ import annotations

import struct

VERSION = 1
MAX_FRAME = 2 * 1024 * 1024

MSG_PING = 0x01
MSG_SET_COMMITTEE = 0x02
MSG_AGG_VERIFY = 0x03
MSG_VERIFY_BATCH = 0x04
TRACE_FLAG = 0x40
RESP_FLAG = 0x80

STATUS_OK = 0
STATUS_ERROR = 1
STATUS_UNKNOWN_COMMITTEE = 2
STATUS_BAD_REQUEST = 3


def pack_frame(msg_type: int, request_id: int, body: bytes,
               trace_ctx: bytes = b"") -> bytes:
    if trace_ctx:
        if len(trace_ctx) > 255:
            raise ValueError("trace context too large")
        msg_type |= TRACE_FLAG
        body = bytes([len(trace_ctx)]) + trace_ctx + body
    frame_len = 1 + 4 + len(body)
    if frame_len > MAX_FRAME:
        raise ValueError("frame too large")
    return struct.pack("<IBI", frame_len, msg_type, request_id) + body


def split_trace(msg_type: int, body: bytes):
    """(base msg_type, trace_ctx, body) — strips the TRACE_FLAG prefix
    when present.  A truncated prefix raises ValueError (frame-level
    garbage, same contract as read_frame)."""
    if not msg_type & TRACE_FLAG:
        return msg_type, b"", body
    if not body or len(body) < 1 + body[0]:
        raise ValueError("truncated trace context")
    tc_len = body[0]
    return (msg_type & ~TRACE_FLAG, body[1:1 + tc_len],
            body[1 + tc_len:])


def unpack_frame(data: bytes):
    """(msg_type, request_id, body) from one complete frame (sans length)."""
    if len(data) < 5:
        raise ValueError("short frame")
    msg_type, request_id = struct.unpack_from("<BI", data)
    return msg_type, request_id, data[5:]


def read_frame(sock, on_header=None):
    """Blocking read of one frame from a socket; None on clean EOF.

    ``on_header`` (optional zero-arg callable) fires the moment the
    length header has arrived — i.e. when a frame is KNOWN to be in
    flight.  The client reader uses it to flip its watchdog heartbeat
    from idle (quietly parked awaiting traffic) to busy: a peer that
    starts a frame and then stalls mid-body is a wedge the watchdog
    must see, not an idle wait."""
    hdr = _read_exact(sock, 4)
    if hdr is None:
        return None
    if on_header is not None:
        on_header()
    (frame_len,) = struct.unpack("<I", hdr)
    if not 5 <= frame_len <= MAX_FRAME:
        raise ValueError(f"bad frame length {frame_len}")
    data = _read_exact(sock, frame_len)
    if data is None:
        raise ValueError("truncated frame")
    return unpack_frame(data)


def _read_exact(sock, n: int):
    """Read exactly n bytes; None on clean EOF at a frame boundary,
    ValueError if the stream dies mid-read (truncation is an error)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise ValueError("stream truncated mid-read")
        buf += chunk
    return bytes(buf)


# --- body builders/parsers -------------------------------------------------


def build_set_committee(epoch: int, shard: int, pubkeys: list) -> bytes:
    body = struct.pack("<QII", epoch, shard, len(pubkeys))
    for pk in pubkeys:
        if len(pk) != 48:
            raise ValueError("pubkey must be 48 bytes")
        body += pk
    return body


def _unpack(fmt: str, body: bytes, off: int = 0):
    """struct.unpack_from with the protocol's error contract: a short
    body is a ValueError (typed wire garbage), never a struct.error
    leaking into callers that only catch ValueError."""
    try:
        return struct.unpack_from(fmt, body, off)
    except struct.error as e:
        raise ValueError(f"truncated frame body: {e}") from e


def parse_set_committee(body: bytes):
    epoch, shard, n = _unpack("<QII", body)
    off = 16
    if len(body) != off + 48 * n:
        raise ValueError("bad SET_COMMITTEE length")
    keys = [body[off + 48 * i : off + 48 * (i + 1)] for i in range(n)]
    return epoch, shard, keys


def build_agg_verify(
    epoch: int, shard: int, payload: bytes, bitmap: bytes, sig: bytes
) -> bytes:
    if len(sig) != 96:
        raise ValueError("signature must be 96 bytes")
    return (
        struct.pack("<QIH", epoch, shard, len(payload))
        + payload
        + struct.pack("<H", len(bitmap))
        + bitmap
        + sig
    )


def parse_agg_verify(body: bytes):
    epoch, shard, plen = _unpack("<QIH", body)
    off = 14
    if plen > len(body) - off:
        raise ValueError("bad AGG_VERIFY length")
    payload = body[off : off + plen]
    off += plen
    (blen,) = _unpack("<H", body, off)
    off += 2
    if blen > len(body) - off:
        raise ValueError("bad AGG_VERIFY length")
    bitmap = body[off : off + blen]
    off += blen
    sig = body[off : off + 96]
    if len(sig) != 96 or off + 96 != len(body):
        raise ValueError("bad AGG_VERIFY length")
    return epoch, shard, payload, bitmap, sig


def build_verify_batch(items: list) -> bytes:
    """items: [(pubkey48, payload, sig96)]"""
    body = struct.pack("<I", len(items))
    for pk, payload, sig in items:
        if len(pk) != 48 or len(sig) != 96:
            raise ValueError("bad item sizes")
        body += pk + struct.pack("<H", len(payload)) + payload + sig
    return body


def parse_verify_batch(body: bytes):
    (n,) = _unpack("<I", body)
    off = 4
    # each item is >= 48 + 2 + 96 bytes: reject an inflated count
    # BEFORE looping — a forged u32 must not allocate n tuples
    if n * (48 + 2 + 96) > len(body) - off:
        raise ValueError(
            f"implausible VERIFY_BATCH count {n} for "
            f"{len(body) - off} body bytes"
        )
    items = []
    for _ in range(n):
        pk = body[off : off + 48]
        off += 48
        (plen,) = _unpack("<H", body, off)
        off += 2
        if plen > len(body) - off:
            raise ValueError("bad VERIFY_BATCH length")
        payload = body[off : off + plen]
        off += plen
        sig = body[off : off + 96]
        off += 96
        items.append((pk, payload, sig))
    if off != len(body):
        raise ValueError("bad VERIFY_BATCH length")
    return items
