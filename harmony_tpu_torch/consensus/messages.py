"""FBFT wire messages: types, signable payloads, and the aggregate
sig-and-bitmap encoding.

Behavioral parity with the reference's message construction (reference:
consensus/construct.go:99-176 and api/proto/message/harmonymessage.pb.go
MessageType values):

- PREPARE / COMMIT carry [96-byte BLS signature over the phase payload],
  locally aggregated across the node's multi-BLS keys;
- PREPARED / COMMITTED carry [96-byte aggregate sig || bitmap], the O(1)
  quorum proof (construct.go:157-176);
- sender identification is the serialized pubkey list of the node's keys.

Transport stays out of scope here (the reference uses libp2p gossip,
which remains host-side Go in the deployment story — SURVEY.md §2.5);
these are the payload semantics every transport must carry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..ref.params import PUBKEY_BYTES, SIG_BYTES


class MsgType(IntEnum):
    """reference: api/proto/message/harmonymessage.pb.go:80-122."""

    ANNOUNCE = 0
    PREPARE = 1
    PREPARED = 2
    COMMIT = 3
    COMMITTED = 4
    VIEWCHANGE = 5
    NEWVIEW = 6


@dataclass
class FBFTMessage:
    msg_type: MsgType
    view_id: int
    block_num: int
    block_hash: bytes
    sender_pubkeys: list = field(default_factory=list)  # serialized 48B keys
    payload: bytes = b""  # phase signature or [agg sig || bitmap]
    block: bytes = b""  # RLP-ish block bytes (ANNOUNCE/PREPARED)
    # BLS signature by the SENDER key(s) over the whole message
    # (keccak of the signable encoding) — the reference signs every
    # consensus message and verifies it on receipt
    # (consensus/construct.go signMessage + consensus/checks.go
    # senderKeySanityChecks/verify); without it any peer could
    # impersonate the leader's ANNOUNCE/PREPARED/COMMITTED
    sender_sig: bytes = b""
    # OPTIONAL trace context (trace.traceparent bytes):
    # transport metadata, deliberately OUTSIDE the signable encoding
    # and the dedup key — a relay stamping its own context must not
    # invalidate the sender signature, and a forged context can at
    # worst mislabel a span, never affect consensus
    trace_ctx: bytes = b""

    def key(self):
        """Dedup/storage key (reference: consensus/fbft_log.go:128-143)."""
        return (
            self.msg_type,
            self.view_id,
            self.block_num,
            self.block_hash,
            tuple(self.sender_pubkeys),
        )


def encode_sig_and_bitmap(agg_sig_bytes: bytes, bitmap: bytes) -> bytes:
    """[96B aggregate signature || participation bitmap]
    (reference: consensus/construct.go:157-176)."""
    if len(agg_sig_bytes) != SIG_BYTES:
        raise ValueError("aggregate signature must be 96 bytes")
    return agg_sig_bytes + bitmap


def decode_sig_and_bitmap(payload: bytes, expected_bitmap_len: int):
    """Split and length-check a quorum proof (reference:
    internal/chain/sig.go:13-50 ParseCommitSigAndBitmap semantics)."""
    if len(payload) < SIG_BYTES:
        raise ValueError("payload shorter than a signature")
    sig, bitmap = payload[:SIG_BYTES], payload[SIG_BYTES:]
    if len(bitmap) != expected_bitmap_len:
        raise ValueError(
            f"bitmap length {len(bitmap)} != expected {expected_bitmap_len}"
        )
    return sig, bitmap


class FBFTLog:
    """In-memory store of blocks + messages per (type, blockNum, viewID,
    hash) (reference: consensus/fbft_log.go:128-314)."""

    def __init__(self):
        self._messages: dict = {}
        self._blocks: dict = {}

    def add_message(self, msg: FBFTMessage) -> bool:
        k = msg.key()
        if k in self._messages:
            return False
        self._messages[k] = msg
        return True

    def add_block(self, block_hash: bytes, block_bytes: bytes):
        self._blocks[block_hash] = block_bytes

    def get_block(self, block_hash: bytes):
        return self._blocks.get(block_hash)

    def get_messages(
        self, msg_type: MsgType, block_num: int | None = None,
        view_id: int | None = None, block_hash: bytes | None = None
    ):
        out = []
        for m in self._messages.values():
            if m.msg_type != msg_type:
                continue
            if block_num is not None and m.block_num != block_num:
                continue
            if view_id is not None and m.view_id != view_id:
                continue
            if block_hash is not None and m.block_hash != block_hash:
                continue
            out.append(m)
        return out

    def prune_below(self, block_num: int):
        """Drop messages for heights below block_num (reference:
        fbft_log.go deleteMessagesLessThan)."""
        self._messages = {
            k: m for k, m in self._messages.items() if m.block_num >= block_num
        }
        return self


# -- wire codec --------------------------------------------------------------

def signable_bytes(msg: FBFTMessage) -> bytes:
    """Every field EXCEPT the sender signature — what the sender key
    signs (reference: consensus/construct.go signMessage signs the
    marshaled message)."""
    out = bytearray()
    out += bytes([int(msg.msg_type)])
    out += msg.view_id.to_bytes(8, "little")
    out += msg.block_num.to_bytes(8, "little")
    if len(msg.block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    out += msg.block_hash
    out += len(msg.sender_pubkeys).to_bytes(4, "little")
    for pk in msg.sender_pubkeys:
        if len(pk) != PUBKEY_BYTES:
            raise ValueError("pubkey must be 48 bytes")
        out += pk
    out += len(msg.payload).to_bytes(4, "little") + msg.payload
    out += len(msg.block).to_bytes(4, "little") + msg.block
    return bytes(out)


def sign_message(msg: FBFTMessage, keys) -> FBFTMessage:
    """Set the sender signature: aggregate BLS over keccak of the
    signable encoding by ALL the node's keys (multibls)."""
    from ..ref.keccak import keccak256

    msg.sender_sig = keys.sign_hash_aggregated(
        keccak256(signable_bytes(msg))
    ).bytes
    return msg


def verify_sender_sig(msg: FBFTMessage, *, lane=None) -> bool:
    """The ingress gate (reference: consensus/checks.go verifySenderKey
    + message-signature verification): the claimed sender keys must
    have signed THIS exact message.  Malformed input returns False.

    ``lane`` picks the verification scheduler's priority lane; the
    node's gossip pump passes the INGRESS lane (per-message admission
    work — a forged flood must queue behind, never ahead of, the
    round's quorum proofs)."""
    from .. import bls as B
    from ..ref.keccak import keccak256

    if not msg.sender_pubkeys or len(msg.sender_sig) != SIG_BYTES:
        return False
    try:
        digest = keccak256(signable_bytes(msg))
    except ValueError:
        return False
    return B.verify_aggregate_bytes(
        msg.sender_pubkeys, digest, msg.sender_sig, lane=lane
    )


def encode_message(msg: FBFTMessage) -> bytes:
    """Canonical wire form (the payload inside the gossip envelope —
    the reference uses protobuf harmonymessage.pb.go; this framework
    uses its fixed little-endian layout).  The trace context is an
    optional unsigned trailer: absent entirely when empty, so traced
    and untraced nodes interoperate."""
    out = bytearray(signable_bytes(msg))
    out += len(msg.sender_sig).to_bytes(4, "little") + msg.sender_sig
    if msg.trace_ctx:
        out += len(msg.trace_ctx).to_bytes(2, "little") + msg.trace_ctx
    return bytes(out)


# -- aggregation overlay codec (consensus.aggregation) -----------------------

# hard ceiling on the participation bitmap, in BYTES: a 16384-slot
# committee — far above any mainnet shape, and small enough that the
# bound itself can never be the allocation attack
AGG_BITMAP_MAX = 2048
_AGG_FIXED = 1 + 8 + 8 + 32 + 1 + 2 + SIG_BYTES + 2


@dataclass
class AggContribution:
    """One partial multi-signature riding the aggregation overlay:
    self-certifying (the aggregate sig IS the authenticity proof — a
    forged one fails the pairing check against the bitmap's keys), so
    there is no sender signature to carry or verify."""

    phase: int          # aggregation.PHASE_PREPARE / PHASE_COMMIT
    view_id: int
    block_num: int
    block_hash: bytes
    level: int          # emitter's ladder level (observability)
    bitmap: bytes       # participation mask, Mask bit order
    sig: bytes          # 96B aggregate signature over the phase payload
    sender_slot: int    # emitter's home slot (attribution only)


def encode_aggregation(c: AggContribution) -> bytes:
    """[phase u8][view u64le][block u64le][hash 32][level u8]
    [bitmap u16le + bytes][sig 96B][sender_slot u16le]."""
    if len(c.block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    if len(c.sig) != SIG_BYTES:
        raise ValueError("aggregate signature must be 96 bytes")
    if not c.bitmap or len(c.bitmap) > AGG_BITMAP_MAX:
        raise ValueError("bitmap length out of range")
    out = bytearray()
    out += bytes([c.phase])
    out += c.view_id.to_bytes(8, "little")
    out += c.block_num.to_bytes(8, "little")
    out += c.block_hash
    out += bytes([c.level])
    out += len(c.bitmap).to_bytes(2, "little") + c.bitmap
    out += c.sig
    out += c.sender_slot.to_bytes(2, "little")
    return bytes(out)


def decode_aggregation(data: bytes) -> AggContribution:
    """Bounded decode (GL13): the ONE variable-length field's claimed
    size is budget-checked against both the hard ceiling and the
    actual bytes present BEFORE any slice, and the total length must
    match exactly — a length-inflated or truncated wire raises a typed
    ValueError without allocating anything proportional to the claim."""
    view = memoryview(data)
    if len(view) < _AGG_FIXED + 1:
        raise ValueError("aggregation message too short")
    phase = view[0]
    if phase not in (1, 2):
        raise ValueError("bad aggregation phase")
    bitmap_len = int.from_bytes(view[50:52], "little")
    if bitmap_len == 0 or bitmap_len > AGG_BITMAP_MAX:
        raise ValueError("absurd bitmap length")
    if len(view) != _AGG_FIXED + bitmap_len:
        raise ValueError(
            f"aggregation length {len(view)} != expected "
            f"{_AGG_FIXED + bitmap_len}"
        )
    off = 52 + bitmap_len
    return AggContribution(
        phase=phase,
        view_id=int.from_bytes(view[1:9], "little"),
        block_num=int.from_bytes(view[9:17], "little"),
        block_hash=bytes(view[17:49]),
        level=view[49],
        bitmap=bytes(view[52:off]),
        sig=bytes(view[off:off + SIG_BYTES]),
        sender_slot=int.from_bytes(
            view[off + SIG_BYTES:off + SIG_BYTES + 2], "little"
        ),
    )


def decode_message(data: bytes) -> FBFTMessage:
    """Bounded decode: every length prefix is checked against the
    remaining bytes BEFORE its slice, so a length-inflated wire raises
    (typed) instead of silently truncating into garbage fields — a
    forged frame costs its own size, never more."""
    view = memoryview(data)
    if len(view) < 1 + 8 + 8 + 32 + 4:
        raise ValueError("message too short")
    off = 0
    msg_type = MsgType(view[off]); off += 1
    view_id = int.from_bytes(view[off:off + 8], "little"); off += 8
    block_num = int.from_bytes(view[off:off + 8], "little"); off += 8
    block_hash = bytes(view[off:off + 32]); off += 32
    n_keys = int.from_bytes(view[off:off + 4], "little"); off += 4
    if n_keys > 4096 or n_keys * PUBKEY_BYTES > len(view) - off:
        raise ValueError("absurd key count")
    keys = []
    for _ in range(n_keys):
        keys.append(bytes(view[off:off + PUBKEY_BYTES]))
        off += PUBKEY_BYTES

    def _field(width: int) -> bytes:
        nonlocal off
        if len(view) - off < width:
            raise ValueError("truncated length prefix")
        ln = int.from_bytes(view[off:off + width], "little")
        off += width
        if ln > len(view) - off:
            raise ValueError(
                f"field length {ln} overruns message "
                f"({len(view) - off} bytes left)"
            )
        out = bytes(view[off:off + ln])
        off += ln
        return out

    payload = _field(4)
    block = _field(4)
    sender_sig = _field(4)
    trace_ctx = b""
    if off != len(view):
        # optional trace-context trailer (u16 len + bytes)
        trace_ctx = _field(2)
        if off != len(view):
            raise ValueError("trailing bytes in message")
    return FBFTMessage(
        msg_type=msg_type, view_id=view_id, block_num=block_num,
        block_hash=block_hash, sender_pubkeys=keys, payload=payload,
        block=block, sender_sig=sender_sig, trace_ctx=trace_ctx,
    )
