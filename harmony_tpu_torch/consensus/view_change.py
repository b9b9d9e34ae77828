"""FBFT view change: leader-failure recovery.

Behavioral parity with the reference (reference:
consensus/view_change.go:125-553, view_change_construct.go,
consensus/config.go:52):

Three signed payload kinds per view change:

    M1: the PREPARED quorum proof for an in-flight block
        (payload = blockHash || aggSig || bitmap), carried so the new
        leader can re-propose the half-done block;
    M2: the literal NIL byte 0x01, voted by validators with no prepared
        block;
    M3: LE64(viewID), the actual view-change vote — M3 quorum drives the
        transition.

NEWVIEW carries (M3 agg sig + bitmap, optional M2 agg sig + bitmap,
optional M1 payload), with the consistency rule: if more validators
signed M3 than signed NIL, a prepared block must exist.

Next-leader selection is the cyclic Nth-next walk from the last known
leader (reference: view_change.go:125-209 getNextLeaderKey /
quorum.go:206-320 NthNextValidator).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from .. import bls as B
from ..multibls import PrivateKeys
from ..ref import bls as RB
from .mask import Mask, bits_from_bytes
from .quorum import Ballot, Decider, Phase

NIL = b"\x01"  # reference: consensus/config.go:52


def view_id_payload(view_id: int) -> bytes:
    return struct.pack("<Q", view_id)


def m1_payload(block_hash: bytes, prepared_proof: bytes) -> bytes:
    """blockHash || [aggSig || bitmap] (the PREPARED message payload)."""
    if len(block_hash) != 32:
        raise ValueError("block hash must be 32 bytes")
    return block_hash + prepared_proof


def next_leader_key(committee: list, last_leader: bytes, gap: int = 1) -> bytes:
    """Cyclic Nth-next from the last leader (NthNextValidator shape).

    Falls back to a gap-offset from index 0 when the last leader is not
    in the committee (the reference logs and proceeds similarly).
    """
    if not committee:
        raise ValueError("empty committee")
    try:
        idx = committee.index(last_leader)
    except ValueError:
        idx = -1
    return committee[(idx + gap) % len(committee)]


@dataclass
class ViewChangeMsg:
    view_id: int
    block_num: int
    sender_pubkeys: list
    m3_sig: bytes  # over LE64(viewID) — always present
    m2_sig: bytes = b""  # over NIL, when no prepared block
    m1_sig: bytes = b""  # over m1 payload, when prepared block known
    m1_payload: bytes = b""


@dataclass
class NewViewMsg:
    view_id: int
    block_num: int
    leader_pubkeys: list
    m3_agg_sig: bytes
    m3_bitmap: bytes
    m2_agg_sig: bytes = b""
    m2_bitmap: bytes = b""
    m1_payload: bytes = b""


def construct_viewchange(
    keys: PrivateKeys, view_id: int, block_num: int,
    prepared_block_hash: bytes | None = None,
    prepared_proof: bytes | None = None,
) -> ViewChangeMsg:
    """A validator's view-change vote (reference: view_change_msg.go)."""
    m3 = keys.sign_hash_aggregated(view_id_payload(view_id))
    if prepared_block_hash is not None and prepared_proof is not None:
        payload = m1_payload(prepared_block_hash, prepared_proof)
        m1 = keys.sign_hash_aggregated(payload)
        return ViewChangeMsg(
            view_id=view_id,
            block_num=block_num,
            sender_pubkeys=[k.pub.bytes for k in keys],
            m3_sig=m3.bytes,
            m1_sig=m1.bytes,
            m1_payload=payload,
        )
    m2 = keys.sign_hash_aggregated(NIL)
    return ViewChangeMsg(
        view_id=view_id,
        block_num=block_num,
        sender_pubkeys=[k.pub.bytes for k in keys],
        m3_sig=m3.bytes,
        m2_sig=m2.bytes,
    )


def verify_prepared_payload(
    payload: bytes, points: list, committee: list, decider: Decider
) -> bool:
    """The embedded PREPARED quorum proof must ITSELF verify (reference:
    view_change.go onViewChange verifies the aggregated prepared sig +
    quorum before accepting an M1 claim): aggregate prepare signature
    over the block hash, checked against its own bitmap, with quorum by
    that bitmap.  A single malicious validator fabricating a "prepared
    block" must not be able to poison the collector or re-lock honest
    validators on a block that never had prepare quorum."""
    if len(payload) < 32 + 96:
        return False
    block_hash = payload[:32]
    sig_bytes = payload[32:32 + 96]
    bitmap = payload[32 + 96:]
    from .. import device as DV

    mask = Mask(points)
    try:
        mask.set_mask(bitmap)
        sig = B.Signature.from_bytes(sig_bytes)
    except (ValueError, KeyError):
        return False
    if not decider.is_quorum_achieved_by_mask(
        bits_from_bytes(bitmap, len(committee))
    ):
        return False
    agg_pk = mask.aggregate_public(device=DV.device_enabled())
    if agg_pk is None:
        return False
    return B.verify_point(agg_pk, block_hash, sig.point)


class ViewChangeCollector:
    """Next-leader side: collect view-change votes until M3 quorum, then
    emit NEWVIEW (reference: view_change.go onViewChange +
    view_change_construct.go)."""

    def __init__(self, committee: list, decider: Decider, view_id: int):
        self.committee = list(committee)
        self.decider = decider
        self.view_id = view_id
        self.committee_points = [
            B.PublicKey.from_bytes(k).point for k in committee
        ]
        # the prepared-block claim, authenticated per-voter by their m1
        # signature on arrival; its quorum proof is the embedded PREPARED
        # aggregate itself (self-certifying), so no m1 sig store is kept
        self.m1_payload: bytes = b""
        self.m2_sigs: dict = {}
        self.m3_sigs: dict = {}

    def on_viewchange(self, msg: ViewChangeMsg) -> bool:
        """Validate fully, THEN mutate — a rejected message must leave no
        trace in the signature stores.  Non-committee keys and key-sets
        overlapping an earlier vote are dropped."""
        if msg.view_id != self.view_id or not msg.sender_pubkeys:
            return False
        committee = set(self.committee)
        if any(pk not in committee for pk in msg.sender_pubkeys):
            return False
        if any(
            self.decider.has_voted(Phase.VIEWCHANGE, pk)
            for pk in msg.sender_pubkeys
        ):
            return False  # duplicate / overlapping (errDupM3 analog)
        if not B.verify_aggregate_bytes(
            msg.sender_pubkeys, view_id_payload(self.view_id), msg.m3_sig
        ):
            return False
        if msg.m1_sig:
            if not B.verify_aggregate_bytes(
                msg.sender_pubkeys, msg.m1_payload, msg.m1_sig
            ):
                return False
            if self.m1_payload and self.m1_payload != msg.m1_payload:
                return False  # conflicting prepared blocks
            if not self.m1_payload and not verify_prepared_payload(
                msg.m1_payload, self.committee_points, self.committee,
                self.decider,
            ):
                return False  # fabricated PREPARED claim
        elif msg.m2_sig:
            if not B.verify_aggregate_bytes(
                msg.sender_pubkeys, NIL, msg.m2_sig
            ):
                return False
        else:
            return False
        # all checks passed: commit
        sender = tuple(msg.sender_pubkeys)
        if msg.m1_sig:
            self.m1_payload = self.m1_payload or msg.m1_payload
        else:
            self.m2_sigs[sender] = msg.m2_sig
        self.m3_sigs[sender] = msg.m3_sig
        for pk in msg.sender_pubkeys:
            self.decider.submit_vote(
                Phase.VIEWCHANGE,
                Ballot(pk, b"", msg.m3_sig, msg.block_num, msg.view_id),
            )
        return True

    def _agg_and_bitmap(self, sig_store: dict):
        sigs = [B.Signature.from_bytes(s) for s in sig_store.values()]
        agg = B.aggregate_sigs(sigs)
        mask = Mask(self.committee_points)
        voted = {pk for sender in sig_store for pk in sender}
        for i, key in enumerate(self.committee):
            if key in voted:
                mask.set_bit(i, True)
        return agg.bytes, mask.mask_bytes()

    def try_new_view(self, block_num: int, leader_keys) -> NewViewMsg | None:
        if not self.decider.is_quorum_achieved(Phase.VIEWCHANGE):
            return None
        m3_sig, m3_bitmap = self._agg_and_bitmap(self.m3_sigs)
        msg = NewViewMsg(
            view_id=self.view_id,
            block_num=block_num,
            leader_pubkeys=[k.pub.bytes for k in leader_keys],
            m3_agg_sig=m3_sig,
            m3_bitmap=m3_bitmap,
            m1_payload=self.m1_payload,
        )
        if self.m2_sigs:
            msg.m2_agg_sig, msg.m2_bitmap = self._agg_and_bitmap(self.m2_sigs)
        return msg


def verify_new_view(
    msg: NewViewMsg, committee: list, decider: Decider
) -> bool:
    """Validator-side NEWVIEW verification (reference:
    view_change_construct.go:154-210 VerifyNewViewMsg): M3 aggregate +
    quorum, optional M2 aggregate vs NIL, the M3>M2 consistency rule,
    and — when a prepared block is carried — the embedded PREPARED
    quorum proof itself (aggregate prepare signature over the block hash
    checked against its own bitmap and quorum)."""
    points = [B.PublicKey.from_bytes(k).point for k in committee]

    from .. import device as DV

    def check_agg(sig_bytes, bitmap, payload) -> tuple:
        mask = Mask(points)
        try:
            mask.set_mask(bitmap)
            sig = B.Signature.from_bytes(sig_bytes)
        except (ValueError, KeyError):
            return False, 0
        agg_pk = mask.aggregate_public(device=DV.device_enabled())
        if agg_pk is None:
            return False, 0
        return (
            B.verify_point(agg_pk, payload, sig.point),
            mask.count_enabled(),
        )

    ok3, m3_count = check_agg(
        msg.m3_agg_sig, msg.m3_bitmap, view_id_payload(msg.view_id)
    )
    if not ok3:
        return False
    if not decider.is_quorum_achieved_by_mask(
        bits_from_bytes(msg.m3_bitmap, len(committee))
    ):
        return False

    m2_count = 0
    if msg.m2_agg_sig:
        ok2, m2_count = check_agg(msg.m2_agg_sig, msg.m2_bitmap, NIL)
        if not ok2:
            return False
    # consistency: if more M3 voters than NIL voters, someone saw a
    # prepared block — its payload must be present
    if m3_count > m2_count and not msg.m1_payload:
        return False
    if msg.m1_payload and not verify_prepared_payload(
        msg.m1_payload, points, committee, decider
    ):
        return False
    return True


# -- wire codecs -------------------------------------------------------------

def _enc_b(b: bytes) -> bytes:
    return len(b).to_bytes(4, "little") + b


class _Cur:
    """Bounds-checked cursor: any read past end-of-buffer raises
    ValueError — truncated or length-forged wire input must fail fast,
    never silently yield empty fields or huge allocations."""

    def __init__(self, data: bytes):
        self.v = memoryview(data)
        self.o = 0

    def _take(self, n: int) -> memoryview:
        if self.o + n > len(self.v):
            raise ValueError("truncated view-change message")
        out = self.v[self.o:self.o + n]
        self.o += n
        return out

    def b(self) -> bytes:
        ln = int.from_bytes(self._take(4), "little")
        return bytes(self._take(ln))

    def i(self, w=8) -> int:
        return int.from_bytes(self._take(w), "little")

    def count(self, cap: int = 4096) -> int:
        n = self.i(4)
        if n > cap:
            raise ValueError(f"absurd element count {n}")
        return n


def encode_viewchange(msg: ViewChangeMsg) -> bytes:
    out = bytearray()
    out += msg.view_id.to_bytes(8, "little")
    out += msg.block_num.to_bytes(8, "little")
    out += len(msg.sender_pubkeys).to_bytes(4, "little")
    for pk in msg.sender_pubkeys:
        out += _enc_b(pk)
    for fieldval in (msg.m3_sig, msg.m2_sig, msg.m1_sig, msg.m1_payload):
        out += _enc_b(fieldval)
    return bytes(out)


def decode_viewchange(data: bytes) -> ViewChangeMsg:
    c = _Cur(data)
    view_id, block_num = c.i(), c.i()
    keys = [c.b() for _ in range(c.count())]
    m3, m2, m1, m1p = c.b(), c.b(), c.b(), c.b()
    return ViewChangeMsg(
        view_id=view_id, block_num=block_num, sender_pubkeys=keys,
        m3_sig=m3, m2_sig=m2, m1_sig=m1, m1_payload=m1p,
    )


def encode_newview(msg: NewViewMsg) -> bytes:
    out = bytearray()
    out += msg.view_id.to_bytes(8, "little")
    out += msg.block_num.to_bytes(8, "little")
    out += len(msg.leader_pubkeys).to_bytes(4, "little")
    for pk in msg.leader_pubkeys:
        out += _enc_b(pk)
    for fv in (msg.m3_agg_sig, msg.m3_bitmap, msg.m2_agg_sig,
               msg.m2_bitmap, msg.m1_payload):
        out += _enc_b(fv)
    return bytes(out)


def decode_newview(data: bytes) -> NewViewMsg:
    c = _Cur(data)
    view_id, block_num = c.i(), c.i()
    keys = [c.b() for _ in range(c.count())]
    m3s, m3b, m2s, m2b, m1p = c.b(), c.b(), c.b(), c.b(), c.b()
    return NewViewMsg(
        view_id=view_id, block_num=block_num, leader_pubkeys=keys,
        m3_agg_sig=m3s, m3_bitmap=m3b, m2_agg_sig=m2s, m2_bitmap=m2b,
        m1_payload=m1p,
    )
