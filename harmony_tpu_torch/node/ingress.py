"""Gossip ingress: message envelope + cheap pre-verification filtering.

Behavioral parity with the reference:

- the network envelope is [category byte][type byte][payload]
  (reference: api/proto/common.go — category 0x00 consensus, 0x01 node);
- before ANY signature work, consensus messages pass cheap checks:
  shard id match, viewID freshness window (msg.viewID + 5 >= current),
  role filtering (leader drops leader-bound-only types it sent, etc.),
  sender key in committee, bitmap length sanity (reference:
  node/harmony/node.go:473-608 validateShardBoundMessage).  The point is
  DoS economy: pairing work only happens for messages that could matter.

The one signature check that IS ingress work — the sender-sig gate on
messages that survived the cheap filter — runs through the
verification scheduler's INGRESS lane (``verify_sender``): per-message
admission crypto coalesces into fused device batches and queues
*behind* the round's quorum proofs, so a gossip flood cannot starve
consensus of device time.

The port's copy of the JAX package's ``node/ingress.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..consensus.messages import FBFTMessage, MsgType, verify_sender_sig

VIEW_ID_WINDOW = 5  # reference: node.go:545-555 (viewID + 5 < current -> drop)


class MessageCategory(IntEnum):
    CONSENSUS = 0x00
    NODE = 0x01


# NODE-category message types (reference: api/proto/node — the node
# service's own wire types ride the same envelope)
NODE_MSG_SLASH = 0x10  # body: one encoded slash.Record
NODE_MSG_AGG = 0x11    # body: one encoded aggregation contribution
#                        (consensus.messages.decode_aggregation) —
#                        rides the NODE category so the CONSENSUS
#                        role-filter/bitmap-sanity path never applies


def pack_envelope(category: MessageCategory, msg_type: int, payload: bytes) -> bytes:
    return bytes([category, msg_type]) + payload


def parse_envelope(data: bytes):
    if len(data) < 2:
        raise ValueError("message shorter than envelope")
    return MessageCategory(data[0]), data[1], data[2:]


@dataclass
class IngressContext:
    """Snapshot of consensus state the filter needs."""

    shard_id: int
    current_view_id: int
    committee_keys: set
    is_leader: bool = False
    in_view_change: bool = False
    committee_size: int = 0

    def __post_init__(self):
        if not self.committee_size:
            self.committee_size = len(self.committee_keys)


@dataclass
class IngressResult:
    accepted: bool
    reason: str = ""


_LEADER_BOUND = {MsgType.PREPARE, MsgType.COMMIT}
_VALIDATOR_BOUND = {MsgType.ANNOUNCE, MsgType.PREPARED, MsgType.COMMITTED}
_VIEWCHANGE_TYPES = {MsgType.VIEWCHANGE, MsgType.NEWVIEW}


def validate_consensus_message(
    msg: FBFTMessage, ctx: IngressContext, shard_id: int
) -> IngressResult:
    """The cheap pre-checks; returns (accepted, reason).  No crypto."""
    if shard_id != ctx.shard_id:
        return IngressResult(False, "wrong shard")
    if msg.msg_type in _VIEWCHANGE_TYPES:
        # acceptable while in view change, or for a FUTURE view even
        # before this node's own timeout fires (peers' clocks lead ours;
        # the reference accepts view-change traffic for viewID > current)
        if not ctx.in_view_change and msg.view_id <= ctx.current_view_id:
            return IngressResult(False, "view change for a stale view")
    else:
        if msg.view_id + VIEW_ID_WINDOW < ctx.current_view_id:
            return IngressResult(False, "view id too old")
    # role filtering (node.go:577-608): leader consumes votes, validators
    # consume proposals/proofs
    if msg.msg_type in _LEADER_BOUND and not ctx.is_leader:
        return IngressResult(False, "leader-bound message at validator")
    if msg.msg_type in _VALIDATOR_BOUND and ctx.is_leader:
        return IngressResult(False, "validator-bound message at leader")
    if not msg.sender_pubkeys:
        return IngressResult(False, "no sender key")
    for key in msg.sender_pubkeys:
        if len(key) != 48:
            return IngressResult(False, "bad sender key size")
        if key not in ctx.committee_keys:
            return IngressResult(False, "sender not in committee")
    # bitmap length sanity for aggregate proofs
    if msg.msg_type in (MsgType.PREPARED, MsgType.COMMITTED):
        expected = (ctx.committee_size + 7) >> 3
        if len(msg.payload) != 96 + expected:
            return IngressResult(False, "bad aggregate payload length")
    return IngressResult(True)


def verify_sender(msg: FBFTMessage) -> bool:
    """The ingress-lane sender-signature gate: the one pairing check a
    message pays to enter the consensus pump, submitted on the
    scheduler's INGRESS lane so bursts of gossip coalesce into fused
    single-verify batches instead of each paying a dispatch alone.  A
    check bound for the card that cannot run raises
    ``device.DeviceError``; it is never answered False."""
    from .. import sched

    return verify_sender_sig(msg, lane=sched.Lane.INGRESS)
