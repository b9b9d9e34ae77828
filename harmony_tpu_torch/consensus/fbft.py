"""In-process FBFT round: leader + validator state machines over the
device crypto path.

This is the framework's executable model of the reference's hot loop
(reference call stack SURVEY.md §3.2): announce -> prepare votes ->
prepared (agg sig + bitmap) -> commit votes -> committed.  It drives the
same crypto sequence the Go node drives through cgo, but with the
verify/aggregate steps batched on the card:

- leader.on_prepare / on_commit: per-vote signature verification
  (reference: consensus/leader.go:156-197) — batchable across validators;
- quorum transition: aggregate votes + build [sig || bitmap] proof
  (reference: consensus/threshold.go:14-69);
- validator.on_prepared / on_committed: bitmap quorum check + ONE
  aggregate-signature pairing verify (reference:
  consensus/validator.go:217-236, 336-353).

Transport is pluggable (in-process lists here; libp2p in deployment).
The port's copy of the JAX package's ``consensus/fbft.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import bls as B
from ..multibls import PrivateKeys
from ..ref import bls as RB
from .mask import Mask
from .messages import (
    FBFTLog,
    FBFTMessage,
    MsgType,
    decode_sig_and_bitmap,
    encode_sig_and_bitmap,
    sign_message,
)
from .quorum import Ballot, Decider, Phase
from .signature import construct_commit_payload, prepare_payload


@dataclass
class RoundConfig:
    committee: list  # ordered serialized pubkeys (the epoch committee)
    block_num: int
    view_id: int  # message routing view
    is_staking: bool = True
    # the view id bound into commit payloads: the BLOCK HEADER's view.
    # Equal to view_id in normal rounds; after a view change re-proposes
    # a prepared block, it stays the ORIGINAL proposal view so commit
    # votes cast across views bind the same payload (PBFT safety: the
    # re-proposed block must be THE SAME block, hash included) and the
    # engine's replay check (which derives the payload from the header,
    # engine.py _commit_payload) agrees with live consensus.
    payload_view_id: int | None = None

    @property
    def commit_view_id(self) -> int:
        return (
            self.view_id if self.payload_view_id is None
            else self.payload_view_id
        )


class _Node:
    def __init__(self, keys: PrivateKeys, cfg: RoundConfig, decider: Decider):
        self.keys = keys
        self.cfg = cfg
        self.decider = decider
        self.log = FBFTLog()
        # decompressed once per process (every round and every node of
        # a process shares the committee's keys), not once per round
        self.committee_points = [
            B.pubkey_from_bytes_cached(k).point for k in cfg.committee
        ]

    def _commit_payload(self, block_hash: bytes) -> bytes:
        return construct_commit_payload(
            block_hash, self.cfg.block_num, self.cfg.commit_view_id,
            self.cfg.is_staking,
        )


class Leader(_Node):
    """Collects votes, verifies each, aggregates at quorum (reference:
    consensus/leader.go + threshold.go)."""

    def __init__(self, keys, cfg, decider):
        super().__init__(keys, cfg, decider)
        self.prepare_sigs: dict = {}
        self.commit_sigs: dict = {}
        self.current_block_hash: bytes | None = None

    def announce(self, block_hash: bytes, block_bytes: bytes) -> FBFTMessage:
        msg = sign_message(FBFTMessage(
            msg_type=MsgType.ANNOUNCE,
            view_id=self.cfg.view_id,
            block_num=self.cfg.block_num,
            block_hash=block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            block=block_bytes,
        ), self.keys)
        self.log.add_message(msg)
        self.log.add_block(block_hash, block_bytes)
        self.current_block_hash = block_hash
        # the leader's own prepare vote counts toward quorum at announce
        # time (the reference's leader signs the block hash with all its
        # keys alongside the announce — leader.go:20 + construct.go:124).
        # Cast directly — no pairing check on a signature produced one
        # line earlier; a stale committee is a hard wiring error.
        own = [k.pub.bytes for k in self.keys]
        committee = set(self.cfg.committee)
        missing = [pk for pk in own if pk not in committee]
        if missing:
            raise ValueError(
                f"leader key(s) not in committee: {len(missing)} of "
                f"{len(own)}"
            )
        sig = self.keys.sign_hash_aggregated(prepare_payload(block_hash))
        for pk in own:
            self.decider.submit_vote(
                Phase.PREPARE,
                Ballot(pk, block_hash, sig.bytes,
                       self.cfg.block_num, self.cfg.view_id),
            )
        self.prepare_sigs[tuple(own)] = sig
        return msg

    def _on_vote(self, msg, phase, payload, store):
        """Shared hot loop: verify the vote sig (possibly multi-key
        aggregated by the sender) against the sum of its sender keys
        (reference: consensus/leader.go:156-197).  Votes for a different
        block hash, from non-committee keys, overlapping an already-voted
        key, or malformed are dropped — never raised — matching the
        reference's tolerant message loop."""
        if (
            self.current_block_hash is None
            or msg.block_hash != self.current_block_hash
            or not msg.sender_pubkeys
        ):
            return False
        committee = set(self.cfg.committee)
        if any(pk not in committee for pk in msg.sender_pubkeys):
            return False
        # per-KEY dedup: a key-set overlapping any prior vote would put a
        # key's signature into the aggregate twice while the bitmap marks
        # it once, breaking the quorum proof
        if any(
            self.decider.has_voted(phase, pk) for pk in msg.sender_pubkeys
        ):
            return False
        if not B.verify_aggregate_bytes(
            msg.sender_pubkeys, payload, msg.payload
        ):
            return False
        for pk_bytes in msg.sender_pubkeys:
            self.decider.submit_vote(
                phase,
                Ballot(pk_bytes, msg.block_hash, msg.payload,
                       msg.block_num, msg.view_id),
            )
        store[tuple(msg.sender_pubkeys)] = B.Signature.from_bytes(msg.payload)
        return True

    def on_prepare(self, msg: FBFTMessage) -> bool:
        return self._on_vote(
            msg, Phase.PREPARE, prepare_payload(msg.block_hash),
            self.prepare_sigs,
        )

    def on_commit(self, msg: FBFTMessage) -> bool:
        return self._on_vote(
            msg, Phase.COMMIT, self._commit_payload(msg.block_hash),
            self.commit_sigs,
        )

    def _quorum_proof(self, phase, store) -> bytes:
        """Aggregate stored vote sigs + bitmap (reference:
        consensus/quorum/quorum.go:164-196 AggregateVotes)."""
        agg = B.aggregate_sigs(list(store.values()))
        mask = Mask(self.committee_points)
        voted = {b.signer_key for b in self.decider.ballots(phase)}
        for i, key in enumerate(self.cfg.committee):
            if key in voted:
                mask.set_bit(i, True)
        return encode_sig_and_bitmap(agg.bytes, mask.mask_bytes())

    def try_prepared(self, block_hash: bytes):
        """At prepare quorum: broadcast PREPARED with the proof
        (reference: consensus/threshold.go:14-52).  Only the round's
        announced block may be proven — a caller passing any other hash
        (e.g. lifted from a rejected vote) gets None."""
        if block_hash != self.current_block_hash:
            return None
        if not self.decider.is_quorum_achieved(Phase.PREPARE):
            return None
        return sign_message(FBFTMessage(
            msg_type=MsgType.PREPARED,
            view_id=self.cfg.view_id,
            block_num=self.cfg.block_num,
            block_hash=block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            payload=self._quorum_proof(Phase.PREPARE, self.prepare_sigs),
            block=self.log.get_block(block_hash) or b"",
        ), self.keys)

    def try_committed(self, block_hash: bytes):
        if block_hash != self.current_block_hash:
            return None
        if not self.decider.is_quorum_achieved(Phase.COMMIT):
            return None
        return sign_message(FBFTMessage(
            msg_type=MsgType.COMMITTED,
            view_id=self.cfg.view_id,
            block_num=self.cfg.block_num,
            block_hash=block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            payload=self._quorum_proof(Phase.COMMIT, self.commit_sigs),
        ), self.keys)

    def prepared_from_proof(self, block_hash: bytes, proof: bytes):
        """PREPARED built from an externally-assembled quorum proof —
        the aggregation overlay's path (consensus.aggregation): every
        piece of the aggregate was pairing-verified before merging and
        the caller checked quorum-by-mask, so the ballot store is
        bypassed.  Same message shape ``try_prepared`` emits, same
        announced-hash guard."""
        if block_hash != self.current_block_hash:
            return None
        return sign_message(FBFTMessage(
            msg_type=MsgType.PREPARED,
            view_id=self.cfg.view_id,
            block_num=self.cfg.block_num,
            block_hash=block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            payload=proof,
            block=self.log.get_block(block_hash) or b"",
        ), self.keys)

    def committed_from_proof(self, block_hash: bytes, proof: bytes):
        """COMMITTED from an overlay-assembled proof (see
        :meth:`prepared_from_proof`)."""
        if block_hash != self.current_block_hash:
            return None
        return sign_message(FBFTMessage(
            msg_type=MsgType.COMMITTED,
            view_id=self.cfg.view_id,
            block_num=self.cfg.block_num,
            block_hash=block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            payload=proof,
        ), self.keys)


class Validator(_Node):
    """Signs votes; verifies aggregate proofs (reference:
    consensus/validator.go)."""

    def on_announce(self, msg: FBFTMessage) -> FBFTMessage:
        """Sign the block hash with every local key, locally aggregated
        (reference: consensus/validator.go:144-165 + construct.go:99-105)."""
        self.log.add_message(msg)
        sig = self.keys.sign_hash_aggregated(prepare_payload(msg.block_hash))
        return sign_message(FBFTMessage(
            msg_type=MsgType.PREPARE,
            view_id=msg.view_id,
            block_num=msg.block_num,
            block_hash=msg.block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            payload=sig.bytes,
        ), self.keys)

    def _verify_proof(self, msg: FBFTMessage, payload: bytes) -> bool:
        """Decode [sig || bitmap], check quorum-by-mask, verify the
        aggregate signature — the reference's validator-side check
        (validator.go:217-236; engine.go:619-642 uses the same shape).
        Malformed payloads return False, never raise.

        Device path: the committee lives as one device-resident table
        and the masked aggregation + pairing check run FUSED as a
        single program (ops/bls.agg_verify) — submitted through the
        verification scheduler's CONSENSUS lane, so a proof check
        rides the shared device queue ahead of sync/ingress traffic
        (and coalesces with any concurrent same-committee checks)."""
        from .. import device as DV

        try:
            mask = Mask(self.committee_points)
            sig_bytes, bitmap = decode_sig_and_bitmap(
                msg.payload, mask.bytes_len()
            )
            mask.set_mask(bitmap)
            if not self.decider.is_quorum_achieved_by_mask(mask.bit_vector()):
                return False
            sig = B.Signature.from_bytes(sig_bytes)
        except ValueError:
            return False
        if DV.device_enabled():
            from .. import sched

            table = DV.get_committee_table(
                self.cfg.committee, self.committee_points
            )
            return sched.agg_verify(
                table, mask.bit_vector(), payload, sig.point,
                lane=sched.Lane.CONSENSUS,
            )
        agg_pk = mask.aggregate_public(device=False)
        if agg_pk is None:
            return False
        return RB.verify(agg_pk, payload, sig.point)

    def on_prepared(self, msg: FBFTMessage):
        """Verify the prepare proof; if valid, send the commit vote
        signed over the commit payload (validator.go:196-260)."""
        if not self._verify_proof(msg, prepare_payload(msg.block_hash)):
            return None
        sig = self.keys.sign_hash_aggregated(
            self._commit_payload(msg.block_hash)
        )
        return sign_message(FBFTMessage(
            msg_type=MsgType.COMMIT,
            view_id=msg.view_id,
            block_num=msg.block_num,
            block_hash=msg.block_hash,
            sender_pubkeys=[k.pub.bytes for k in self.keys],
            payload=sig.bytes,
        ), self.keys)

    def on_committed(self, msg: FBFTMessage) -> bool:
        """Final check before accepting the block (validator.go:299-377)."""
        return self._verify_proof(msg, self._commit_payload(msg.block_hash))
