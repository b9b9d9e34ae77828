"""ByzantineNode: a REAL in-process node that deliberately lies.

The chaos tier's benign faults (crashes, partitions, delays) never
exercised the protocol's actual threat model: *Byzantine* committee
members (reference: staking/slash/double-sign.go + consensus/
double_sign.go assume them; Handel, arXiv:1906.05132, takes them as
the baseline).  This policy layer wraps the production ``Node`` —
same chain, same FBFT state machines, same wire — and makes it
misbehave in the reference's named ways:

* ``equivocate``     — as leader, ANNOUNCE two conflicting blocks for
                       the same (height, view);
* ``double_vote``    — as validator, cast the honest commit vote AND a
                       second commit vote for a fabricated hash (the
                       slashable offense; signed with the configured
                       adversary keys so the offender is attributable);
* ``invalid_proposal`` — as leader, propose structurally-plausible but
                       invalid blocks (bad state root / tampered parent
                       seal / wrong view binding / garbage slash
                       payload, rotating);
* ``withhold``       — as validator, follow the chain but never vote
                       (the quorum-edge coalition member);
* ``wire_spray``     — flood the consensus + slash topics with
                       seed-deterministic malformed/oversized wires.

A Byzantine node also neuters its OWN safety store (a malicious
operator would), so nothing client-side stops the equivocation — only
the committee's defenses can.

The port's copy of the JAX package's ``chaostest/byzantine.py``.
"""

from __future__ import annotations

import random
import threading

from ..consensus.messages import FBFTMessage, MsgType, sign_message
from ..consensus.signature import construct_commit_payload
from ..core import rawdb
from ..log import get_logger
from ..multibls import PrivateKeys
from ..node.node import Node
from ..ref.keccak import keccak256

_log = get_logger("byzantine")


class _PermissiveSafety:
    """A malicious operator's 'safety store': records nothing, blocks
    nothing.  Replaces the durable SafetyStore AFTER construction so
    the honest-node wiring stays byte-identical."""

    def load_keys(self, *a, **k):
        pass

    def record(self, *a, **k):
        return True

    def min_view(self, *a, **k):
        return 0

    def restart_floor(self, *a, **k):
        return 0


class ByzantineNode(Node):
    def __init__(self, registry, keys: PrivateKeys, *,
                 behaviors=(), adversary_keys=None, seed: int = 0,
                 **kwargs):
        super().__init__(registry, keys, **kwargs)
        self.behaviors = set(behaviors)
        # the keys that actively double-sign: by default all of this
        # node's keys; scenarios narrow it to the staked external key
        # so the slash lands on an attributable validator
        self.adversary_keys = set(
            adversary_keys
            if adversary_keys is not None
            else [k.pub.bytes for k in keys]
        )
        self.seed = seed
        self.safety = _PermissiveSafety()
        self.byz_actions = {
            "equivocate": 0, "double_vote": 0, "invalid_proposal": 0,
            "withhold": 0, "wire_spray": 0,
        }
        self._spray_thread = None

    # -- leader-side behaviors ----------------------------------------------

    def _propose_and_announce(self):
        if "invalid_proposal" in self.behaviors and (
            self._reproposal is None
        ):
            return self._announce_invalid()
        # alternate the equivocation order: twin SECOND is absorbed by
        # honest first-announce-wins (the round still commits); twin
        # FIRST splits the committee from the leader's own collector
        # and wedges the round into a view change — both postures must
        # leave the honest committee live
        twin_first = (
            "equivocate" in self.behaviors
            and self.byz_actions["equivocate"] % 2 == 1
            and self.is_leader and not self._proposed
            and self._reproposal is None and len(self._round_keys)
        )
        if twin_first:
            self._announce_twin()
        block = super()._propose_and_announce()
        if (block is not None and not twin_first
                and "equivocate" in self.behaviors):
            self._announce_twin()
        return block

    def _announce_twin(self, block=None):

        """The equivocation: a CONFLICTING valid-looking proposal for
        the same (height, view) with different contents (fresh extra
        => fresh hash), signed and broadcast exactly like a real one."""
        try:
            twin = self.worker.propose_block(
                view_id=self.view_id,
                leader_extra=b"byz-equivocation-%d" % self.byz_actions[
                    "equivocate"
                ],
            )
        except ValueError:
            return
        bb = rawdb.encode_block(twin, self.chain.config.chain_id)
        msg = sign_message(FBFTMessage(
            msg_type=MsgType.ANNOUNCE,
            view_id=self.view_id,
            block_num=self.block_num,
            block_hash=twin.hash(),
            sender_pubkeys=[k.pub.bytes for k in self._round_keys],
            block=bb,
        ), self._round_keys)
        self._broadcast(msg)
        self.byz_actions["equivocate"] += 1
        _log.warn("byzantine equivocation announced",
                  block=self.block_num, view=self.view_id)

    def _announce_invalid(self):
        """Structurally-plausible garbage proposals, rotating through
        the reject classes honest validators must each catch: bad
        sealed state root, tampered carried parent seal, wrong view
        binding (a stale-committee-shaped mismatch), garbage slash
        payload."""
        if not self.is_leader or self._proposed or not self._round_keys:
            return None
        try:
            block = self.worker.propose_block(view_id=self.view_id)
        except ValueError:
            return None
        variant = self.byz_actions["invalid_proposal"] % 4
        h = block.header
        if variant == 0:
            h.root = keccak256(b"byz-bogus-root")
        elif variant == 1 and h.last_commit_sig:
            h.last_commit_sig = bytes(96)  # forged parent proof
        elif variant == 2:
            h.view_id = h.view_id + 7  # not this round's view
        else:
            h.slashes = b"\xff" * 64  # undecodable slash payload
        self._proposed = True
        bb = rawdb.encode_block(block, self.chain.config.chain_id)
        msg = sign_message(FBFTMessage(
            msg_type=MsgType.ANNOUNCE,
            view_id=self.view_id,
            block_num=self.block_num,
            block_hash=block.hash(),
            sender_pubkeys=[k.pub.bytes for k in self._round_keys],
            block=bb,
        ), self._round_keys)
        self._broadcast(msg)
        self.byz_actions["invalid_proposal"] += 1
        _log.warn("byzantine invalid proposal announced",
                  block=self.block_num, variant=variant)
        return None

    # -- validator-side behaviors -------------------------------------------

    def _on_announce(self, msg):
        if "withhold" in self.behaviors:
            # follow the chain (validate + track the block for commit)
            # but never vote: the observer path, taken deliberately
            saved = self._round_keys
            self._round_keys = PrivateKeys.from_keys([])
            try:
                super()._on_announce(msg)
            finally:
                self._round_keys = saved
            self.byz_actions["withhold"] += 1
            return
        super()._on_announce(msg)

    def _on_prepared(self, msg):
        if "withhold" in self.behaviors:
            saved = self._round_keys
            self._round_keys = PrivateKeys.from_keys([])
            try:
                super()._on_prepared(msg)
            finally:
                self._round_keys = saved
            return
        super()._on_prepared(msg)
        if "double_vote" not in self.behaviors:
            return
        keys = [k for k in self._round_keys
                if k.pub.bytes in self.adversary_keys]
        if not keys:
            return  # adversary key not seated this epoch
        pks = PrivateKeys.from_keys(keys)
        # the slashable offense: a SECOND commit ballot at the same
        # (height, view) for a fabricated hash, properly signed — the
        # exact evidence shape double-sign.go verifies
        fake_hash = keccak256(b"byz-double-vote" + msg.block_hash)
        payload = construct_commit_payload(
            fake_hash, msg.block_num, self.validator.cfg.commit_view_id,
            self.validator.cfg.is_staking,
        )
        sig = pks.sign_hash_aggregated(payload)
        vote = sign_message(FBFTMessage(
            msg_type=MsgType.COMMIT,
            view_id=msg.view_id,
            block_num=msg.block_num,
            block_hash=fake_hash,
            sender_pubkeys=[k.pub.bytes for k in keys],
            payload=sig.bytes,
        ), pks)
        self._broadcast(vote)
        self.byz_actions["double_vote"] += 1
        _log.warn("byzantine double vote cast", block=msg.block_num,
                  view=msg.view_id, keys=len(keys))

    # -- hostile wire -------------------------------------------------------

    def _spray_once(self, rng: random.Random):
        """One seed-deterministic malformed wire onto a consensus-path
        topic: truncated envelopes, inflated length prefixes, random
        garbage — every one must be REJECTed (scored) by honest
        validators, never crash them."""
        variant = rng.randrange(5)
        if variant == 0:  # bare garbage claiming to be consensus
            junk = bytes([0x00, rng.randrange(7)]) + rng.randbytes(
                rng.randrange(1, 96)
            )
        elif variant == 1:  # inflated key count in a real-shaped frame
            body = bytearray(bytes([rng.randrange(7)]))
            body += rng.randbytes(16)  # view + block num
            body += rng.randbytes(32)  # hash
            body += (2 ** 31).to_bytes(4, "little")  # absurd key count
            body += rng.randbytes(8)
            junk = bytes([0x00, 0x01]) + bytes(body)
        elif variant == 2:  # truncated mid-field
            junk = bytes([0x00, 0x03]) + rng.randbytes(
                rng.randrange(2, 40)
            )
        elif variant == 3:  # slash-topic garbage record
            junk = bytes([0x01, 0x10]) + rng.randbytes(
                rng.randrange(1, 64)
            )
        else:  # inflated slash vote key count
            import struct as _s

            junk = bytes([0x01, 0x10]) + _s.pack(
                "<QIQQ", 0, 0, 1, 1
            ) + _s.pack("<H", 0xFFFF) + rng.randbytes(8)
        topic = self._slash_topic if junk[0] == 0x01 else self.topic
        try:
            self.host.publish(topic, junk)
            self.byz_actions["wire_spray"] += 1
        except (ValueError, OSError):
            pass  # oversized/refused: the transport's cap did its job

    def _spray_loop(self):
        rng = random.Random(self.seed ^ 0xB12A17)
        while not self._stop.is_set():
            self._spray_once(rng)
            self._stop.wait(0.03)

    def run_forever(self, *args, **kwargs):
        if "wire_spray" in self.behaviors and self._spray_thread is None:
            self._spray_thread = threading.Thread(
                # graftlint: thread-role=transient — scenario-scoped
                target=self._spray_loop, daemon=True,
            )
            self._spray_thread.start()
        return super().run_forever(*args, **kwargs)
