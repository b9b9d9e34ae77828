"""The Node: chain + mempool + FBFT consensus + gossip, wired.

The role of the reference's node/harmony (reference:
node/harmony/node.go:89-138 Node struct; :613-944 StartPubSub per-topic
validators; :473-608 validateShardBoundMessage cheap pre-checks;
consensus wiring in cmd/harmony/main.go:707 — SURVEY.md §2.6 + §3.2).

Design: the Node is an event-pump state machine.  Gossip handlers only
ENQUEUE (after the cheap ingress filter); ``process_pending`` drains
the queue through the FBFT handlers — so transports may deliver on any
thread, reentrancy is impossible, and tests drive rounds
deterministically by pumping.  ``run_forever`` wraps the pump in a
thread for live deployments.

Leader rotation: round-robin by view id over the committee (the
reference's uniform NthNextValidator policy, quorum.go:206-320; its
stake-weighted rotation variants ride the same hook).

The port's copy of the JAX package's ``node/node.py``.
"""

from __future__ import annotations

import queue
import threading
import time

from .. import health, trace
from ..consensus import aggregation as AGG
from ..consensus.fbft import Leader, RoundConfig, Validator
from ..consensus.messages import (
    AggContribution,
    FBFTMessage,
    MsgType,
    decode_aggregation,
    decode_message,
    encode_aggregation,
    encode_message,
    sign_message,
)
from ..consensus.quorum import Decider, Policy
from ..consensus.safety import (
    PHASE_COMMIT,
    PHASE_PREPARE,
    PHASE_VIEWCHANGE,
    SafetyStore,
)
from ..consensus.sender import MessageSender
from ..consensus.signature import prepare_payload
from ..consensus.view_change import (
    ViewChangeCollector,
    construct_viewchange,
    decode_newview,
    decode_viewchange,
    encode_newview,
    encode_viewchange,
    verify_new_view,
)
from ..core import rawdb
from ..core.blockchain import ChainError
from ..log import get_logger
from ..multibls import PrivateKeys
from ..p2p import aggregation_topic, consensus_topic, slash_topic
from ..p2p.host import ACCEPT, IGNORE, REJECT
from ..staking import slash as SL
from .ingress import (
    NODE_MSG_AGG,
    NODE_MSG_SLASH,
    VIEW_ID_WINDOW,
    IngressContext,
    MessageCategory,
    pack_envelope,
    parse_envelope,
    validate_consensus_message,
    verify_sender,
)
from .worker import Worker


class Node:
    def __init__(self, registry, keys: PrivateKeys, network: str = "localnet",
                 policy: Policy = Policy.UNIFORM, roster=None):
        self.registry = registry
        self.chain = registry.blockchain
        self.pool = registry.txpool
        self.keys = keys
        self._round_keys = keys  # per-round committee subset (_new_round)
        self.network = network
        self.policy = policy
        self.roster = roster
        self.worker = Worker(self.chain, self.pool)
        self.host = registry.host
        # node identity stamped onto every span this node creates —
        # the in-process localnet shares ONE trace store, so without
        # this the merged trace cannot tell leader from validators
        self._node_tag = (getattr(self.host, "name", "")
                          or f"shard{self.chain.shard_id}")
        self.topic = consensus_topic(network, self.chain.shard_id)
        self.sender = MessageSender(self.host, [self.topic])
        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.committed_blocks = 0
        self.dropped_messages = 0
        self.view_changes = 0  # view-change votes this node started
        self.new_views_adopted = 0  # NEWVIEW adoptions (chaos metrics)
        self.webhooks = registry.get("webhooks")
        self.pending_double_signs: list = []  # forensic evidence dicts
        self.double_sign_events = 0  # conflicts detected (any phase)
        self.double_signs_dropped = 0  # evidence lost to the queue cap
        self._ds_drop_logged = False  # log the cap overflow ONCE
        # block-includable slash.Record queue (commit-phase evidence
        # only — the phase the reference slashes on), fed by local
        # detection AND the slash gossip topic; drained into proposals
        self.pending_slash_records: list = []
        self._slash_seen: set = set()  # evidence fingerprints (bounded)
        # (block_num, view, hash, commit_view, commit store, payload
        # fn) of the last round this node led to commit quorum — the
        # late-ballot detection window (_check_double_sign via _handle)
        self._prev_commit_ctx = None
        # durable last-signed-view state: written through the chain DB
        # BEFORE any vote leaves this node, reloaded here on restart —
        # a hard-killed validator can neither double-sign its last
        # round nor re-enter a view it already signed past
        self.safety = SafetyStore(self.chain.db)
        self.safety.load_keys([k.pub.bytes for k in keys])
        self._vc = 0  # view changes since last commit
        self.in_view_change = False
        self.phase_timeout = 27.0  # reference: consensus/config.go:10
        self._vc_collector = None
        self._prepared_proof: bytes | None = None  # [sig||bitmap] seen
        self._prepared_block_bytes: bytes = b""
        # consensus-triggered sync (reference: consensus/downloader.go
        # spinUpStateSync): a run of future-round messages means the
        # network moved on without us — pull blocks instead of dropping
        # gossip forever
        self._ahead_runs = 0
        self.ahead_threshold = 4
        self._syncing = False
        self._sync_done = threading.Event()
        self._sync_thread = None  # live downloader thread (join on stop)
        self.sync_spinups = 0
        # preCommitAndPropose analog (consensus_v2.go:559-635): the
        # leader proposes the NEXT block immediately after broadcasting
        # COMMITTED instead of waiting for the pacing tick.  Off until
        # run_forever arms it: deterministic test harnesses drive
        # rounds explicitly and must not get surprise proposals.
        self.pipelining = False
        self.block_time = 2.0
        self._last_propose = 0.0
        # periodic pool maintenance from the live pump (without it
        # queued txs would live forever on a running node)
        self.maintenance_interval_s = 30.0
        self._last_maintenance = time.monotonic()

        self.log = get_logger("consensus", shard=self.chain.shard_id)
        # per-round latency lands in the metrics registry when one is
        # wired (cli.py does) — the BENCH-facing aggregate of the same
        # timeline the round trace spans break down
        mreg = registry.get("metrics")
        self._round_seconds = (
            mreg.histogram(
                "harmony_consensus_round_seconds",
                "announce-to-commit wall time of one FBFT round",
            ) if mreg is not None else None
        )
        self._ds_dropped_metric = (
            mreg.counter(
                "harmony_consensus_double_sign_dropped_total",
                "double-sign evidence records lost to the bounded "
                "pending queue (cap overflow after duplicate eviction)",
            ) if mreg is not None else None
        )
        self.host.add_validator(self.topic, self._gossip_validator)
        self.host.subscribe(self.topic, self._on_gossip)
        # double-sign evidence gossip: detection usually happens at the
        # round leader, but the NEXT leader is who proposes — records
        # flood this topic (cheap bounded-decode validator; the pairing
        # verification runs on the pump) so any node can include them
        self._slash_topic = slash_topic(network, self.chain.shard_id)
        self.host.add_validator(self._slash_topic, self._slash_validator)
        self.host.subscribe(self._slash_topic, self._on_gossip)
        # live cross-shard receipt routing (reference:
        # node_cross_shard.go BroadcastCXReceipts / ProcessReceiptMessage):
        # in a multi-shard topology each committed block's outgoing
        # receipts are exported as sealed proofs to the destination
        # shards' cx topics; incoming proofs are verified into the
        # CXPool and drained into this node's next proposal
        self.shard_count = int(registry.get("shard_count") or 1)
        self.cx_pool = None
        if self.shard_count > 1:
            from ..core import rawdb as _rawdb
            from .cross_shard import CXPool, cx_topic

            self.cx_pool = CXPool(
                self.chain.shard_id,
                engine=self.chain.engine,
                config=self.chain.config,
                spent=lambda fs, n: _rawdb.is_cx_spent(
                    self.chain.db, fs, n
                ),
            )
            self._cx_topic = cx_topic(network, self.chain.shard_id)
            self.host.subscribe(
                self._cx_topic,
                lambda _t, payload, _f: self.cx_pool.add_batch(payload),
            )
        # Handel-style vote aggregation overlay (consensus.aggregation).
        # "direct" (default) keeps today's exact point-to-point voting —
        # bit-for-bit identical wire traffic; "handel" routes prepare/
        # commit votes up the multi-level overlay and falls back to the
        # direct vote whenever the overlay stalls.
        self.aggregation_mode = str(registry.get("aggregation") or "direct")
        self.aggregator = None
        self._agg_subscribed: set = set()  # owned slot topics (no unsub)
        self._agg_strikes: dict = {}       # frm -> forged-partial count
        self._agg_hash: dict = {}          # phase -> seeded block hash
        self._agg_trace_ctx: dict = {}     # phase -> traceparent bytes
        self._agg_slot_of: dict = {}       # committee key -> slot index
        self._agg_totals = {               # folded on round turnover
            "inbound": 0, "merged": 0, "dup": 0, "stale": 0,
            "forged": 0, "emissions": 0, "fallbacks": 0,
        }
        self._new_round()
        # restart fast-forward, applied ONCE: rejoin the round at the
        # highest view this node's keys voted OR view-changed at
        # (durable SafetyStore records) instead of re-entering the
        # storm from view 1.  A LIVE node's floor (in _new_round) uses
        # votes only — the watermark belongs to the restart path.
        floor = self.safety.restart_floor(self.block_num)
        if floor > self.view_id:
            self._vc += floor - self.view_id
            self._new_round()

    # -- committee / role ---------------------------------------------------

    def committee(self) -> list:
        """Serialized pubkeys for the round's epoch: the elected shard
        state when one exists, else genesis (shard/committee election
        persisted at the committee-selection block)."""
        return self.chain.committee_for_epoch(
            self.chain.epoch_of(self.chain.head_number + 1)
        )

    def leader_key(self, view_id: int) -> bytes:
        """The view's designated leader key (reference:
        consensus/quorum/quorum.go:206-320 NthNext family).

        Pre-leader-rotation epochs rotate uniformly over committee
        slots (NthNext).  Once the LeaderRotation gate is active, the
        rotation is OPERATOR-distinct (NthNextValidator semantics): a
        validator running many slots still gets exactly one leadership
        turn per cycle — otherwise stake-heavy multi-key operators
        would hold the proposer role proportionally longer."""
        committee = self.committee()
        epoch = self.chain.epoch_of(self.chain.head_number + 1)
        if self.chain.config.is_leader_rotation(epoch):
            state = self.chain.shard_state_for_epoch(epoch)
            com = state.find_committee(self.chain.shard_id) if state else None
            if com is not None and com.slots:
                seen: set = set()
                operators: list = []  # first slot key per operator
                for s in com.slots:
                    if s.ecdsa_address not in seen:
                        seen.add(s.ecdsa_address)
                        operators.append(s.bls_pubkey)
                return operators[view_id % len(operators)]
        return committee[view_id % len(committee)]

    @property
    def is_leader(self) -> bool:
        return any(
            k.pub.bytes == self._round_leader_key for k in self._round_keys
        )

    # -- round lifecycle ----------------------------------------------------

    def _new_round(self):
        # one-round forensic memory (the role of the reference's FBFT
        # log spanning rounds): a conflicting COMMIT ballot often
        # arrives RIGHT BEHIND the honest tipping vote, i.e. after the
        # leader already committed and reset — without this stash the
        # equivocator wins the race against its own evidence
        prev_leader = getattr(self, "leader", None)
        if (prev_leader is not None
                and prev_leader.current_block_hash is not None
                and prev_leader.commit_sigs):
            self._prev_commit_ctx = (
                self.block_num, self.view_id,
                prev_leader.current_block_hash,
                prev_leader.cfg.commit_view_id,
                dict(prev_leader.commit_sigs),
                prev_leader._commit_payload,
            )
        # close any trace spans left from the previous round (a round
        # that COMMITTED already finished them; this is the abandoned
        # path — view change or sync rejoin)
        rs = getattr(self, "_round_span", None)
        if rs is not None:
            rs.annotate(abandoned=True)
            trace.finish(rs)
        trace.finish(getattr(self, "_phase_span", None))
        self._round_span = None
        self._phase_span = None
        head = self.chain.current_header()
        self.block_num = head.block_num + 1
        # every node derives the same view id from the committed head
        # plus its local view-change count (reset on commit)
        self.view_id = head.view_id + 1 + self._vc
        # STRICT view monotonicity per height: never re-enter a view
        # this node already voted (or announced) in.  FBFT's view
        # derivation legitimately cycles back — _vc resets on sync
        # rejoin — but the SafetyStore keeps only the LAST vote per
        # key, so on a re-entered view a leader would re-propose
        # fresh (new timestamp = new hash) while slower peers still
        # hold that view's old record and rightly withhold: with
        # records scattered across visits, NO re-entered view can
        # assemble quorum again (the rolling-restart scenario wedged
        # at one height for 280 s on exactly that).  Votes only — the
        # VC watermark races ahead of adoptable views in a storm.
        voted = self.safety.min_view(self.block_num)
        if voted and voted + 1 > self.view_id:
            self._vc += voted + 1 - self.view_id
            self.view_id = voted + 1
        committee = self.committee()
        # only keys holding a slot in THIS round's committee may sign:
        # a multi-key operator whose extra key is not (or no longer)
        # elected would otherwise aggregate a non-committee signature
        # into every vote and have ALL its votes rejected — exactly
        # what the epoch-rotation and churn chaos scenarios hit.  A
        # node with no elected key this epoch runs as an observer:
        # it validates and commits but never votes.  When this node
        # holds the round's LEADER slot, that key goes FIRST: every
        # receiver binds messages to sender_pubkeys[0], so a multi-key
        # leader whose rotation landed on its second key must lead
        # with it (the chaos sweep's election scenario wedged on
        # exactly this — validators dropped every post-election
        # announce as "not this view's leader").
        self._round_leader_key = self.leader_key(self.view_id)
        cset = set(committee)
        eligible = [k for k in self.keys if k.pub.bytes in cset]
        self._round_keys = PrivateKeys.from_keys(
            [k for k in eligible
             if k.pub.bytes == self._round_leader_key]
            + [k for k in eligible
               if k.pub.bytes != self._round_leader_key]
        )
        cfg = RoundConfig(
            committee=committee,
            block_num=self.block_num,
            view_id=self.view_id,
            is_staking=self.chain.config.is_staking(
                self.chain.epoch_of(self.block_num)
            ),
        )
        decider = Decider(self.policy, committee, self.roster)
        self.leader = Leader(self._round_keys, cfg, decider)
        self.validator = Validator(self._round_keys, cfg, decider)
        self._proposed = False
        self._sent_prepared = False
        self._sent_committed = False
        self._pending_block = None  # validator's decoded announce block
        self._round_start = time.monotonic()
        self.in_view_change = False
        self._vc_collector = None
        self._vc_pending: list = []  # VC votes that arrived early
        self._vc_block_bytes = b""
        self._prepared_proof = None
        self._prepared_block_bytes = b""
        self._reproposal = None  # block carried through a view change
        self._expected_reproposal_hash = None
        # one announce-vote per (block_num, view_id): a validator must
        # never prepare two different blocks in the same round — the
        # second valid-looking announce (equivocating leader or forged
        # sender) is ignored, closing the two-block commit-quorum fork
        self._announce_voted: tuple | None = None
        self._setup_aggregation(committee)

    # -- gossip ingress -----------------------------------------------------

    def _gossip_validator(self, payload: bytes, frm: str) -> int:
        """Cheap pre-checks before any pairing work (reference:
        node.go:473-608) — run inside the gossip validate step so bad
        messages are not re-flooded."""
        try:
            category, msg_type, body = parse_envelope(payload)
            if category != MessageCategory.CONSENSUS:
                return ACCEPT  # not ours to judge
            msg = decode_message(body)
        except ValueError:
            # unparseable consensus bytes are junk, not filtering —
            # REJECT is the punishable verdict (host peer scoring)
            return REJECT
        ctx = IngressContext(
            shard_id=self.chain.shard_id,
            current_view_id=self.view_id,
            committee_keys=set(self.committee()),
            is_leader=self.is_leader,
            in_view_change=self.in_view_change,
        )
        result = validate_consensus_message(msg, ctx, self.chain.shard_id)
        return ACCEPT if result.accepted else IGNORE

    def _slash_validator(self, payload: bytes, frm: str) -> int:
        """Cheap structural gate on slash-topic gossip (no crypto —
        that runs on the pump): a frame that isn't one well-formed
        bounded record is punishable junk."""
        try:
            category, msg_type, body = parse_envelope(payload)
            if category != MessageCategory.NODE or (
                msg_type != NODE_MSG_SLASH
            ):
                return REJECT
            SL.decode_record(body)
        except (ValueError, IndexError):
            return REJECT
        return ACCEPT

    def _on_gossip(self, topic: str, payload: bytes, frm: str):
        self._queue.put(payload)

    def _broadcast(self, msg: FBFTMessage, retry: bool = False):
        # stamp the active trace context (unsigned trailer) so the
        # receiving node's handler — and the device/sidecar work it
        # triggers — lands under this round's trace
        if not msg.trace_ctx:
            msg.trace_ctx = trace.traceparent()
        env = pack_envelope(
            MessageCategory.CONSENSUS, int(msg.msg_type), encode_message(msg)
        )
        if retry:
            self.sender.send_with_retry(msg.block_num, msg.msg_type, env)
        else:
            self.sender.send_without_retry(env)
        return env

    # -- vote aggregation overlay (consensus.aggregation) -------------------

    def _setup_aggregation(self, committee: list):
        """Per-round overlay construction (from ``_new_round``): fold
        the finished round's counters into the node totals, then — in
        handel mode, when this node holds committee slots — build the
        round's :class:`Aggregator` and subscribe its owned slot
        topics."""
        agg = self.aggregator
        if agg is not None:
            t = self._agg_totals
            t["inbound"] += agg.inbound
            t["merged"] += agg.merged
            t["dup"] += agg.dup_dropped
            t["stale"] += agg.stale_dropped
            t["forged"] += agg.forged
            t["emissions"] += agg.emissions
            t["fallbacks"] += agg.fallbacks
        self.aggregator = None
        self._agg_hash = {}
        self._agg_trace_ctx = {}
        if self.aggregation_mode != "handel" or not self._round_keys:
            return
        own = {k.pub.bytes for k in self._round_keys}
        home_slots = [i for i, pk in enumerate(committee) if pk in own]
        if not home_slots:
            return
        try:
            leader_slot = committee.index(self._round_leader_key)
        except ValueError:
            return
        self._agg_slot_of = {pk: i for i, pk in enumerate(committee)}
        for s in home_slots:
            topic = aggregation_topic(self.network, self.chain.shard_id, s)
            if topic not in self._agg_subscribed:
                self._agg_subscribed.add(topic)
                self.host.add_validator(topic, self._agg_validator)
                self.host.subscribe(topic, self._on_gossip_agg)
        # the ladder must resolve well inside the phase timeout: levels
        # escalate every ~1/20th of it, contributions re-emit twice per
        # level, and the direct-vote fallback fires at half the timeout
        # so a stalled overlay still leaves a full half for direct
        # quorum assembly
        level_t = max(0.05, min(1.0, self.phase_timeout / 20.0))
        self.aggregator = AGG.Aggregator(
            committee, home_slots,
            self.leader.decider.is_quorum_achieved_by_mask,
            self._emit_contribution,
            leader_slot=leader_slot,
            is_leader=self.is_leader,
            committee_points=self.validator.committee_points,
            level_timeout_s=level_t,
            reemit_s=level_t / 2,
            stall_timeout_s=max(1.0, self.phase_timeout * 0.5),
        )

    def _agg_validator(self, payload: bytes, frm: str) -> int:
        """Bounded structural gate on aggregation-topic gossip: junk
        frames and known forgers REJECT into the host peer-score
        ladder; the pairing work runs on the pump's scored budget."""
        if self._agg_strikes.get(frm, 0) >= 3:
            return REJECT  # repeat forger: its traffic is punishable
        try:
            category, msg_type, body = parse_envelope(payload)
            if category != MessageCategory.NODE or (
                msg_type != NODE_MSG_AGG
            ):
                return REJECT
            decode_aggregation(body)
        except (ValueError, IndexError):
            return REJECT
        return ACCEPT

    def _on_gossip_agg(self, topic: str, payload: bytes, frm: str):
        # unlike _on_gossip, the sender identity rides along: a forged
        # partial needs someone to charge the strike to
        self._queue.put((payload, frm))

    def _emit_contribution(self, target_slot: int, phase: int,
                           level: int, bitmap: bytes, sig_bytes: bytes):
        """Aggregator transport hook: publish one partial aggregate to
        the target slot's directed topic."""
        agg = self.aggregator
        if agg is None:
            return
        body = encode_aggregation(AggContribution(
            phase=phase,
            view_id=self.view_id,
            block_num=self.block_num,
            block_hash=self._agg_hash.get(phase, bytes(32)),
            level=level,
            bitmap=bitmap,
            sig=sig_bytes,
            sender_slot=agg.home,
        ))
        self.host.publish(
            aggregation_topic(self.network, self.chain.shard_id,
                              target_slot),
            pack_envelope(MessageCategory.NODE, NODE_MSG_AGG, body),
        )

    def _agg_seed(self, phase: int, payload: bytes, block_hash: bytes,
                  sig_bytes: bytes, fallback=None):
        """Activate a phase with this node's own locally-aggregated
        vote; the direct vote message (when given) is stashed for the
        stall fallback instead of broadcast."""
        from .. import bls as B

        agg = self.aggregator
        bits = 0
        for s in agg.home_slots:
            bits |= 1 << s
        self._agg_hash[phase] = block_hash
        self._agg_trace_ctx[phase] = trace.traceparent()
        agg.seed(phase, payload, bits, B.Signature.from_bytes(sig_bytes),
                 fallback=fallback, now=time.monotonic())
        self._aggregation_tick(time.monotonic())

    def _agg_merge_ballot(self, phase: int, msg: FBFTMessage):
        """Fold a direct fallback ballot the leader already
        pairing-verified (fbft._on_vote) into the overlay's aggregate —
        no second verify."""
        from .. import bls as B

        agg = self.aggregator
        if agg is None:
            return
        bits = 0
        for pk in msg.sender_pubkeys:
            slot = self._agg_slot_of.get(pk)
            if slot is None:
                return
            bits |= 1 << slot
        try:
            sig = B.Signature.from_bytes(msg.payload)
        except ValueError:
            return
        agg.merge_verified(phase, bits, sig)

    def _on_aggregation(self, body: bytes, frm: str = ""):
        """Pump handler for one inbound partial aggregate."""
        agg = self.aggregator
        if agg is None:
            return
        try:
            c = decode_aggregation(body)
        except (ValueError, IndexError):
            return
        if (
            c.block_num != self.block_num
            or c.view_id != self.view_id
            or len(c.bitmap) != agg.mask_len
        ):
            return  # another round's traffic: stale or early, not junk
        want = self._agg_hash.get(c.phase)
        if want is not None and c.block_hash != want:
            return  # wrong block: would only fail the pairing check
        agg.on_contribution(
            c.phase, c.level, bytes(c.bitmap), bytes(c.sig), frm=frm
        )
        self._aggregation_tick(time.monotonic())

    def _agg_quorum(self, phase: int) -> bool:
        return self.aggregator is not None and self.aggregator.quorum(phase)

    def aggregation_stats(self) -> dict:
        """Cumulative overlay counters: node totals plus the live
        round's aggregator (chaos invariants read this mid-run)."""
        out = dict(self._agg_totals)
        agg = self.aggregator
        if agg is not None:
            out["inbound"] += agg.inbound
            out["merged"] += agg.merged
            out["dup"] += agg.dup_dropped
            out["stale"] += agg.stale_dropped
            out["forged"] += agg.forged
            out["emissions"] += agg.emissions
            out["fallbacks"] += agg.fallbacks
        return out

    def _aggregation_tick(self, now: float):
        """Drive the overlay: verify/merge the scored pending queue,
        escalate levels, re-emit — each active phase's work lands in a
        ``consensus.aggregation`` span (level attr) under the round's
        trace, so forensics can attribute quorum_assembly time to the
        ladder.  Stalled phases broadcast their stashed direct vote."""
        agg = self.aggregator
        if agg is None:
            return
        advanced = False
        for phase in agg.active_phases():
            st = agg.phases[phase]
            due = st.pending or not st.last_emit or (
                now - st.last_emit >= agg.reemit_s
            )
            if not due:
                continue
            with trace.resume(
                self._agg_trace_ctx.get(phase, b""),
                "consensus.aggregation", component="consensus",
                phase=AGG.PHASE_NAMES.get(phase, str(phase)),
                block=self.block_num,
            ):
                work = agg.tick(phase, now)
                if work is None:
                    continue
                trace.annotate(
                    level=work["level"], verified=work["verified"],
                    merged=work["merged"], emitted=work["emitted"],
                )
                if work["merged"]:
                    advanced = True
                for frm in work["forged_from"]:
                    if len(self._agg_strikes) < 256 or (
                        frm in self._agg_strikes
                    ):
                        self._agg_strikes[frm] = (
                            self._agg_strikes.get(frm, 0) + 1
                        )
        for phase in agg.stalled(now):
            vote = agg.take_fallback(phase)
            if vote is not None:
                self.log.warn(
                    "aggregation stalled: direct vote fallback",
                    phase=AGG.PHASE_NAMES.get(phase, str(phase)),
                    block=self.block_num,
                )
                self._broadcast(vote)
        if advanced and self.is_leader:
            self._leader_advance()

    # -- the pump -----------------------------------------------------------

    def start_round_if_leader(self):
        """Leader proposes + announces (reference: consensus/proposer.go
        WaitForConsensusReadyV2 -> ProposeNewBlock -> announce).  Roots
        the round's trace: every consensus message this round carries
        its context, so one round = one trace across all components."""
        if not self.is_leader or self._proposed:
            return None
        with trace.node_scope(self._node_tag):
            if self._round_span is None:
                self._round_span = trace.start(
                    "consensus.round", component="consensus",
                    block=self.block_num, view=self.view_id,
                    role="leader",
                )
            with trace.use(self._round_span):
                return self._propose_and_announce()

    def _propose_and_announce(self):
        if self._reproposal is not None:
            # re-announce the view-change-carried block UNCHANGED (same
            # hash — PBFT safety); commit payloads bind its original view
            block = self._reproposal
            self._reproposal = None
            self.leader.cfg.payload_view_id = block.header.view_id
        else:
            # epoch-randomness pipeline (reference: consensus_v2.go:955-
            # 1034 — leader's VRF in every gated header; the Wesolowski
            # VDF output lands via header.vdf once the delayed
            # computation over a past epoch seed finishes)
            vrf = b""
            epoch = self.chain.epoch_of(self.block_num)
            if self.chain.config.is_active("vrf", epoch) and len(
                self._round_keys
            ):
                from .. import crypto_vrf

                # sign with the key that IS this view's leader slot —
                # a multi-key node's first key need not be the one the
                # rotation landed on, and validators verify against
                # _round_leader_key
                vrf_key = next(
                    (k for k in self._round_keys
                     if k.pub.bytes == self._round_leader_key),
                    self._round_keys[0],
                )
                _out, proof = crypto_vrf.evaluate(
                    vrf_key, self.chain.current_header().hash()
                )
                vrf = proof
            incoming = self.cx_pool.drain() if self.cx_pool else None
            block = self.worker.propose_block(
                view_id=self.view_id, vrf=vrf,
                incoming_receipts=incoming,
                slashes=self._includable_slashes(),
            )
        block_bytes = rawdb.encode_block(block, self.chain.config.chain_id)
        # the announce carries the leader's own prepare signature:
        # durably record it first — a restarted leader must not
        # propose a DIFFERENT block at a (height, view) it already
        # announced (leader-side equivocation after recovery)
        if self._round_keys and not self.safety.record(
            [k.pub.bytes for k in self._round_keys],
            block.block_num, self.view_id, PHASE_PREPARE, block.hash(),
        ):
            self.log.warn(
                "proposal withheld by safety store",
                block=block.block_num, view=self.view_id,
            )
            return None
        self._pending_block = block
        self._proposed = True
        self._last_propose = time.monotonic()
        with trace.span("consensus.phase.announce", component="consensus",
                        block=block.block_num, view=self.view_id):
            msg = self.leader.announce(block.hash(), block_bytes)
            self.log.info(
                "announce", block=block.block_num, view=self.view_id,
                hash=block.hash().hex()[:16],
                txs=len(block.transactions)
                + len(block.staking_transactions),
            )
            self._broadcast(msg, retry=True)
        # the prepare-quorum phase runs from announce until PREPARED —
        # its span is owned here (finished in _leader_advance) because
        # it spans many pump iterations
        self._phase_span = trace.start(
            "consensus.phase.prepare_quorum", component="consensus",
            parent=self._round_span, block=block.block_num,
        )
        if self.aggregator is not None:
            # the leader's own prepare aggregate (cast into the decider
            # at announce) also seeds its overlay end — inbound partial
            # aggregates merge against it
            own = tuple(k.pub.bytes for k in self._round_keys)
            sig = self.leader.prepare_sigs.get(own)
            if sig is not None:
                self._agg_seed(
                    AGG.PHASE_PREPARE, prepare_payload(block.hash()),
                    block.hash(), sig.bytes,
                )
        # a leader whose own keys already meet quorum (single-operator
        # committee) must advance without waiting for external votes
        self._leader_advance()
        return block

    def _spin_up_sync(self):
        """Run the downloader in the background until caught up, then
        signal the pump to rejoin consensus at the new head (the
        reference's spinUpStateSync + last-mile rejoin)."""
        downloader = self.registry.get("downloader")
        if downloader is None or self._syncing:
            return
        self._syncing = True
        self.sync_spinups += 1
        self._ahead_runs = 0
        self.log.warn(
            "behind: spinning up sync", round=self.block_num,
            head=self.chain.head_number,
        )

        hb = health.register(
            f"sync.downloader[{self._health_tag()}]", max_age_s=60.0,
        )

        def run():
            try:
                for _ in range(1024):  # bounded: each pass is a batch
                    hb.beat()
                    if self._stop.is_set():
                        break  # a stopped node must not keep WRITING
                        # to its chain store (a hard-kill + restart
                        # would otherwise race two writers on one file)
                    res = downloader.sync_once()
                    if res.caught_up:
                        break
            except Exception as e:  # noqa: BLE001 — rejoin regardless
                self.log.error("sync spin-up failed", err=str(e))
            finally:
                hb.close()
                self._sync_done.set()

        self._sync_thread = threading.Thread(target=run, daemon=True)
        self._sync_thread.start()
        hb.bind(self._sync_thread)  # after start: an unstarted thread
        #                             reads as dead to the watchdog

    def _finish_sync_if_done(self):
        """Pump-side completion: re-derive the round from the synced
        head so this node rejoins mid-consensus cleanly."""
        if not self._syncing or not self._sync_done.is_set():
            return
        self._sync_done.clear()
        self._syncing = False
        if self.chain.head_number + 1 != self.block_num:
            self.log.info(
                "sync caught up: rejoining", head=self.chain.head_number,
            )
            self._vc = 0
            self._new_round()

    def process_pending(self, max_msgs: int = 0) -> int:
        """Drain queued gossip through the FBFT handlers; returns the
        number of messages processed."""
        self._finish_sync_if_done()
        n = 0
        # node_scope: resumed per-message spans (consensus.<msgtype>,
        # chain.finalize, the verifies they enqueue) carry THIS node's
        # identity even when one pump thread drives many nodes
        with trace.node_scope(self._node_tag):
            while not self._stop.is_set():
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                # aggregation-topic deliveries carry the sender along
                # (_on_gossip_agg) — everything else is bare payload
                if isinstance(item, tuple):
                    payload, frm = item
                else:
                    payload, frm = item, ""
                self._handle(payload, frm)
                n += 1
                if max_msgs and n >= max_msgs:
                    break
        return n

    def _handle(self, payload: bytes, frm: str = ""):
        try:
            category, msg_type, body = parse_envelope(payload)
            if category == MessageCategory.NODE:
                if msg_type == NODE_MSG_SLASH:
                    self._on_slash_record(body)
                elif msg_type == NODE_MSG_AGG:
                    self._on_aggregation(body, frm)
                return
            if category != MessageCategory.CONSENSUS:
                return
            msg = decode_message(body)
        except ValueError:
            return
        if msg.block_num != self.block_num:
            # stale rounds are noise; a RUN of future rounds means the
            # network is ahead — spin up the downloader (reference:
            # consensus/downloader.go:13-107, consensus_v2.go:498-558)
            if msg.block_num > self.block_num:
                self._ahead_runs += 1
                if self._ahead_runs >= self.ahead_threshold:
                    self._spin_up_sync()
            elif (
                msg.msg_type == MsgType.COMMIT
                and self._prev_commit_ctx is not None
                and msg.block_num == self._prev_commit_ctx[0]
            ):
                # late-ballot forensics: a conflicting COMMIT for the
                # round this node JUST led to quorum typically arrives
                # right behind the tipping honest vote — after the
                # commit reset.  The stashed round context keeps the
                # equivocator from winning that race (cheap key-overlap
                # check gates the pairing work, so stale junk is free).
                pnum, pview, phash, pcv, pstore, ppayload = (
                    self._prev_commit_ctx
                )
                self._check_double_sign(
                    msg, pstore, ppayload, phase="commit",
                    ctx=(pnum, pview, phash, pcv),
                )
            return
        self._ahead_runs = 0
        try:
            # continue the trace carried by the message: the sender-sig
            # check, the handler and every device dispatch / sidecar
            # call / finalize they reach nest under the originating
            # round's trace
            with trace.resume(
                msg.trace_ctx,
                f"consensus.{msg.msg_type.name.lower()}",
                component="consensus", block=msg.block_num,
                view=msg.view_id,
            ):
                self._handle_verified(msg)
        except Exception as e:
            # tolerant message loop (the reference logs and moves on):
            # one malformed message must never kill the consensus pump.
            # A device.DeviceError from a check bound for the card lands
            # here too: a counted drop (a stall), never a verdict
            self.dropped_messages += 1
            self.log.warn("consensus message dropped",
                          msg_type=int(msg.msg_type), error=str(e))

    def _handle_verified(self, msg: FBFTMessage):
        # the sender must have SIGNED this exact message — without this
        # gate any peer could replay/forge another member's ANNOUNCE /
        # PREPARED / COMMITTED (reference verifies the message signature
        # on every consensus message, consensus/checks.go).  Runs on
        # the scheduler's INGRESS lane: admission crypto coalesces and
        # never queues ahead of the round's quorum proofs.
        if not verify_sender(msg):
            self.dropped_messages += 1
            trace.annotate(dropped="bad_sender_sig")
            return
        handler = {
            MsgType.ANNOUNCE: self._on_announce,
            MsgType.PREPARE: self._on_prepare,
            MsgType.PREPARED: self._on_prepared,
            MsgType.COMMIT: self._on_commit,
            MsgType.COMMITTED: self._on_committed,
            MsgType.VIEWCHANGE: self._on_viewchange_msg,
            MsgType.NEWVIEW: self._on_newview_msg,
        }.get(msg.msg_type)
        if handler is not None:
            handler(msg)

    # -- FBFT phase handlers ------------------------------------------------

    def _validate_proposed_block(self, block_bytes: bytes):
        """Decode + dry-run the proposal (reference: validator.go:83-143
        validateNewBlock: full execution before committing to it)."""
        try:
            block = rawdb.decode_block(block_bytes)
        except (ValueError, IndexError):
            return None
        header = block.header
        head = self.chain.current_header()
        if header.block_num != head.block_num + 1:
            return None
        if header.parent_hash != head.hash():
            return None
        # header.view_id must be the round view — or the exact block a
        # verified NEWVIEW carried (re-proposals keep their original
        # view, but only for the hash the view-change quorum attested)
        if header.view_id != self.view_id and (
            self._expected_reproposal_hash is None
            or block.hash() != self._expected_reproposal_hash
        ):
            return None
        if block.tx_root(self.chain.config.chain_id) != header.tx_root:
            return None
        if self.chain.config.is_active("vrf", header.epoch) and (
            block.hash() != self._expected_reproposal_hash
        ):
            # the leader's VRF proof must verify against its key over
            # the parent hash (consensus_v2.go ProposalVrfAndProof).
            # Re-proposals carry the ORIGINAL proposer's VRF and were
            # already validated under that view (M1 quorum attested).
            from .. import bls as B
            from .. import crypto_vrf

            try:
                crypto_vrf.verify(
                    B.PublicKey.from_bytes(self._round_leader_key),
                    head.hash(), header.vrf,
                )
            except ValueError:
                return None
        # the carried parent commit proof drives reward/availability
        # state — it must be EXACTLY the proof this node committed for
        # the parent (all honest nodes stored the same COMMITTED
        # payload), or, where only an engine is wired, verify the seal.
        # A fabricated bitmap would otherwise mis-assign rewards AND
        # fork live state from sync replay.
        if header.block_num > 1:
            carried = header.last_commit_sig + header.last_commit_bitmap
            local = self.chain.read_commit_sig(head.block_num)
            if local is not None:
                if carried != local:
                    return None
            elif self.chain.engine is not None:
                if not self.chain.engine.verify_seal(head, header):
                    return None
            elif carried:
                return None  # unverifiable proof: reject
        try:
            # CX batches must be verified BEFORE voting: a quorum that
            # signs a block with a fabricated/replayed proof would stall
            # the round (everyone's insert rejects it) and the bad
            # PREPARED proof could ride view changes as M1
            self.chain.verify_incoming_receipts(block)
            state = self.chain.state().copy()
            result = self.chain.processor.process(state, block, header.epoch)
            from ..core.types import group_cx_by_shard, out_cx_root

            if out_cx_root(
                group_cx_by_shard(result.outgoing_cx)
            ) != header.out_cx_root:
                return None
            # included slash records re-verify against the moment's
            # epoch committee BEFORE this node votes: a leader packing
            # a forged/duplicate record loses the round, not the
            # network (the applied effect also feeds the root check)
            self.chain.apply_slashes(
                state, header.slashes, header.block_num,
                observe=False, version=header.version,
            )
            self.chain.post_process(
                state, header.block_num, header.epoch,
                header.last_commit_bitmap or None,
            )
            if self.chain.config.state_root(state, header.epoch) != header.root:
                return None
        except ValueError:
            return None
        return block

    def _on_announce(self, msg: FBFTMessage):
        if self.is_leader:
            return
        # bind to THIS round's view and ITS designated leader — a
        # committee member must not be able to pick a view id whose
        # rotation lands on itself (leader capture)
        if msg.view_id != self.view_id:
            self.log.debug(
                "announce dropped: view mismatch", msg_view=msg.view_id,
                our_view=self.view_id, block=msg.block_num,
            )
            return
        if not msg.sender_pubkeys or (
            msg.sender_pubkeys[0] != self._round_leader_key
        ):
            self.log.debug(
                "announce dropped: not this view's leader",
                view=self.view_id, block=msg.block_num,
            )
            return
        if self._announce_voted == (msg.block_num, self.view_id):
            return  # already prepared a block this round
        block = self._validate_proposed_block(msg.block)
        if block is None:
            self.log.warn(
                "announce dropped: proposal failed validation",
                block=msg.block_num, view=self.view_id,
            )
            return
        self._pending_block = block
        self._announce_voted = (msg.block_num, self.view_id)
        # commit payloads bind the block header's own view (differs from
        # the round view only for a view-change re-proposal)
        self.validator.cfg.payload_view_id = block.header.view_id
        if not self._round_keys:
            return  # observer this epoch: follow, never vote
        if self.in_view_change:
            # port-only: a VIEWCHANGE vote is the promise to leave this
            # view, so no vote in it follows (see _on_prepared); the
            # block stays pending, so a COMMITTED for it from the others
            # still inserts it here without a sync
            self.log.debug(
                "prepare vote withheld: leaving this view",
                view=self.view_id, block=msg.block_num,
            )
            return
        # durable double-sign guard, written BEFORE the vote leaves:
        # survives a hard kill where _announce_voted does not
        if not self.safety.record(
            [k.pub.bytes for k in self._round_keys],
            msg.block_num, self.view_id, PHASE_PREPARE, block.hash(),
        ):
            self.log.warn(
                "prepare vote withheld by safety store",
                block=msg.block_num, view=self.view_id,
            )
            return
        vote = self.validator.on_announce(msg)
        if self.aggregator is not None:
            # handel: the prepare vote enters the overlay instead of
            # the wire — stashed whole for the stall fallback
            self._agg_seed(
                AGG.PHASE_PREPARE, prepare_payload(msg.block_hash),
                msg.block_hash, vote.payload, fallback=vote,
            )
        else:
            self._broadcast(vote)
        self.log.info(
            "prepare vote sent", block=msg.block_num, view=self.view_id,
        )

    def _leader_advance(self):
        """Emit PREPARED/COMMITTED the moment their quorum holds for the
        ANNOUNCED block (reference: threshold.go:14-69 + finalCommit)."""
        block_hash = self.leader.current_block_hash
        if block_hash is None:
            return
        if not self._sent_prepared:
            prepared = self.leader.try_prepared(block_hash)
            if prepared is None and self._agg_quorum(AGG.PHASE_PREPARE):
                # overlay quorum before ballot-store quorum: PREPARED
                # carries the ladder-assembled proof directly
                prepared = self.leader.prepared_from_proof(
                    block_hash, self.aggregator.proof(AGG.PHASE_PREPARE)
                )
            if prepared is not None:
                self._sent_prepared = True
                self.log.info(
                    "prepared quorum", block=self.block_num,
                    view=self.view_id,
                )
                # prepare-quorum reached: close its phase span, open
                # the commit-quorum one (both parented to the round)
                trace.finish(self._phase_span)
                self._phase_span = trace.start(
                    "consensus.phase.commit_quorum",
                    component="consensus", parent=self._round_span,
                    block=self.block_num,
                )
                self._broadcast(prepared, retry=True)
                # leader self-commits with its own keys
                # (reference: threshold.go:53-69)
                commit_vote = self.validator.on_prepared(prepared)
                # the record must carry the view the signed bytes BIND
                # (cfg.commit_view_id — a re-proposal's payload keeps
                # its ORIGINAL view), or equivocation across a view-
                # change re-proposal would slip past the guard
                if commit_vote is not None and self.safety.record(
                    [k.pub.bytes for k in self._round_keys],
                    self.block_num, self.validator.cfg.commit_view_id,
                    PHASE_COMMIT, block_hash,
                ):
                    self.leader.on_commit(commit_vote)
                    if self.aggregator is not None:
                        self._agg_seed(
                            AGG.PHASE_COMMIT,
                            self.validator._commit_payload(block_hash),
                            block_hash, commit_vote.payload,
                        )
        if self._sent_prepared and not self._sent_committed:
            committed = self.leader.try_committed(block_hash)
            if committed is None and self._agg_quorum(AGG.PHASE_COMMIT):
                committed = self.leader.committed_from_proof(
                    block_hash, self.aggregator.proof(AGG.PHASE_COMMIT)
                )
            if committed is not None:
                self._sent_committed = True
                trace.finish(self._phase_span)
                self._phase_span = None
                self._broadcast(committed, retry=True)
                self._commit_block(committed)

    def _check_double_sign(self, msg: FBFTMessage, store, payload_for,
                           phase: str = "prepare", ctx=None):
        """Leader-side equivocation detection (reference:
        consensus/double_sign.go:16 checkDoubleSign).  Evidence needs
        BOTH signed votes from the same key in ONE round: the stored
        vote for the announced block plus a verified conflicting vote
        for a different hash at the same (height, view) — a delayed
        vote from another view, or unsigned junk, must not frame
        anyone.  ``ctx`` supplies a PAST round's (block_num, view,
        hash, commit_view) for the late-ballot window; default is the
        live round.

        Commit-phase conflicts additionally become block-includable
        ``slash.Record``s (the phase the reference slashes on) — queued
        for this node's next proposal AND published on the slash gossip
        topic so whoever leads next can include them."""
        if ctx is None:
            ctx = (self.block_num, self.view_id,
                   self.leader.current_block_hash,
                   self.leader.cfg.commit_view_id)
        block_num, view_id, block_hash, commit_view = ctx
        if (
            block_hash is None
            or msg.block_hash == block_hash
            or msg.view_id != view_id
            or msg.block_num != block_num
            or not msg.sender_pubkeys
        ):
            return
        # the accused keys must have already cast the round's vote
        first = None  # (keyset, stored aggregate signature)
        for keyset, sig in store.items():
            if any(pk in keyset for pk in msg.sender_pubkeys):
                first = (keyset, sig)
                break
        if first is None:
            return
        from .. import bls as B
        from .. import sched

        # forensics on a rejected ballot is admission work: it must
        # queue BEHIND the round's quorum proofs (ingress lane), or a
        # bogus-ballot flood would buy device priority
        if not B.verify_aggregate_bytes(
            msg.sender_pubkeys, payload_for(msg.block_hash), msg.payload,
            lane=sched.Lane.INGRESS,
        ):
            return
        evidence = {
            "height": msg.block_num,
            "view_id": msg.view_id,
            "shard_id": self.chain.shard_id,
            "keys": [pk.hex() for pk in msg.sender_pubkeys],
            "first_hash": block_hash.hex(),
            "first_keys": [pk.hex() for pk in first[0]],
            "first_signature": first[1].bytes.hex(),
            "second_hash": msg.block_hash.hex(),
            "second_signature": msg.payload.hex(),
        }
        self.double_sign_events += 1
        SL.COUNTERS.inc("detected")
        self._queue_forensic_evidence(evidence)
        self.log.warn(
            "double sign detected", height=msg.block_num,
            view=msg.view_id, keys=len(msg.sender_pubkeys), phase=phase,
        )
        if self.webhooks is not None:
            self.webhooks.fire("double_sign", evidence)
        if phase == "commit":
            record = self._build_slash_record(
                msg, first, block_hash, commit_view,
            )
            if record is not None and self._queue_slash_record(record):
                # flood the evidence: the dedup fingerprint makes
                # repeats free on every receiver
                self.host.publish(self._slash_topic, pack_envelope(
                    MessageCategory.NODE, NODE_MSG_SLASH,
                    SL.encode_record(record),
                ))

    def _queue_forensic_evidence(self, evidence: dict):
        """Bounded forensic queue: at the cap, evict a DUPLICATE (same
        offender keys at the same moment — re-delivered conflicting
        votes) before ever dropping a fresh offender; an actual drop is
        logged once and counted."""
        if len(self.pending_double_signs) >= 64:
            dup_key = (evidence["height"], evidence["view_id"],
                       tuple(evidence["keys"]))
            for i, old in enumerate(self.pending_double_signs):
                if (old["height"], old["view_id"],
                        tuple(old["keys"])) == dup_key:
                    self.pending_double_signs.pop(i)
                    break
            else:
                self.double_signs_dropped += 1
                if self._ds_dropped_metric is not None:
                    self._ds_dropped_metric.inc()
                if not self._ds_drop_logged:
                    self._ds_drop_logged = True
                    self.log.error(
                        "double-sign evidence queue full: dropping "
                        "new evidence (logged once; see "
                        "harmony_consensus_double_sign_dropped_total)",
                        cap=64,
                    )
                return
        self.pending_double_signs.append(evidence)

    def _address_of_key(self, key: bytes, epoch: int):
        """(validator address, staked) for a committee BLS key: the
        elected shard state's slot when one exists (its address is what
        a slash applies to), else the finalizer's Harmony-operated
        account table, else None (pre-staking chains have no address to
        slash — evidence stays forensic)."""
        shard_state = self.chain.shard_state_for_epoch(epoch)
        if shard_state is not None:
            com = shard_state.find_committee(self.chain.shard_id)
            if com is not None:
                for slot in com.slots:
                    if slot.bls_pubkey == key:
                        return (slot.ecdsa_address,
                                slot.effective_stake is not None)
        fin = self.chain.finalizer
        if fin is not None:
            for addr, pub in fin.cfg.harmony_accounts:
                if pub == key:
                    return addr, False
        return None, False

    def _build_slash_record(self, msg: FBFTMessage, first,
                            block_hash: bytes, commit_view: int):
        """Assemble a verifiable Record from a commit-phase conflict.
        The offender is the STAKED validator behind a double-signing
        key (preferred over Harmony-operated slots — those hold no
        slashable stake); None when no overlap key resolves to an
        address distinct from this node's own (self-reports are
        invalid by construction)."""
        epoch = self.chain.epoch_of(msg.block_num)
        overlap = [pk for pk in msg.sender_pubkeys if pk in first[0]]
        offender = None
        for want_staked in (True, False):
            for pk in overlap:
                addr, staked = self._address_of_key(pk, epoch)
                if addr is not None and staked == want_staked:
                    offender = addr
                    break
            if offender is not None:
                break
        if offender is None:
            return None
        reporter = b"\x00" * 20
        if self._round_keys:
            addr, _ = self._address_of_key(
                self._round_keys[0].pub.bytes, epoch
            )
            if addr is not None:
                reporter = addr
        if reporter == offender:
            return None  # a self-report never verifies
        record = SL.Record(
            evidence=SL.Evidence(
                moment=SL.Moment(
                    epoch=epoch, shard_id=self.chain.shard_id,
                    height=msg.block_num,
                    view_id=commit_view,
                ),
                first_vote=SL.Vote(
                    signer_pubkeys=list(first[0]),
                    block_header_hash=block_hash,
                    signature=first[1].bytes,
                ),
                second_vote=SL.Vote(
                    signer_pubkeys=list(msg.sender_pubkeys),
                    block_header_hash=msg.block_hash,
                    signature=msg.payload,
                ),
                offender=offender,
            ),
            reporter=reporter,
        )
        try:
            SL.verify_record(
                record, self.chain.committee_for_epoch(epoch),
                is_staking=self.chain.config.is_staking(epoch),
            )
        except SL.SlashVerifyError as e:
            self.log.warn("assembled slash record invalid", err=str(e))
            return None
        return record

    def _queue_slash_record(self, record) -> bool:
        """Dedup + bound the includable queue; True if newly queued."""
        fp = SL.record_fingerprint(record)
        if fp in self._slash_seen:
            return False
        if len(self.pending_slash_records) >= 64:
            # NOT marked seen: evidence shed at a full queue must stay
            # ingestible when the queue drains and the record re-floods
            SL.COUNTERS.inc("dropped")
            return False
        if len(self._slash_seen) > 4096:
            self._slash_seen.clear()  # bounded; re-gossip re-dedups
        self._slash_seen.add(fp)
        self.pending_slash_records.append(record)
        SL.COUNTERS.inc("queued")
        return True

    def _on_slash_record(self, body: bytes):
        """Slash-topic pump handler: bounded decode, full evidence
        verification against the moment's committee, then queue for
        this node's next proposal."""
        try:
            record = SL.decode_record(body)
        except (ValueError, IndexError):
            return
        m = record.evidence.moment
        if m.shard_id != self.chain.shard_id:
            return
        if m.epoch > self.chain.epoch_of(self.block_num):
            return  # from the future: cannot resolve a committee yet
        if SL.record_fingerprint(record) in self._slash_seen:
            return  # dedup BEFORE the pairing work: replaying one
            # valid record in a loop must cost a hash, not two
            # aggregate verifications per copy
        try:
            SL.verify_record(
                record, self.chain.committee_for_epoch(m.epoch),
                is_staking=self.chain.config.is_staking(m.epoch),
            )
        except SL.SlashVerifyError as e:
            SL.COUNTERS.inc("rejected")
            self.log.warn("gossiped slash record rejected", err=str(e))
            return
        SL.COUNTERS.inc("gossip_received")
        if self._queue_slash_record(record):
            self.log.warn(
                "slash evidence received via gossip",
                height=m.height, view=m.view_id,
            )

    def _includable_slashes(self) -> list:
        """The pending records this proposal should carry: still
        unapplied (offender not yet banned) against the CURRENT state.
        Records consumed by a competing leader's block stay filtered
        here and age out of the bounded queue."""
        state = self.chain.state()
        out = []
        for r in self.pending_slash_records:
            if len(out) >= SL.MAX_SLASHES_PER_BLOCK:
                break
            w = state.validator(r.evidence.offender)
            if w is None or w.status == 2:
                continue
            out.append(r)
        return out

    def drain_double_signs(self) -> list:
        """Hand collected evidence to the slash pipeline (proposal
        inclusion / operator tooling) and clear the queue."""
        out, self.pending_double_signs = self.pending_double_signs, []
        return out

    def _on_prepare(self, msg: FBFTMessage):
        if not self.is_leader:
            return
        if self.leader.on_prepare(msg):
            if self.aggregator is not None:
                # direct fallback ballot under handel: fold it into the
                # overlay so proof assembly sees every verified vote
                self._agg_merge_ballot(AGG.PHASE_PREPARE, msg)
            self.log.info(
                "prepare vote counted", block=self.block_num,
                view=self.view_id, keys=len(self.leader.prepare_sigs),
            )
        else:
            self._check_double_sign(
                msg, self.leader.prepare_sigs, prepare_payload
            )
        self._leader_advance()

    def _on_prepared(self, msg: FBFTMessage):
        if self.is_leader:
            return
        if not self._round_keys:
            return  # observer: cannot cast a commit vote
        if self.in_view_change:
            # port-only: a node that has voted to leave this view casts
            # no commit vote in it.  The JAX package's node does, and a
            # NEWVIEW built from view-change votes sent before PREPARED
            # carries no block, so the old view's leader could commit
            # one block at this height and the new view another (a fork
            # of the chain, seen in the rolling_restart chaos scenario)
            return
        vote = self.validator.on_prepared(msg)
        if vote is not None:
            # record the view the commit payload BINDS (a re-proposal
            # signs its original view, not the round view) — the
            # double-sign guard must compare what was actually signed
            if not self.safety.record(
                [k.pub.bytes for k in self._round_keys],
                msg.block_num, self.validator.cfg.commit_view_id,
                PHASE_COMMIT, msg.block_hash,
            ):
                self.log.warn(
                    "commit vote withheld by safety store",
                    block=msg.block_num, view=self.view_id,
                )
                return
            # remember the prepared proof: a view change must carry it
            # (M1) so the block survives the leader's failure
            self._prepared_proof = msg.payload
            if msg.block:
                self._prepared_block_bytes = msg.block
            elif self._pending_block is not None:
                self._prepared_block_bytes = rawdb.encode_block(
                    self._pending_block, self.chain.config.chain_id
                )
            if self.aggregator is not None:
                self._agg_seed(
                    AGG.PHASE_COMMIT,
                    self.validator._commit_payload(msg.block_hash),
                    msg.block_hash, vote.payload, fallback=vote,
                )
            else:
                self._broadcast(vote)

    def _on_commit(self, msg: FBFTMessage):
        if not self.is_leader:
            return
        if self.leader.on_commit(msg):
            if self.aggregator is not None:
                self._agg_merge_ballot(AGG.PHASE_COMMIT, msg)
        else:
            self._check_double_sign(
                msg, self.leader.commit_sigs,
                self.leader._commit_payload, phase="commit",
            )
        self._leader_advance()

    def _on_committed(self, msg: FBFTMessage):
        if self.is_leader:
            return
        if not self.validator.on_committed(msg):
            return
        self._commit_block(msg)

    def _commit_block(self, msg: FBFTMessage):
        """Insert the round's block with its quorum proof (reference:
        consensus_v2.go:702 commitBlock -> InsertChain)."""
        block = self._pending_block
        if block is None or block.hash() != msg.block_hash:
            return
        with trace.span("chain.finalize", component="chain",
                        block=block.block_num):
            try:
                from .. import sched

                self.chain.insert_chain(
                    [block], commit_sigs=[msg.payload],
                    verify_seals=self.chain.engine is not None,
                    lane=sched.Lane.CONSENSUS,
                )
            except ChainError as e:
                trace.annotate(error=str(e))
                self.log.error(
                    "commit insert failed", block=block.block_num,
                    err=str(e),
                )
                return
        self.log.info(
            "committed", block=block.block_num, view=self.view_id,
            hash=block.hash().hex()[:16],
        )
        # the round's timeline closes here: latency to the histogram,
        # the root span to the store, and — when an SLO is armed and
        # overrun — one flight-recorder dump of the slow round
        round_s = time.monotonic() - self._round_start
        if self._round_seconds is not None:
            self._round_seconds.observe(round_s)
        rs = self._round_span
        if rs is not None:
            self._round_span = None
            rs.annotate(round_s=round(round_s, 6))
            trace.finish(rs)
            slo = trace.round_slo_s()
            if slo is not None and round_s > slo:
                trace.anomaly(
                    "round_slo", trace_id=rs.trace_id,
                    block=block.block_num, round_s=round(round_s, 3),
                    slo_s=slo,
                )
        if self.pool is not None:
            self.pool.drop_applied()
        if self.pending_slash_records:
            # purge records the chain has consumed (offender banned by
            # this or a competing leader's block): the bounded queue
            # must not silt up with already-applied evidence
            state = self.chain.state()
            self.pending_slash_records = [
                r for r in self.pending_slash_records
                if (w := state.validator(r.evidence.offender)) is not None
                and w.status != 2
            ]
        self.sender.stop_retry(block.block_num)
        if self.shard_count > 1 and self.is_leader:
            # sender-side restricted, as the reference's
            # BroadcastCXReceipts: one exporter per committed block
            # keeps destination-shard decode work O(1) in committee
            # size (every validator CAN export — hmy facade reads —
            # but only the round's leader publishes)
            self._broadcast_cx_receipts(block.block_num)
        self.committed_blocks += 1
        self._vc = 0
        self._sent_prepared = False
        self._sent_committed = False
        self._new_round()
        # preCommitAndPropose (consensus_v2.go:559-635): COMMITTED is
        # already on the wire; if this node leads the next round and the
        # block period has elapsed, propose NOW — proposal construction
        # and broadcast overlap the validators' insert work instead of
        # idling until the next pacing tick
        if (
            self.pipelining
            and self.is_leader
            and time.monotonic() - self._last_propose >= self.block_time
        ):
            self.start_round_if_leader()

    def _broadcast_cx_receipts(self, block_num: int):
        """Export the committed block's outgoing receipts as sealed
        proofs and publish each to its destination shard's cx topic
        (reference: node_cross_shard.go BroadcastCXReceipts).

        The publish is re-fired on a backoff tail (like the consensus
        sender's retry): destination-side CXPool dedup makes repeats
        free, and a one-shot publish would lose the transfer forever
        to a still-forming mesh.  Residual risk — the leader dying
        within the retry window — is recoverable by any validator
        re-exporting via the same rawdb batch (hmy facade surface)."""
        from .cross_shard import cx_topic, encode_cx_batch, export_receipts

        try:
            proofs = export_receipts(
                self.chain, block_num, self.shard_count
            )
        except (ValueError, KeyError) as e:
            self.log.warn("cx export failed", block=block_num, err=str(e))
            return
        wires = {
            to_shard: encode_cx_batch(proof)
            for to_shard, proof in proofs.items()
        }
        for to_shard, proof in proofs.items():
            self.host.publish(cx_topic(self.network, to_shard),
                              wires[to_shard])
            self.log.info(
                "cx receipts exported", block=block_num,
                to_shard=to_shard, n=len(proof.receipts),
            )
        if not wires:
            return

        def retry_tail():
            for wait in (2.0, 5.0, 10.0, 20.0, 30.0):
                if self._stop.wait(wait):
                    return
                for to_shard, wire in wires.items():
                    self.host.publish(
                        cx_topic(self.network, to_shard), wire
                    )

        threading.Thread(target=retry_tail, daemon=True).start()

    # -- view change (reference: consensus/view_change.go:220-553) ----------

    def vc_timeout(self) -> float:
        """The CURRENT consensus timeout: the base phase timeout for a
        live round, GROWING with each failed view change (reference:
        view_change.go getTimeout — viewChangeDuration scales with the
        view distance).  Constant timeouts never converge: validators
        whose timers drifted keep voting for DIFFERENT views, so no
        single view ever assembles M3 quorum — the churn chaos
        scenario stormed for a hundred seconds on exactly that."""
        return self.phase_timeout * min(1 + self._vc, 8)

    def start_view_change(self):
        """Phase timeout: vote to move to the next view (startViewChange).
        Carries the prepared proof (M1) when this node saw PREPARED —
        the half-done block must survive into the new view."""
        self._vc += 1
        self.view_changes += 1
        head = self.chain.current_header()
        new_view = head.view_id + 1 + self._vc
        self.in_view_change = True
        self.log.warn(
            "view change start", block=self.block_num, new_view=new_view,
            had_prepared=self._prepared_proof is not None,
        )
        # a view change IS the anomaly the flight recorder exists for:
        # dump the wedged round's spans + correlated log lines
        trace.anomaly(
            "view_change",
            trace_id=(self._round_span.trace_id
                      if self._round_span is not None else None),
            block=self.block_num, new_view=new_view,
        )
        self._round_start = time.monotonic()
        if not self._round_keys:
            return  # observer: adopt whatever NEWVIEW quorum emerges
        prepared_hash = None
        if self._prepared_proof is not None and self._pending_block is not None:
            prepared_hash = self._pending_block.hash()
        # a VC signature is a durable promise to leave the old view:
        # recorded before broadcast so a restarted node's round view
        # fast-forwards past it (_new_round's floor)
        if not self.safety.record(
            [k.pub.bytes for k in self._round_keys],
            self.block_num, new_view, PHASE_VIEWCHANGE,
            prepared_hash or bytes(32),
        ):
            self.log.warn(
                "view-change vote withheld by safety store",
                block=self.block_num, new_view=new_view,
            )
            return
        vc = construct_viewchange(
            self._round_keys, new_view, self.block_num,
            prepared_hash, self._prepared_proof,
        )
        msg = sign_message(FBFTMessage(
            msg_type=MsgType.VIEWCHANGE,
            view_id=new_view,
            block_num=self.block_num,
            block_hash=prepared_hash or bytes(32),
            sender_pubkeys=[k.pub.bytes for k in self._round_keys],
            payload=encode_viewchange(vc),
            block=self._prepared_block_bytes if prepared_hash else b"",
        ), self._round_keys)
        # the view's designated leader collects VC votes — start my
        # collector (and self-vote) if that's me
        if any(
            k.pub.bytes == self.leader_key(new_view)
            for k in self._round_keys
        ):
            committee = self.committee()
            self._vc_collector = ViewChangeCollector(
                committee, Decider(self.policy, committee, self.roster),
                new_view,
            )
            self._vc_collector.on_viewchange(vc)
            if prepared_hash:
                self._vc_block_bytes = self._prepared_block_bytes
            # votes that arrived before our own timeout.  Draining can
            # reach quorum MID-LOOP: _on_viewchange_msg then emits
            # NEWVIEW and adopts the view, and _new_round clears the
            # collector — stop draining and don't re-try on the dead
            # collector (a multi-key next leader whose own keys plus
            # the early votes already meet quorum hit this every time;
            # the crash killed the consensus pump thread)
            pending, self._vc_pending = self._vc_pending, []
            for early in pending:
                self._on_viewchange_msg(early)
                if self._vc_collector is None:
                    break  # quorum reached: new view already adopted
            if self._vc_collector is not None:
                self._try_new_view(new_view)
        self._broadcast(msg, retry=True)

    def _on_viewchange_msg(self, msg: FBFTMessage):
        """Next-leader side: collect votes (onViewChange)."""
        if not self.in_view_change:
            # a peer timed out before us: buffer until our own timeout
            # enters the view change (votes must not be lost to races);
            # bounded — forged gossip must not grow memory
            if msg.view_id > self.view_id and len(self._vc_pending) < 64:
                self._vc_pending.append(msg)
            return
        if self._vc_collector is None or (
            msg.view_id != self._vc_collector.view_id
        ):
            return
        try:
            vc = decode_viewchange(msg.payload)
        except (ValueError, IndexError):
            return
        if self._vc_collector.on_viewchange(vc) and vc.m1_payload:
            if msg.block:
                self._vc_block_bytes = msg.block
        self._try_new_view(msg.view_id)

    def _try_new_view(self, new_view: int):
        if self._vc_collector is None:
            return  # already adopted (or never this node's collection)
        # the NEW view's leader slot key must lead the sender list —
        # receivers bind NEWVIEW to sender_pubkeys[0] (a multi-key
        # collector's first round key need not be the new view's slot)
        nv_leader = self.leader_key(new_view)
        keys = PrivateKeys.from_keys(
            [k for k in self._round_keys if k.pub.bytes == nv_leader]
            + [k for k in self._round_keys if k.pub.bytes != nv_leader]
        )
        nv = self._vc_collector.try_new_view(self.block_num, keys)
        if nv is None:
            return
        block_bytes = (
            getattr(self, "_vc_block_bytes", b"") if nv.m1_payload else b""
        )
        out = sign_message(FBFTMessage(
            msg_type=MsgType.NEWVIEW,
            view_id=new_view,
            block_num=self.block_num,
            block_hash=(nv.m1_payload[:32] if nv.m1_payload
                        else bytes(32)),
            sender_pubkeys=[k.pub.bytes for k in keys],
            payload=encode_newview(nv),
            block=block_bytes,
        ), keys)
        self._broadcast(out, retry=True)
        self._adopt_new_view(new_view, nv, block_bytes)

    def _on_newview_msg(self, msg: FBFTMessage):
        """Validator side: verify the NEWVIEW proof, adopt the view
        (onNewView).  Accepted even before this node's own timeout —
        the quorum proof inside is what gates adoption."""
        try:
            nv = decode_newview(msg.payload)
        except (ValueError, IndexError):
            return
        # the ADOPTED view is the SIGNED one (nv.view_id, attested by
        # the M3 quorum); the unsigned envelope must agree, and the
        # view must be strictly newer than anything committed/active —
        # a rewrapped old proof must not steer views
        if nv.view_id != msg.view_id:
            return
        if nv.view_id <= self.chain.current_header().view_id:
            return
        if not self.in_view_change and nv.view_id <= self.view_id:
            return
        if not msg.sender_pubkeys or (
            msg.sender_pubkeys[0] != self.leader_key(nv.view_id)
        ):
            return  # NEWVIEW must come from the view's designated leader
        committee = self.committee()
        decider = Decider(self.policy, committee, self.roster)
        if not verify_new_view(nv, committee, decider):
            return
        self._adopt_new_view(nv.view_id, nv, msg.block)

    def _adopt_new_view(self, new_view: int, nv, block_bytes: bytes):
        """Everyone: move to the new view; the new leader re-proposes
        the carried prepared block, or proposes fresh."""
        head = self.chain.current_header()
        self._vc = max(new_view - head.view_id - 1, 0)
        self.new_views_adopted += 1
        self.log.info(
            "adopt new view", new_view=new_view, block=self.block_num,
            carried_block=bool(nv.m1_payload),
        )
        reproposal = None
        if nv.m1_payload and block_bytes:
            try:
                block = rawdb.decode_block(block_bytes)
                if block.hash() == nv.m1_payload[:32]:
                    reproposal = block
            except (ValueError, IndexError):
                reproposal = None
        self._new_round()
        self._reproposal = reproposal
        if nv.m1_payload:
            self._expected_reproposal_hash = nv.m1_payload[:32]

    # -- live mode ----------------------------------------------------------

    def run_forever(self, poll_interval: float = 0.01,
                    block_time: float = 2.0,
                    phase_timeout: float | None = None):
        """Drive the pump; the leader proposes at most every
        ``block_time`` seconds (reference: mainnet 2 s block period,
        internal/params/config.go:740 IsTwoSeconds).  ``phase_timeout``
        overrides the 27 s reference default (consensus/config.go:10) —
        oversubscribed localnets (N python processes on one core doing
        host-bigint pairing checks) need room, a real deployment does
        not."""

        self.block_time = block_time
        if phase_timeout is not None:
            self.phase_timeout = float(phase_timeout)
        self.pipelining = True  # live mode: overlap COMMITTED + propose
        # the pump IS the node's heartbeat: register it with the
        # liveness watchdog (critical — a silent pump is a dead node).
        # No restart supervisor: the loop below is already
        # exception-tolerant, so death only follows stop()
        hb = health.register(
            f"consensus.pump[{self._health_tag()}]", critical=True,
        )

        def loop():
            trace.bind_node(self._node_tag)  # span node attribution
            while not self._stop.is_set():
                try:
                    hb.beat()
                    now = time.monotonic()
                    if now - self._last_maintenance >= (
                        self.maintenance_interval_s
                    ):
                        self._last_maintenance = now
                        if self.pool is not None:
                            self.pool.evict_stale()
                    if now - self._last_propose >= block_time:
                        self.start_round_if_leader()
                    if (
                        now - self._round_start > self.vc_timeout()
                        and self.chain.head_number + 1 == self.block_num
                    ):
                        # fires again while ALREADY in view change: each
                        # timeout escalates to the next view/leader (the
                        # reference restarts VC with growing timeouts — a
                        # dead next-leader must not wedge the network)
                        self.start_view_change()
                        if self._vc >= 2:
                            # two VC timeouts without a commit: either
                            # the network is dead (sync is a no-op) or it
                            # moved on without us — e.g. we missed
                            # COMMITTED for a round we prepared.  Probing
                            # peers' heads does not depend on gossip
                            # reaching us, so this recovers wedges the
                            # _ahead_runs counter can't see (the
                            # reference's consensus-timeout sync,
                            # consensus/downloader.go + view change spin)
                            self._spin_up_sync()
                    self._aggregation_tick(now)
                    busy = self.process_pending()
                except Exception as e:  # noqa: BLE001 — the pump is the
                    # node's heartbeat: one failed proposal or handler
                    # must degrade to a logged skipped beat (the round
                    # recovers via view change / sync), never silently
                    # kill consensus on this node forever.  The chaos
                    # sweep found exactly that: a crashed pump turns one
                    # transient fault into a permanent outage.
                    self.log.error("consensus pump error", err=repr(e))
                    busy = 0
                if not busy:
                    self._stop.wait(poll_interval)
            hb.close()

        t = threading.Thread(
            target=loop, daemon=True,
        )  # graftlint: thread-role=consensus.pump
        t.start()
        hb.bind(t)
        return t

    def _health_tag(self) -> str:
        """Stable participant label for this node's watchdog entries:
        the gossip host name where one exists (unique per node in a
        multi-node test process), else the shard id."""
        name = getattr(self.host, "name", "")
        return name or f"shard{self.chain.shard_id}"

    def stop(self):
        self._stop.set()
        self.sender.stop_all()  # no retry thread outlives the node
