"""Handel-style multi-level vote aggregation: O(log N) quorum assembly.

The leader-side choke this removes: FBFT's whole point is BLS
multi-signature vote collection, yet with direct (point-to-point)
voting the leader ingests one ballot per voting node per phase.
Handel (arXiv:1906.05132) arranges the committee's slot indices into
a binomial-tree level ladder; each participant merges incoming
partial multi-signatures — a 96-byte aggregate plus a participation
bitmap, the exact ``[sig || bitmap]`` shape FBFT's quorum proof
already uses — and periodically emits its best contribution to the
peer half of the next level, under per-level timeouts.  The leader
then assembles quorum from O(log N) inbound aggregates instead of N
ballots.  Aggregated-signature gossip (arXiv:1911.04698) is the
degenerate fallback shape: when the overlay stalls, nodes fall back
to today's direct-to-leader vote, so liveness never regresses.

Two relaxations against the paper, both forced by this codebase's
multi-key reality (committee slots are round-robin-scattered across
the nodes, and each node signs ONE locally-aggregated signature over
all its slots — ``PrivateKeys.sign_hash_aggregated``):

* levels define the **emission and timeout schedule**, not a strict
  partition of which bits a contribution may carry — a node's very
  first contribution already covers slots scattered over the whole
  index range, which only *accelerates* assembly;
* contributions are **self-certifying**: (phase, bitmap, aggregate
  sig) verified against the committee table — there is no sender
  signature to check.  A forged partial fails the aggregate pairing
  check and is never merged; a replayed valid one is byte-identical
  and dedups free.

Verification rides the sched CONSENSUS lane (the fused masked-sum +
pairing program, same path as :meth:`fbft.Validator._verify_proof`),
so partial-aggregate checks batch onto the device path with the
round's quorum proofs.

Merge rule (the ``Mask``/``bls.Sign.Add`` path):

* disjoint bitmaps  -> signatures add (BLS linearity), bitmaps OR;
* overlapping       -> keep whichever verified aggregate carries the
  most bits (adding would double-count the overlap's signatures);
* no new bits       -> dropped for free, before any pairing work.

Pending contributions are scored highest-new-weight-first and only a
bounded number are verified per tick, so a flood of junk partials
costs bounded pairing work per round, not unbounded.
"""

from __future__ import annotations

import threading

from .. import bls as B
from ..ref import bls as RB
from .mask import Mask
from .messages import encode_sig_and_bitmap

# wire phase discriminants (consensus.messages.encode_aggregation)
PHASE_PREPARE = 1
PHASE_COMMIT = 2
PHASE_NAMES = {PHASE_PREPARE: "prepare", PHASE_COMMIT: "commit"}

MAX_PENDING = 64   # queued unverified contributions per phase
MAX_SEEN = 4096    # byte-identical dedup window per phase


def num_levels(n: int) -> int:
    """Height of the ladder for an ``n``-slot committee: ceil(log2 n),
    minimum 1 (even a 1-slot committee has the final leader emission)."""
    return max(1, (n - 1).bit_length())


def level_peers(slot: int, level: int, n: int) -> list:
    """Slot indices ``slot`` emits to at ``level`` (Handel's binomial
    partition, arXiv:1906.05132 §4.1): the OTHER half of the
    2**level-wide block containing ``slot``, clipped to the committee."""
    half = 1 << (level - 1)
    base = (slot >> level) << level
    if slot & half:
        lo, hi = base, base + half
    else:
        lo, hi = base + half, base + 2 * half
    return list(range(lo, min(hi, n)))


def level_span(slot: int, level: int, n: int) -> tuple:
    """[lo, hi) of slots a COMPLETE level-``level`` merge covers for
    ``slot`` — all bits present means the level finished early."""
    base = (slot >> level) << level
    return base, min(base + (1 << level), n)


def _popcount(x: int) -> int:
    return x.bit_count() if hasattr(x, "bit_count") else bin(x).count("1")


class _PhaseState:
    """One phase's (prepare/commit) assembly state."""

    __slots__ = (
        "active", "payload", "sig", "bits", "pending", "seen",
        "level", "level_started", "last_emit", "last_emit_bits",
        "emit_cursor", "seeded_at", "fallback", "fallback_taken",
        "final_sent",
    )

    def __init__(self):
        self.active = False
        self.payload = b""
        self.sig = None       # best verified aggregate (bls.Signature)
        self.bits = 0         # its bitmap, bit i = committee slot i
        self.pending = []     # [(bits, sig_bytes, frm, level)]
        self.seen = set()     # byte-identical dedup
        self.level = 1
        self.level_started = 0.0
        self.last_emit = 0.0
        self.last_emit_bits = -1
        self.emit_cursor = 0
        self.seeded_at = 0.0
        self.fallback = None       # stashed direct vote (opaque)
        self.fallback_taken = False
        self.final_sent = 0        # quorum emissions to the leader


class Aggregator:
    """Per-round aggregation overlay participant.

    ``emit(target_slot, phase, level, bitmap_bytes, sig_bytes)`` is the
    transport hook — the node publishes to the target slot's directed
    aggregation topic.  ``quorum_check(bit_vector)`` is the decider's
    stake-weighted mask predicate, injected so the overlay never
    re-implements quorum arithmetic.  All bitmap ints use the ``Mask``
    bit order (bit ``i`` of the little-endian byte string = slot ``i``),
    so ``int.to_bytes(..., "little")`` round-trips mask bytes exactly.
    """

    def __init__(self, committee: list, home_slots: list, quorum_check,
                 emit, leader_slot: int = 0, *, is_leader: bool = False,
                 committee_points: list | None = None,
                 level_timeout_s: float = 0.6, reemit_s: float = 0.25,
                 fanout: int = 2, max_verifies_per_tick: int = 2,
                 stall_timeout_s: float = 2.0):
        if not home_slots:
            raise ValueError("aggregator needs at least one home slot")
        self.committee = list(committee)
        self.n = len(self.committee)
        self.mask_len = (self.n + 7) >> 3
        self.committee_points = committee_points or [
            B.PublicKey.from_bytes(k).point for k in self.committee
        ]
        self.home_slots = sorted(home_slots)
        self.home = self.home_slots[0]
        self.home_set = set(self.home_slots)
        self.quorum_check = quorum_check
        self.emit = emit
        self.leader_slot = leader_slot
        self.is_leader = is_leader
        self.level_timeout_s = level_timeout_s
        self.reemit_s = reemit_s
        self.fanout = fanout
        self.max_verifies_per_tick = max_verifies_per_tick
        self.stall_timeout_s = stall_timeout_s
        self.n_levels = num_levels(self.n)
        self.phases = {
            PHASE_PREPARE: _PhaseState(), PHASE_COMMIT: _PhaseState(),
        }
        # observability (read by the node's metrics + chaos invariants)
        self.inbound = 0       # non-duplicate contributions accepted
        self.merged = 0        # verified contributions absorbed
        self.dup_dropped = 0   # byte-identical replays
        self.stale_dropped = 0  # zero-new-weight, dropped pre-verify
        self.forged = 0        # failed the aggregate pairing check
        self.emissions = 0     # contributions sent up the ladder
        self.fallbacks = 0     # phases that fell back to direct votes
        self._lock = threading.Lock()

    # -- intake --------------------------------------------------------------

    def seed(self, phase: int, payload: bytes, bits: int, sig,
             fallback=None, now: float = 0.0):
        """Activate a phase with this node's own (trusted) contribution:
        the locally-signed aggregate over its home slots.  ``fallback``
        is the already-built direct vote message, stashed for the stall
        path.  Idempotent per phase; a re-seed only refreshes state that
        is still unset.

        Single-mutator discipline (holds for every state writer here:
        seed / merge_verified / tick all run on the consensus pump
        thread; the gossip thread only enqueues): the BLS work happens
        lock-free and ``_lock`` just fences the state commit for
        cross-thread readers (stats, proof, quorum)."""
        st = self.phases[phase]
        if st.sig is None:
            new_sig, new_bits = sig, bits
        else:
            new = self._merged(st.sig, st.bits, bits, sig)
            new_sig, new_bits = new if new else (st.sig, st.bits)
        with self._lock:
            st.payload = payload
            st.sig, st.bits = new_sig, new_bits
            if not st.active:
                st.active = True
                st.seeded_at = st.level_started = now
            if st.fallback is None:
                st.fallback = fallback

    def on_contribution(self, phase: int, level: int, bitmap: bytes,
                        sig_bytes: bytes, frm: str = "") -> str:
        """Queue one inbound partial aggregate.  Returns a verdict
        string for the caller's accounting: ``queued`` / ``dup`` /
        ``stale`` / ``malformed``.  No pairing work happens here —
        verification is deferred to :meth:`tick`'s scored budget."""
        st = self.phases.get(phase)
        if st is None or len(bitmap) != self.mask_len:
            return "malformed"
        with self._lock:
            key = bitmap + sig_bytes
            if key in st.seen:
                self.dup_dropped += 1
                return "dup"
            if len(st.seen) >= MAX_SEEN:
                st.seen.clear()  # bounded window; a replay after a
                #                  clear re-verifies, never re-merges
            st.seen.add(key)
            bits = int.from_bytes(bitmap, "little")
            if bits == 0 or bits >> self.n:
                return "malformed"
            self.inbound += 1
            if st.active and not (bits & ~st.bits):
                self.stale_dropped += 1
                return "stale"
            if len(st.pending) >= MAX_PENDING:
                # evict the lowest-new-weight entry; ties evict oldest
                worst = min(
                    range(len(st.pending)),
                    key=lambda i: _popcount(st.pending[i][0] & ~st.bits),
                )
                st.pending.pop(worst)
            st.pending.append((bits, sig_bytes, frm, level))
            return "queued"

    def merge_verified(self, phase: int, bits: int, sig):
        """Absorb an ALREADY-verified aggregate (the leader's direct
        fallback ballots arrive through fbft's own pairing check — no
        second verify).  Pump thread only; see :meth:`seed`."""
        st = self.phases[phase]
        if st.sig is None:
            new = (sig, bits)
        else:
            new = self._merged(st.sig, st.bits, bits, sig) \
                or (st.sig, st.bits)
        with self._lock:
            st.sig, st.bits = new

    # -- merge ---------------------------------------------------------------

    def _merged(self, cur_sig, cur_bits: int, bits: int, sig):
        """Pure merge computation — no locks held around the BLS add
        (it takes the native backend's own lock).  Returns the merged
        ``(sig, bits)`` or None when the contribution adds nothing."""
        if not (bits & ~cur_bits):
            return None
        if not (bits & cur_bits):
            return B.aggregate_sigs([cur_sig, sig]), cur_bits | bits
        if _popcount(bits) > _popcount(cur_bits):
            # overlapping aggregates cannot add (the overlap's
            # signatures would count twice against a single mask bit);
            # keep the heavier verified aggregate wholesale
            return sig, bits
        return None

    def _verify(self, payload: bytes, bits: int, sig_bytes: bytes):
        """The partial-aggregate pairing check — the exact shape of
        ``fbft.Validator._verify_proof``, minus the quorum gate (a
        partial is honest long before quorum): device path runs the
        fused masked-sum + pairing program on the CONSENSUS lane."""
        from .. import device as DV

        try:
            mask = Mask(self.committee_points)
            mask.set_mask(bits.to_bytes(self.mask_len, "little"))
            sig = B.Signature.from_bytes(sig_bytes)
        except ValueError:
            return None
        if DV.device_enabled():
            from .. import sched

            table = DV.get_committee_table(
                self.committee, self.committee_points
            )
            ok = sched.agg_verify(
                table, mask.bit_vector(), payload, sig.point,
                lane=sched.Lane.CONSENSUS,
            )
        else:
            agg_pk = mask.aggregate_public(device=False)
            ok = agg_pk is not None and RB.verify(
                agg_pk, payload, sig.point
            )
        return sig if ok else None

    # -- drive ---------------------------------------------------------------

    def tick(self, phase: int, now: float):
        """One scheduling step: verify the best-scored pending
        contributions (bounded), escalate the level ladder on
        completion or timeout, re-emit the current best on schedule.
        Returns a work dict (for span attribution) or None when the
        phase is idle."""
        st = self.phases[phase]
        if not st.active or st.sig is None:  # pump-thread read; the
            return None  #                     pump is the only writer
        work = {
            "verified": 0, "merged": 0, "forged": 0, "emitted": 0,
            "forged_from": [],
        }
        budget = self.max_verifies_per_tick
        while budget > 0:
            # pop the best-scored candidate under the lock; pairing
            # and BLS adds run OUTSIDE it (they take the sched/device
            # and native-backend locks — nesting ours around those is
            # the lock-order debt GL05 polices)
            with self._lock:
                st.pending.sort(
                    key=lambda p: _popcount(p[0] & ~st.bits),
                    reverse=True,
                )
                while st.pending and not (st.pending[-1][0] & ~st.bits):
                    st.pending.pop()  # zero-gain tail: free drops
                    self.stale_dropped += 1
                if not st.pending:
                    break
                bits, sig_bytes, frm, _lvl = st.pending.pop(0)
            budget -= 1
            work["verified"] += 1
            sig = self._verify(st.payload, bits, sig_bytes)
            if sig is None:
                # forged partial: rejected by verification, never
                # merged; the sender feeds the peer-score ladder
                with self._lock:
                    self.forged += 1
                work["forged"] += 1
                if frm:
                    work["forged_from"].append(frm)
                continue
            merged = self._merged(st.sig, st.bits, bits, sig)
            if merged is not None:
                with self._lock:
                    st.sig, st.bits = merged
                    self.merged += 1
                work["merged"] += 1
        with self._lock:
            # ladder escalation: a completed span advances immediately,
            # a timed-out level advances anyway (loss tolerance)
            while st.level <= self.n_levels:
                lo, hi = level_span(self.home, st.level, self.n)
                span = ((1 << (hi - lo)) - 1) << lo
                if (st.bits & span) == span:
                    st.level += 1
                    st.level_started = now
                    st.emit_cursor = 0
                elif now - st.level_started >= self.level_timeout_s:
                    st.level += 1
                    st.level_started = now
                    st.emit_cursor = 0
                else:
                    break
            work["level"] = min(st.level, self.n_levels + 1)
            # emission: new content goes out at the fast cadence; an
            # UNCHANGED best contribution only heartbeats at the slow
            # one (re-emission exists for loss recovery — on a clean
            # link it would just pad the receiver's inbound count)
            interval = self.reemit_s if st.bits != st.last_emit_bits \
                else max(4 * self.reemit_s, self.level_timeout_s)
            if st.last_emit and now - st.last_emit < interval:
                return work
            st.last_emit = now
            st.last_emit_bits = st.bits
            bitmap = st.bits.to_bytes(self.mask_len, "little")
            sig_b = st.sig.bytes
            at_quorum = bool(self.quorum_check(self._bit_vector(st.bits)))
            if at_quorum or st.level > self.n_levels:
                # final rung: ship the best aggregate straight to the
                # leader (re-sent on the same cadence — loss safety)
                if not self.is_leader:
                    targets = [self.leader_slot]
                    st.final_sent += 1
                else:
                    targets = []
            else:
                peers = [
                    p for p in level_peers(self.home, st.level, self.n)
                    if p not in self.home_set
                ]
                targets = []
                for _ in range(min(self.fanout, len(peers))):
                    targets.append(peers[st.emit_cursor % len(peers)])
                    st.emit_cursor += 1
        for t in targets:
            self.emit(t, phase, work["level"], bitmap, sig_b)
            work["emitted"] += 1
        with self._lock:
            self.emissions += work["emitted"]
        return work

    # -- read side -----------------------------------------------------------

    def _bit_vector(self, bits: int):
        m = Mask(self.committee_points)
        m.set_mask(bits.to_bytes(self.mask_len, "little"))
        return m.bit_vector()

    def quorum(self, phase: int) -> bool:
        st = self.phases[phase]
        with self._lock:
            if not st.active or st.sig is None:
                return False
            bits = st.bits
        return bool(self.quorum_check(self._bit_vector(bits)))

    def proof(self, phase: int) -> bytes | None:
        """``[96B aggregate sig || bitmap]`` — the exact quorum-proof
        payload ``fbft.Leader._quorum_proof`` builds, assembled from
        the overlay instead of the ballot store."""
        st = self.phases[phase]
        with self._lock:
            if st.sig is None:
                return None
            return encode_sig_and_bitmap(
                st.sig.bytes, st.bits.to_bytes(self.mask_len, "little")
            )

    def signed_count(self, phase: int) -> int:
        with self._lock:
            return _popcount(self.phases[phase].bits)

    def active_phases(self) -> list:
        with self._lock:
            return [p for p, st in self.phases.items() if st.active]

    # -- fallback ------------------------------------------------------------

    def stalled(self, now: float) -> list:
        """Phases that have been assembling past the stall budget
        without quorum — the node broadcasts their stashed direct votes
        (today's exact path), so the overlay can only add, never cost,
        liveness."""
        out = []
        with self._lock:
            for p, st in self.phases.items():
                if (
                    st.active and not st.fallback_taken
                    and st.fallback is not None
                    and now - st.seeded_at >= self.stall_timeout_s
                ):
                    out.append(p)
        return [p for p in out if not self.quorum(p)]

    def take_fallback(self, phase: int):
        """One-shot: the stashed direct vote, then never again."""
        with self._lock:
            st = self.phases[phase]
            if st.fallback_taken or st.fallback is None:
                return None
            st.fallback_taken = True
            self.fallbacks += 1
            return st.fallback
