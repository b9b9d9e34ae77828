"""Durable consensus safety state: the last vote each key signed.

The double-sign hazard this closes: FBFT keeps its
"have I already voted this round" state in memory
(``Node._announce_voted``), so a validator hard-killed after casting a
prepare vote and restarted from disk remembers NOTHING — an
equivocating (or merely re-proposing) leader could then extract a
second signature for a DIFFERENT block at the same (height, view), the
exact evidence ``Node._check_double_sign`` slashes others for
(reference: consensus/double_sign.go — equivocation IS same
height+view, different hash).

:class:`SafetyStore` persists two durable records per local BLS key
through the node's shard DB, written BEFORE the signature leaves the
node and reloaded on restart:

* the **vote record** (``rawdb V || pubkey``): the last
  (block_num, view_id, phase, block_hash) PREPARE/COMMIT signed.
  The rules (``may_sign``): never sign below the recorded height
  (only an operator revert regresses the head — conservative refuse),
  and at the exact recorded (height, view) only ever re-sign the SAME
  block hash.  Votes at OTHER views of the same height are allowed —
  that is ordinary FBFT view churn, not equivocation, and refusing it
  wedges liveness (a NEWVIEW quorum can legitimately form at a lower
  view than a node's last escalated view-change vote; the rolling-
  restart chaos scenario found exactly that wedge: every validator
  withheld its vote in every adopted view and the committee never
  committed again).
* the **view-change watermark** (``rawdb W || pubkey``): the highest
  view a VIEWCHANGE was signed for at the height.  Never gates votes;
  it exists so a RESTARTED node fast-forwards its first round to
  where it had already escalated (``min_view``, applied once at node
  construction) instead of re-entering the storm from view 1.

Durability: records flush through ``db.flush()`` when the backing
store's fsync policy says batches are durable — on the in-process
chaos topology (kill = thread stop, OS page cache survives) the
unbuffered write alone already survives the kill.

The port's copy of the JAX package's ``consensus/safety.py``.
"""

from __future__ import annotations

import threading

from ..core import rawdb

PHASE_PREPARE = 1
PHASE_COMMIT = 2
PHASE_VIEWCHANGE = 3


class SafetyStore:
    def __init__(self, db):
        self.db = db
        self._votes: dict[bytes, tuple] = {}
        self._marks: dict[bytes, tuple] = {}  # vc watermark per key
        self._lock = threading.Lock()
        # flush per record only when the store is configured durable
        # (FileKV/NativeKV fsync="batch"/"always"); MemKV and
        # fsync="none" stores skip the syscall
        self._durable = getattr(db, "fsync", "none") != "none"
        self.refused = 0  # votes withheld by the safety rules

    def last(self, pubkey: bytes):
        """Last signed vote (block_num, view_id, phase, block_hash)
        for ``pubkey``, memory-cached over the durable record."""
        with self._lock:
            rec = self._votes.get(pubkey)
        if rec is None:
            rec = rawdb.read_last_signed(self.db, pubkey)
            if rec is not None:
                with self._lock:
                    self._votes[pubkey] = rec
        return rec

    def watermark(self, pubkey: bytes):
        """Highest (block_num, view_id) a VIEWCHANGE was signed for."""
        with self._lock:
            mark = self._marks.get(pubkey)
        if mark is None:
            mark = rawdb.read_vc_watermark(self.db, pubkey)
            if mark is not None:
                with self._lock:
                    self._marks[pubkey] = mark
        return mark

    def min_view(self, block_num: int) -> int:
        """The highest view any of this node's keys actually VOTED at
        ``block_num``.  ``Node._new_round`` keeps its round view
        STRICTLY above this (voted view + 1): a view is never
        re-entered after voting in it, so the only way to meet "same
        (height, view), different hash" is genuine equivocation within
        one round visit.  The store keeps only the LAST vote per key,
        so re-entering an older view is inherently unsafe to allow —
        the memory of what was signed there may already be gone.

        Deliberately EXCLUDES the view-change watermark: VC votes
        escalate far ahead of any adopted view during a storm, and
        flooring on them strands nodes above every view where a
        NEWVIEW quorum can actually form."""
        floor = 0
        with self._lock:
            records = list(self._votes.values())
        for rec in records:
            if rec[0] == block_num:
                floor = max(floor, rec[1])
        return floor

    def restart_floor(self, block_num: int) -> int:
        """The view a RESTARTED node rejoins ``block_num`` at:
        strictly above its last vote, and at least its view-change
        watermark (rejoin the storm where it left off instead of from
        view 1).  Applied once at Node construction."""
        voted = self.min_view(block_num)
        floor = voted + 1 if voted else 0
        with self._lock:
            marks = list(self._marks.values())
        for mark in marks:
            if mark[0] == block_num:
                floor = max(floor, mark[1])
        return floor

    def load_keys(self, pubkeys) -> None:
        """Prime the cache from disk for this node's keys (restart
        path: ``min_view`` must see the durable records immediately,
        not after the first ``last()`` miss per key)."""
        for pk in pubkeys:
            self.last(pk)
            self.watermark(pk)

    def may_sign(self, pubkey: bytes, block_num: int, view_id: int,
                 phase: int, block_hash: bytes) -> bool:
        if phase == PHASE_VIEWCHANGE:
            return True  # VC signatures never equivocate on a block
        rec = self.last(pubkey)
        if rec is None:
            return True
        lb, lv, _lp, lh = rec
        if block_num != lb:
            return block_num > lb
        if view_id != lv:
            return True  # view churn at the same height is not
            # equivocation (and refusing it wedges NEWVIEW quorums
            # that form below this key's last escalated view)
        return block_hash == lh

    def record(self, pubkeys, block_num: int, view_id: int, phase: int,
               block_hash: bytes) -> bool:
        """Gate + persist one outgoing signature for ALL of this
        node's round keys.  Returns False (and persists nothing) if
        ANY key's rules refuse — the node withholds the whole vote.
        On True, every key's record is durably updated BEFORE the
        caller broadcasts."""
        pubkeys = list(pubkeys)
        if not all(
            self.may_sign(pk, block_num, view_id, phase, block_hash)
            for pk in pubkeys
        ):
            self.refused += 1
            return False
        if phase == PHASE_VIEWCHANGE:
            for pk in pubkeys:
                mark = self.watermark(pk)
                if mark is None or (block_num, view_id) > mark:
                    rawdb.write_vc_watermark(
                        self.db, pk, block_num, view_id
                    )
                    with self._lock:
                        self._marks[pk] = (block_num, view_id)
        else:
            for pk in pubkeys:
                rawdb.write_last_signed(
                    self.db, pk, block_num, view_id, phase, block_hash
                )
            with self._lock:
                for pk in pubkeys:
                    self._votes[pk] = (
                        block_num, view_id, phase, block_hash
                    )
        if self._durable:
            self.db.flush()
        return True
