"""Staged sync: heads -> hashes -> bodies -> verify+insert.

The role of the reference's staged stream sync (reference:
api/service/stagedstreamsync — Downloader loop over stages
heads/blockhashes/bodies/states in default_stages.go, then
verifyAndInsertBlocks in sig_verify.go:23 — SURVEY.md §3.3): find the
network head across peers, agree on the hash chain (majority across
queried peers), fetch bodies in windows, and insert through
Blockchain.insert_chain — where ALL commit-signature checks for a
window run as one batched device program (the replay throughput path,
BASELINE config #5; the reference verifies block-by-block through cgo).

The port's copy of the JAX package's ``sync/staged.py``.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field

from ..log import get_logger
from ..metrics import Counter as _MetricCounter
from ..obs.replay import stage as replay_stage
from ..resilience import Deadline

BATCH = 64  # blocks per fetch/verify window

_log = get_logger("sync")

SNAPSHOT_BOOTSTRAPS = _MetricCounter(
    "harmony_snapshot_bootstrap_total",
    "late-join snapshot bootstrap attempts, by outcome",
)
SNAPSHOT_BYTES = _MetricCounter(
    "harmony_snapshot_bytes_total",
    "account bytes installed via snapshot bootstrap",
)


@dataclass
class SyncResult:
    inserted: int = 0
    target: int = 0
    errors: list = field(default_factory=list)

    @property
    def caught_up(self) -> bool:
        return not self.errors


class Downloader:
    def __init__(self, chain, clients: list, batch: int = BATCH,
                 verify_seals: bool = True,
                 request_deadline_s: float | None = None,
                 snapshot_threshold: int | None = None):
        """clients: [SyncClient] — one per serving peer.  verify_seals
        routes through the chain engine's batched pairing check; False
        only for chains whose proofs were already consensus-verified.

        request_deadline_s bounds EVERY peer request (tighter than the
        stream's own 30 s default); a peer that times out or errors
        mid-stage is EXCLUDED for the rest of the pass and the stage
        completes from the remaining peers — one black-holed peer costs
        one deadline, not one deadline per window.

        snapshot_threshold: when set and a sync pass finds this node
        ``>= threshold`` blocks behind the network head, the pass first
        bootstraps from a peer-served state snapshot (paged download,
        root-verified, atomically installed) and only replays the tail
        — the late-join path.  None (the default) keeps the classic
        full-replay behavior."""
        self.chain = chain
        self.clients = list(clients)
        self.batch = batch
        self.verify_seals = verify_seals
        self.request_deadline_s = request_deadline_s
        self.snapshot_threshold = snapshot_threshold
        # late-join bootstrap telemetry (the chaos runner and the BENCH
        # ledger read these)
        self.snapshot_bootstraps = 0
        self.last_snapshot_bootstrap_s: float | None = None
        self.last_snapshot_block: int | None = None
        self._excluded: set = set()  # id(client), reset per pass
        self._lat: dict[int, float] = {}  # id(client) -> EWMA seconds

    def _deadline(self) -> Deadline | None:
        if self.request_deadline_s is None:
            return None
        return Deadline.after(self.request_deadline_s)

    def _window(self) -> int:
        """Effective fetch/verify window: the configured batch, shrunk
        by the resource governor's tier (PRESSURED x1/2, CRITICAL x1/4
        — catch-up keeps moving under overload, in smaller bites that
        hold less memory and yield the device queue sooner)."""
        from .. import governor as GV

        scale = GV.sync_window_scale()
        if scale >= 1.0:
            return self.batch
        # floor of 8 keeps catch-up moving, but never ABOVE the
        # operator's configured batch — pressure must not enlarge the
        # window for small-batch downloaders
        return min(self.batch, max(8, int(self.batch * scale)))

    _EWMA_ALPHA = 0.3  # smoothing for per-peer response latency

    def _note_latency(self, client, elapsed_s: float) -> None:
        prev = self._lat.get(id(client))
        self._lat[id(client)] = (
            elapsed_s if prev is None
            else prev + self._EWMA_ALPHA * (elapsed_s - prev)
        )

    def _call(self, client, fn, *args, **kw):
        """One peer request, feeding the latency EWMA on success
        (failures route through ``_exclude`` at the call sites)."""
        t0 = time.monotonic()
        out = fn(*args, **kw)
        self._note_latency(client, time.monotonic() - t0)
        return out

    def _peers(self) -> list:
        """Healthy peers, FASTEST FIRST: ordered by EWMA response
        latency (unmeasured peers sort ahead at 0, in configured
        order — the sort is stable).  Without the ordering, a
        drip-feeding peer that answers just under the request deadline
        every window wins every ``_fetch_window`` race forever — the
        configured-order scan always reached it first, and 'healthy'
        was binary.  Exclusion stays per-pass: slow is deprioritized,
        dead is excluded."""
        return sorted(
            (c for c in self.clients if id(c) not in self._excluded),
            key=lambda c: self._lat.get(id(c), 0.0),
        )

    def _exclude(self, client, stage: str, err) -> None:
        self._excluded.add(id(client))
        _log.warn(
            "sync peer excluded for this pass", stage=stage,
            peer=getattr(client, "peer_key", "?"), error=str(err),
            remaining=len(self._peers()),
        )

    # -- stage: heads -------------------------------------------------------

    def network_head(self) -> int:
        """Highest head any peer advertises (short-range trust model:
        the commit-sig verification below is what actually gates)."""
        best = self.chain.head_number
        for c in self._peers():
            try:
                head, _ = self._call(
                    c, c.get_head, deadline=self._deadline()
                )
                best = max(best, head)
            except (ConnectionError, OSError) as e:
                self._exclude(c, "heads", e)
                continue
        return best

    # -- stage: hash agreement ---------------------------------------------

    def agreed_hashes(self, start: int, count: int) -> list:
        """Per-height majority hash across peers (the reference's
        stage_short_range cross-peer consistency check)."""
        votes: list[Counter] = [Counter() for _ in range(count)]
        for c in self._peers():
            try:
                hashes = self._call(
                    c, c.get_block_hashes, start, count,
                    deadline=self._deadline(),
                )
            except (ConnectionError, OSError) as e:
                self._exclude(c, "hashes", e)
                continue
            for i, h in enumerate(hashes[:count]):
                votes[i][h] += 1
        out = []
        for counter in votes:
            if not counter:
                break
            out.append(counter.most_common(1)[0][0])
        return out

    # -- stage: bodies + insert --------------------------------------------

    def _fetch_window(self, start: int, count: int, want_hashes: list):
        """Try peers in order until one serves blocks matching the
        agreed hashes."""
        # the whole window fetch — peer round-trip, body decode, hash
        # re-check — is the wire_decode stage of the replay burn-down
        with replay_stage("wire_decode", start=start, count=count):
            for c in self._peers():
                try:
                    items = self._call(
                        c, c.get_blocks_by_number, start, count,
                        deadline=self._deadline(),
                    )
                except (ConnectionError, OSError) as e:
                    self._exclude(c, "bodies", e)
                    continue
                if not items:
                    continue
                ok = all(
                    blk.hash() == want
                    for (blk, _), want in zip(items, want_hashes)
                )
                if ok:
                    return items
            return []

    # -- stages: fast (state) sync -----------------------------------------

    def _download_state(self, num: int):
        """Account-range paging (reference: client.go GetAccountRange →
        the states stage): assemble the full flat account set of the
        remote state at block ``num``."""
        from ..core.state import StateDB, _decode_account

        accounts = {}
        # generous sanity bound on total pages: a state bigger than
        # this is not something fast sync should swallow silently
        max_pages = int(1e6)
        for c in self._peers():
            try:
                start = b""
                for _ in range(max_pages):
                    page = self._call(
                        c, c.get_account_range, num, start,
                        deadline=self._deadline(),
                    )
                    if not page:
                        break
                    # progress guard: a peer repeating or
                    # rewinding pages would make `start` a fixed point
                    # and spin this loop forever — treat it as a bad
                    # peer and rotate
                    if page[-1][0] <= start:
                        raise ConnectionError(
                            "non-advancing account-range page"
                        )
                    for addr, blob in page:
                        accounts[addr] = _decode_account(blob)
                    start = page[-1][0]
                else:
                    raise ConnectionError("account-range page bound hit")
                return StateDB(accounts)
            except (ConnectionError, OSError) as e:
                self._exclude(c, "states", e)
                accounts.clear()
                continue
        return None

    def fast_sync(self, receipts_tail: int = BATCH) -> SyncResult:
        """Join at the head WITHOUT replaying execution (reference:
        api/service/stagedstreamsync default_stages.go — heads →
        hashes → bodies → states → receipts): download seal-verified
        blocks, then the account set of the head state (bound to the
        sealed state root in adopt_state), then receipts for the
        recent tail so tx-facing RPCs answer."""
        self._excluded.clear()  # every peer gets a fresh chance per pass
        res = SyncResult(target=self.network_head())
        head = self.chain.head_number
        if res.target <= head:
            return res
        _log.info("fast sync start", head=head, target=res.target)
        # stage: bodies (state-less, seal-verified, head unmoved).
        # Committees are NOT fetched from peers: insert_headers_fast
        # harvests each next epoch's committee from the sealed
        # election headers themselves, so the seal-verification trust
        # chain runs unbroken from the local head to the target
        # (a peer serving forged epoch states cannot influence it)
        num = head + 1
        last_inserted = head
        while num <= res.target:
            count = min(self._window(), res.target - num + 1)
            hashes = self.agreed_hashes(num, count)
            if not hashes:
                res.errors.append(f"no hash agreement at {num}")
                return res
            items = self._fetch_window(num, len(hashes), hashes)
            if not items:
                res.errors.append(f"no peer served window at {num}")
                return res
            try:
                self.chain.insert_headers_fast(
                    [b for b, _ in items], [s for _, s in items],
                    verify_seals=self.verify_seals,
                )
            except ValueError as e:
                res.errors.append(f"fast insert failed at {num}: {e}")
                return res
            last_inserted = items[-1][0].block_num
            num = last_inserted + 1
        # stage: states — bind the downloaded accounts to the sealed root
        state = self._download_state(last_inserted)
        if state is None:
            res.errors.append("no peer served the account range")
            return res
        try:
            self.chain.adopt_state(last_inserted, state)
        except ValueError as e:
            res.errors.append(f"state adoption failed: {e}")
            return res
        res.inserted = last_inserted - head
        # stage: receipts — recent tail only (older blocks stay
        # header-only, as after a snap sync).  Every downloaded list is
        # verified against the sealed header's receipt_root BEFORE
        # persisting (an unverified receipts stage lets a
        # sync peer forge statuses/logs/contract addresses that
        # eth_getTransactionReceipt would then serve as truth).
        from ..core.types import receipts_root as _rroot

        lo = max(head + 1, last_inserted - receipts_tail + 1)
        for c in self._peers():
            try:
                per_block = self._call(
                    c, c.get_receipts, lo, last_inserted - lo + 1,
                    deadline=self._deadline(),
                )
            except (ConnectionError, OSError) as e:
                self._exclude(c, "receipts", e)
                continue
            verified = []
            for i, receipts in enumerate(per_block):
                if not receipts:
                    continue
                hdr = self.chain.header_by_number(lo + i)
                if hdr is None or _rroot(receipts) != hdr.receipt_root:
                    res.errors.append(
                        f"receipts commitment mismatch at {lo + i}"
                    )
                    verified = None
                    break
                verified.append((lo + i, receipts))
            if verified is None:
                continue  # forged/buggy receipts: rotate peer
            for n, receipts in verified:
                self.chain.write_synced_receipts(n, receipts)
            break
        _log.info(
            "fast sync done", head=self.chain.head_number,
            inserted=res.inserted,
        )
        return res

    # -- stage: snapshot bootstrap (late join) ------------------------------

    def _fetch_epoch_state(self, epoch: int):
        """Majority-agreed shard state for ``epoch`` across peers (the
        same trust base as agreed_hashes): the committee a late joiner
        needs to seal-verify its replay tail, since the election blocks
        that elected it are not replayed through a snapshot."""
        from ..core import rawdb

        votes: Counter = Counter()
        decoded: dict[bytes, object] = {}
        for c in self._peers():
            try:
                st = self._call(
                    c, c.get_epoch_state, epoch,
                    deadline=self._deadline(),
                )
            except (ConnectionError, OSError) as e:
                self._exclude(c, "epoch-state", e)
                continue
            if st is None:
                continue
            enc = rawdb.encode_shard_state(st)
            votes[enc] += 1
            decoded[enc] = st
        if not votes:
            return None
        return decoded[votes.most_common(1)[0][0]]

    def _download_snapshot_pages(self, first_peer, num: int,
                                 n_pages: int, state_len: int):
        """All pages of the snapshot at block ``num``, resumable: a
        page that fails on one peer retries on the others at the SAME
        index (pages are canonical slices of one sealed serialization,
        so any peer still serving that block continues the download).
        Returns (total_account_count, [page bytes]) or None."""
        parts: list[bytes] = []
        total_accounts = 0
        total_bytes = 0
        for idx in range(n_pages):
            page = None
            peers = [first_peer] + [
                c for c in self._peers() if c is not first_peer
            ]
            for c in peers:
                if id(c) in self._excluded:
                    continue
                try:
                    page = self._call(
                        c, c.get_snapshot_page, num, idx,
                        deadline=self._deadline(),
                    )
                    break
                except (ConnectionError, OSError, ValueError) as e:
                    self._exclude(c, "snapshot", e)
                    continue
            if page is None:
                return None  # no peer serves this page any more
            count, payload = page
            total_accounts += count
            total_bytes += len(payload)
            if total_bytes > state_len:
                # the pages exceed what the meta promised: hostile or
                # inconsistent serving — abandon this snapshot
                return None
            parts.append(payload)
        return total_accounts, parts

    def _snapshot_bootstrap(self, target: int) -> bool:
        """Install a peer-served snapshot as the new local head.  Trust
        chain: the snapshot header's hash must match the per-height
        PEER MAJORITY (agreed_hashes — the same cross-peer check every
        staged window gets), and the accounts must hash to that
        header's sealed state root (install_snapshot).  Returns True
        when the local head moved."""
        from ..core import rawdb
        from ..core.snapshot import SnapshotError, install_snapshot

        t0 = time.monotonic()
        for c in self._peers():
            try:
                meta = self._call(
                    c, c.get_snapshot_meta, deadline=self._deadline(),
                )
            except (ConnectionError, OSError, ValueError) as e:
                self._exclude(c, "snapshot", e)
                continue
            if meta is None:
                continue
            num, n_pages, state_len, header_blob, proof = meta
            if num <= self.chain.head_number or num > target:
                continue  # stale or past-the-horizon snapshot
            try:
                header = rawdb.decode_header(header_blob)
            except (ValueError, IndexError) as e:
                self._exclude(c, "snapshot", e)
                continue
            if header.block_num != num:
                self._exclude(c, "snapshot", "header/number mismatch")
                continue
            agreed = self.agreed_hashes(num, 1)
            if not agreed or agreed[0] != header.hash():
                SNAPSHOT_BOOTSTRAPS.inc(outcome="header_rejected")
                self._exclude(
                    c, "snapshot", "header not in the majority chain"
                )
                continue
            got = self._download_snapshot_pages(
                c, num, n_pages, state_len
            )
            if got is None:
                SNAPSHOT_BOOTSTRAPS.inc(outcome="pages_abandoned")
                continue
            total_accounts, parts = got
            blob = (total_accounts.to_bytes(4, "little")
                    + b"".join(parts))
            try:
                install_snapshot(self.chain, header, proof, blob)
            except (SnapshotError, ValueError) as e:
                SNAPSHOT_BOOTSTRAPS.inc(outcome="install_failed")
                self._exclude(c, "snapshot", e)
                continue
            # the committee context the replay tail will verify seals
            # against: elections inside the snapshot's past are not
            # replayed, so their outcome is fetched (majority-agreed)
            epoch = self.chain.epoch_of(num)
            for ep in {epoch, epoch + 1}:
                if rawdb.read_shard_state(self.chain.db, ep) is None:
                    st = self._fetch_epoch_state(ep)
                    if st is not None:
                        rawdb.write_shard_state(self.chain.db, ep, st)
                        self.chain._committee_cache.pop(ep, None)
            self.snapshot_bootstraps += 1
            self.last_snapshot_bootstrap_s = time.monotonic() - t0
            self.last_snapshot_block = num
            SNAPSHOT_BOOTSTRAPS.inc(outcome="done")
            SNAPSHOT_BYTES.inc(len(blob))
            _log.info(
                "snapshot bootstrap done", block=num, pages=n_pages,
                accounts=total_accounts,
                seconds=round(self.last_snapshot_bootstrap_s, 3),
            )
            return True
        return False

    def sync_once(self) -> SyncResult:
        """One pass to the current network head."""
        self._excluded.clear()  # every peer gets a fresh chance per pass
        res = SyncResult(target=self.network_head())
        behind = res.target - self.chain.head_number
        if (self.snapshot_threshold is not None
                and behind >= self.snapshot_threshold):
            head0 = self.chain.head_number
            if self._snapshot_bootstrap(res.target):
                res.inserted += self.chain.head_number - head0
            # bootstrap failure is not a pass failure: the classic
            # replay below still makes progress, just slowly
        if res.target > self.chain.head_number:
            _log.info(
                "sync start", head=self.chain.head_number,
                target=res.target, peers=len(self.clients),
            )
        while self.chain.head_number < res.target:
            start = self.chain.head_number + 1
            count = min(self._window(),
                        res.target - self.chain.head_number)
            hashes = self.agreed_hashes(start, count)
            if not hashes:
                res.errors.append(f"no hash agreement at {start}")
                break
            items = self._fetch_window(start, len(hashes), hashes)
            if not items:
                res.errors.append(f"no peer served window at {start}")
                break
            blocks = [blk for blk, _ in items]
            sigs = [sig for _, sig in items]
            try:
                res.inserted += self.chain.insert_chain(
                    blocks, sigs, verify_seals=self.verify_seals
                )
            except ValueError as e:
                res.errors.append(f"insert failed at {start}: {e}")
                break
        if res.inserted or res.errors:
            _log.info(
                "sync pass done", inserted=res.inserted,
                head=self.chain.head_number, errors=len(res.errors),
            )
        return res
