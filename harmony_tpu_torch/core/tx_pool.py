"""Mempool: executable/queued split, price-ordered, eviction-bounded.

The role of the reference's core/tx_pool.go (SURVEY.md §2.4).  The
reference's pool discipline, re-implemented:

- **pending/queue split** (tx_pool.go's pending vs queue maps): a tx
  is *executable* when its nonce sits in the gapless run starting at
  the sender's state nonce; everything above the gap is *queued*.
  Commits promote queued txs as gaps close (``drop_applied``).
- **admission** validates signature, shard binding, nonce floor,
  balance cover at max cost, and the gas-price floor; same-nonce
  replacement needs a >=10% price bump (PriceBump).
- **bounded slots** (AccountSlots/AccountQueue/GlobalSlots/
  GlobalQueue): per-sender and global caps for both tiers; under
  global pressure the CHEAPEST queued tx is evicted for a
  better-paying newcomer (underpriced newcomers are rejected).
- **lifetime eviction**: queued txs older than ``lifetime`` seconds
  are dropped by ``evict_stale`` (the reference's 3h queue lifetime).

Plain and staking transactions share the pool with a common queue
discipline (the reference keeps both in one pool as well).

The port's copy of the JAX package's ``core/tx_pool.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

PRICE_BUMP_PCT = 10          # reference: DefaultTxPoolConfig.PriceBump
ACCOUNT_SLOTS = 16           # executable txs per sender
ACCOUNT_QUEUE = 64           # queued txs per sender
GLOBAL_SLOTS = 4096          # executable txs total
GLOBAL_QUEUE = 1024          # queued txs total
QUEUE_LIFETIME = 3 * 3600.0  # seconds (reference: 3h)


class PoolError(ValueError):
    pass


@dataclass
class _Entry:
    tx: object
    sender: bytes
    is_staking: bool
    added_at: float
    local: bool = False  # RPC-submitted (journaled) vs gossip


class TxPool:
    def __init__(self, chain_id: int, shard_id: int, state_view,
                 cap: int | None = None, price_floor: int = 1,
                 lifetime: float = QUEUE_LIFETIME):
        """state_view() -> StateDB-like with nonce()/balance().

        ``cap``: legacy single-number bound; when given it overrides
        GLOBAL_SLOTS + GLOBAL_QUEUE combined."""
        self.chain_id = chain_id
        self.shard_id = shard_id
        self._state_view = state_view
        self.global_slots = cap if cap is not None else GLOBAL_SLOTS
        self.global_queue = 0 if cap is not None else GLOBAL_QUEUE
        self.price_floor = price_floor
        # overload knob: the resource governor raises this
        # on PRESSURED/CRITICAL tiers — the effective admission floor
        # is price_floor * _floor_mult, so cheap spam is refused in
        # O(1) while well-paying traffic still admits
        self._floor_mult = 1
        self.lifetime = lifetime
        # sender -> {nonce -> _Entry}
        self._by_sender: dict[bytes, dict[int, _Entry]] = {}
        self._count = 0
        self.evicted = 0
        # the pool is shared between the consensus pump and RPC server
        # threads (sendRawTransaction) — every public method locks
        self._lock = threading.RLock()
        self._journal = None  # open file handle once open_journal runs
        self._journal_path: str | None = None
        # admission ring for push subscribers (rpc/ws.py
        # newPendingTransactions): a tx that enters AND leaves the
        # pool between two polls must still be notified, so pushers
        # read this monotonic log instead of diffing snapshots
        self._add_seq = 0
        self._recent_adds: deque = deque(maxlen=4096)

    # -- tier classification -------------------------------------------------

    def _split_counts(self, state):
        """(executable, queued) totals under the current state."""
        execn = 0
        for sender, slots in self._by_sender.items():
            nonce = state.nonce(sender)
            while nonce in slots:
                execn += 1
                nonce += 1
        return execn, self._count - execn

    def _stats_unlocked(self):
        """(pending, queued) — the reference's Stats()."""
        return self._split_counts(self._state_view())

    def _sender_exec_count(self, state, sender) -> int:
        slots = self._by_sender.get(sender, {})
        nonce = state.nonce(sender)
        n = 0
        while nonce in slots:
            n += 1
            nonce += 1
        return n

    # -- admission ---------------------------------------------------------

    def _recover_sender(self, tx) -> bytes:
        """Signature recovery — the expensive, pure-CPU part of
        admission.  Callers hoist it OUT of the pool lock so gossip
        ingest and RPC submits don't serialize behind each other's
        ECDSA work."""
        try:
            return tx.sender(self.chain_id)
        except ValueError as e:
            raise PoolError(f"bad signature: {e}") from e

    @staticmethod
    def _verify_bls_pop(tx) -> None:
        """BLS proof-of-possession check for staking txs that register
        keys (create-validator's ``bls_key_sigs`` aligned with
        ``bls_keys``; edit-validator's ``add_bls_key_sig``): each key
        must have signed its own serialized bytes (the reference's
        staking_verifier.go VerifyBLSKeys).  Runs OUTSIDE the pool
        lock, submitted on the verification scheduler's INGRESS lane —
        a burst of staking submits coalesces into one fused device
        batch instead of each paying an inline pairing.  Raises
        PoolError on an invalid or mis-aligned proof.  Proof fields
        are OPT-IN on the wire: legacy txs without them still admit
        (the execution layer's rules are unchanged); a tx that carries
        them is held to them.  Txs without key material (delegate,
        undelegate, ...) pass untouched."""
        fields = getattr(tx, "fields", None)
        if not isinstance(fields, dict):
            return
        pairs = []  # (pubkey bytes, pop signature bytes)
        keys = fields.get("bls_keys")
        sigs = fields.get("bls_key_sigs")
        if keys and sigs is not None:
            if isinstance(keys, bytes):  # packed 48-byte keys
                keys = [keys[i:i + 48] for i in range(0, len(keys), 48)]
            if isinstance(sigs, bytes):  # packed 96-byte sigs
                sigs = [sigs[i:i + 96] for i in range(0, len(sigs), 96)]
            if len(sigs) != len(keys):
                raise PoolError("bls_key_sigs/bls_keys length mismatch")
            pairs.extend(zip(keys, sigs))
        added = fields.get("add_bls_key")
        pop = fields.get("add_bls_key_sig")
        if added is not None and pop is not None:
            pairs.append((added, pop))
        if not pairs:
            return
        from .. import bls as B
        from .. import sched

        # all proofs submitted before any is awaited: a multi-key
        # registration coalesces into one fused scheduler batch
        if not B.verify_proofs_of_possession(
            pairs, lane=sched.Lane.INGRESS
        ):
            raise PoolError("bad BLS key proof of possession")

    def _validate(self, tx, is_staking: bool,
                  sender: bytes | None = None) -> bytes:
        if sender is None:
            sender = self._recover_sender(tx)
        if tx.shard_id != self.shard_id:
            raise PoolError("wrong shard")
        state = self._state_view()
        if tx.nonce < state.nonce(sender):
            raise PoolError("nonce too low")
        if tx.gas_price < self.price_floor * self._floor_mult:
            if (self._floor_mult > 1
                    and tx.gas_price >= self.price_floor):
                # refused only by the governor's raised floor: count
                # it as a governed rejection, not ordinary underpricing
                from .. import governor as GV

                GV.count_rejection("txpool")
                raise PoolError(
                    "gas price below overload floor "
                    f"({self.price_floor * self._floor_mult})"
                )
            raise PoolError("gas price below floor")
        if is_staking:
            # delegated/self-staked amount must be covered up front
            moved = int(tx.fields.get("amount", 0))
        else:
            moved = tx.value
        cost = tx.gas_limit * tx.gas_price + moved
        if state.balance(sender) < cost:
            raise PoolError("insufficient balance for max cost")
        return sender

    def _evict_cheapest_queued(self, state, min_price: int) -> bool:
        """Drop the lowest-priced NON-executable tx if it pays less
        than ``min_price`` (the reference's pricedList eviction)."""
        worst = None  # (price, sender, nonce)
        for sender, slots in self._by_sender.items():
            exec_top = state.nonce(sender)
            while exec_top in slots:
                exec_top += 1
            for nonce, e in slots.items():
                if nonce >= exec_top and (
                    worst is None or e.tx.gas_price < worst[0]
                ):
                    worst = (e.tx.gas_price, sender, nonce)
        if worst is None or worst[0] >= min_price:
            return False
        del self._by_sender[worst[1]][worst[2]]
        if not self._by_sender[worst[1]]:
            del self._by_sender[worst[1]]
        self._count -= 1
        self.evicted += 1
        return True

    def _add_unlocked(self, tx, is_staking: bool = False,
                      sender: bytes | None = None) -> bytes:
        """Admit a tx; returns the recovered sender. Raises PoolError."""
        sender = self._validate(tx, is_staking, sender)
        state = self._state_view()
        slots = self._by_sender.setdefault(sender, {})
        old = slots.get(tx.nonce)
        if old is not None:
            bump = old.tx.gas_price * (100 + PRICE_BUMP_PCT) // 100
            if tx.gas_price < max(bump, old.tx.gas_price + 1):
                raise PoolError("replacement underpriced")
            slots[tx.nonce] = _Entry(tx, sender, is_staking,
                                     time.monotonic(),
                                     local=old.local)
            self._record_add(tx, is_staking)
            return sender
        # per-sender caps: executable run vs queued tail
        exec_n = self._sender_exec_count(state, sender)
        sender_total = len(slots)
        executable = tx.nonce <= state.nonce(sender) + exec_n
        if executable and exec_n >= ACCOUNT_SLOTS:
            raise PoolError("sender executable slots full")
        if not executable and (sender_total - exec_n) >= ACCOUNT_QUEUE:
            raise PoolError("sender queue full")
        # global pressure: try evicting a cheaper queued tx first
        limit = self.global_slots + self.global_queue
        if self._count >= limit:
            if not self._evict_cheapest_queued(state, tx.gas_price):
                raise PoolError("pool full (newcomer underpriced)")
        slots[tx.nonce] = _Entry(tx, sender, is_staking, time.monotonic())
        self._count += 1
        self._record_add(tx, is_staking)
        return sender

    # -- selection ---------------------------------------------------------

    def _pending_unlocked(self, max_txs: int = 0):
        """Executable (tx, is_staking) pairs: gapless nonce runs per
        sender, merged by descending gas price (the proposer's read —
        reference: node/harmony/worker block assembly)."""
        state = self._state_view()
        runs = []
        for sender, slots in self._by_sender.items():
            nonce = state.nonce(sender)
            run = []
            while nonce in slots:
                run.append(slots[nonce])
                nonce += 1
            if run:
                runs.append(run)
        out = []
        cursors = [0] * len(runs)
        while True:
            best, best_i = None, -1
            for i, run in enumerate(runs):
                if cursors[i] < len(run):
                    e = run[cursors[i]]
                    if best is None or e.tx.gas_price > best.tx.gas_price:
                        best, best_i = e, i
            if best is None:
                break
            out.append((best.tx, best.is_staking))
            cursors[best_i] += 1
            if max_txs and len(out) >= max_txs:
                break
        return out

    def _queued_unlocked(self):
        """Non-executable (tx, is_staking) pairs (future-nonce tail)."""
        state = self._state_view()
        out = []
        for sender, slots in self._by_sender.items():
            exec_top = state.nonce(sender)
            while exec_top in slots:
                exec_top += 1
            for nonce in sorted(slots):
                if nonce >= exec_top:
                    e = slots[nonce]
                    out.append((e.tx, e.is_staking))
        return out

    # -- maintenance -------------------------------------------------------

    def _drop_applied_unlocked(self) -> int:
        """Prune txs whose nonce is now below the state nonce (called
        after a block commits); queued txs just above the new nonce
        become executable implicitly (promotion is the tier REREAD).
        Returns how many were pruned — drop_applied's journal-rotate
        branch gates on it, and the missing return made that branch
        unreachable (the journal never rotated on the commit path)."""
        state = self._state_view()
        dropped = 0
        for sender in list(self._by_sender):
            slots = self._by_sender[sender]
            floor = state.nonce(sender)
            for nonce in [n for n in slots if n < floor]:
                del slots[nonce]
                self._count -= 1
                dropped += 1
            if not slots:
                del self._by_sender[sender]
        return dropped

    def _evict_stale_unlocked(self, now: float | None = None) -> int:
        """Drop queued txs older than the lifetime (reference: the 3h
        queue eviction loop).  Returns the eviction count — the node's
        maintenance tick logs it."""
        now = time.monotonic() if now is None else now
        state = self._state_view()
        dropped = 0
        for sender in list(self._by_sender):
            slots = self._by_sender[sender]
            exec_top = state.nonce(sender)
            while exec_top in slots:
                exec_top += 1
            for nonce in [
                n for n, e in slots.items()
                if n >= exec_top and now - e.added_at > self.lifetime
            ]:
                del slots[nonce]
                self._count -= 1
                self.evicted += 1
                dropped += 1
            if not slots:
                del self._by_sender[sender]
        return dropped

    def __len__(self):
        return self._count

    # -- governor surface ---------------------------------------------------

    def set_floor_multiplier(self, mult: int) -> None:
        """Dynamic gas-price floor (resource governor knob): the
        effective admission floor becomes price_floor * mult."""
        self._floor_mult = max(1, int(mult))

    def fill_ratio(self) -> float:
        """Pool occupancy 0..1 against the combined global bound — the
        governor's queue-pressure signal for this pool."""
        limit = self.global_slots + self.global_queue
        return (self._count / limit) if limit else 0.0


    # -- locked public surface (see _lock above) ---------------------------

    def stats(self):
        with self._lock:
            return self._stats_unlocked()

    def add(self, tx, is_staking: bool = False,
            local: bool = False, sender: bytes | None = None) -> bytes:
        # recover the signature BEFORE taking the lock: it is the
        # dominant cost of admission and needs no pool state.  Callers
        # that already recovered the sender (gossip pre-filter, load
        # harnesses pacing submission independently of the pure-Python
        # secp256k1 stand-in) pass it in and skip the repeat.
        if sender is None:
            sender = self._recover_sender(tx)
        if is_staking:
            # BLS key-registration proofs verify OUTSIDE the lock too,
            # on the scheduler's ingress lane, like the ECDSA recover above.
            # On the card a check that cannot run raises
            # device.DeviceError out of add(): never a quiet refusal
            self._verify_bls_pop(tx)
        with self._lock:
            sender = self._add_unlocked(tx, is_staking, sender)
            if local:
                entry = self._by_sender[sender][tx.nonce]
                entry.local = True
                if self._journal is not None:
                    try:
                        self._journal_append(tx, is_staking)
                        self._journal.flush()
                    except OSError:
                        # the journal is best-effort persistence: a
                        # full disk must not fail an ADMITTED tx
                        pass
            return sender

    def _record_add(self, tx, is_staking: bool):
        # the tx OBJECT rides the ring; its hash is computed lazily in
        # adds_since — the pure-Python keccak was 97% of admission cost
        # (measured), paid per ADD for a feed only websocket
        # subscribers read.  Third slot: the hash memo the first
        # reader fills (dropping the tx ref), so N subscribers still
        # cost one keccak per tx and read entries pin no bodies.
        # Large-calldata txs hash eagerly instead: pinning up to 4096
        # big bodies after they leave the pool would dwarf the keccak
        # this path avoids (and their keccak is size-bound anyway).
        self._add_seq += 1
        if len(getattr(tx, "data", b"") or b"") > 1024:
            self._recent_adds.append(
                [self._add_seq, None, tx.hash(self.chain_id)]
            )
        else:
            self._recent_adds.append([self._add_seq, tx, None])

    @property
    def add_seq(self) -> int:
        with self._lock:
            return self._add_seq

    def adds_since(self, seq: int):
        """(latest_seq, [tx hashes admitted after ``seq``]) — the push
        feed for newPendingTransactions subscribers.  Hashing happens
        HERE (outside the lock, on the subscriber's thread), not at
        admission: the keccak per tx belongs to the reader, never to
        the hot add path.  The memo slot makes it once per TX, not
        once per subscriber (the write is a GIL-atomic idempotent
        list-item store; a racing reader at worst recomputes)."""
        with self._lock:
            latest = self._add_seq
            tail = [e for e in self._recent_adds if e[0] > seq]
        hashes = []
        for entry in tail:
            h = entry[2]
            if h is None:
                h = entry[1].hash(self.chain_id)
                entry[2] = h
                entry[1] = None  # memoized: stop pinning the body
            hashes.append(h)
        return latest, hashes

    # -- local tx journal (reference: core/tx_journal.go — locally
    # submitted txs survive a node restart; remote gossip does not) ---------

    _JOURNAL_ROTATE_BYTES = 1 << 20  # rewrite when the file outgrows this

    def open_journal(self, path: str) -> int:
        """Attach a journal file; replays any existing entries into the
        pool first (invalid/stale entries are dropped), then rewrites
        it with the survivors.  Returns how many txs were restored."""
        from . import rawdb

        restored = 0
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except FileNotFoundError:
            blob = b""
        with self._lock:
            i = 0
            while i + 5 <= len(blob):
                kind = blob[i]
                ln = int.from_bytes(blob[i + 1:i + 5], "little")
                i += 5
                raw = blob[i:i + ln]
                i += ln
                if len(raw) < ln or kind not in (0, 1):
                    break  # torn tail (crash mid-append): discard rest
                try:
                    tx = (rawdb.decode_staking_tx if kind
                          else rawdb.decode_tx)(raw)
                    sender = self._add_unlocked(tx, bool(kind))
                    self._by_sender[sender][tx.nonce].local = True
                    restored += 1
                except (ValueError, IndexError):
                    continue  # applied/stale/corrupt entries drop out
            self._journal_path = path
            self._rotate_journal_unlocked()
        return restored

    def _journal_append(self, tx, is_staking: bool, fh=None):
        from . import rawdb

        enc = (rawdb.encode_staking_tx if is_staking
               else rawdb.encode_tx)(tx, self.chain_id)
        (fh or self._journal).write(
            bytes([1 if is_staking else 0])
            + len(enc).to_bytes(4, "little") + enc
        )

    def _rotate_journal_unlocked(self):
        """Rewrite the journal with only the LOCAL txs still in the
        pool, via tmp + atomic replace: a crash mid-rewrite must not
        lose the previous journal (the reference rotates on demand to
        bound file growth)."""
        import os

        if self._journal_path is None:
            return
        try:
            if self._journal is not None:
                self._journal.close()
            tmp = self._journal_path + ".tmp"
            with open(tmp, "wb") as fh:
                for sender_txs in self._by_sender.values():
                    for entry in sender_txs.values():
                        if entry.local:
                            self._journal_append(
                                entry.tx, entry.is_staking, fh=fh
                            )
            os.replace(tmp, self._journal_path)
            self._journal = open(self._journal_path, "ab")
        except OSError:
            self._journal = None  # best-effort: run without a journal

    def rotate_journal(self):
        with self._lock:
            self._rotate_journal_unlocked()

    def pending(self, max_txs: int = 0):
        with self._lock:
            return self._pending_unlocked(max_txs)

    def queued(self):
        with self._lock:
            return self._queued_unlocked()

    def drop_applied(self):
        with self._lock:
            n = self._drop_applied_unlocked()
            if n and self._journal is not None:
                # rotate only when the file outgrew its cap: a rewrite
                # is O(pool) disk work and this runs on the consensus
                # commit path
                try:
                    oversized = (
                        self._journal.tell() > self._JOURNAL_ROTATE_BYTES
                    )
                except (OSError, ValueError):
                    oversized = True
                if oversized:
                    self._rotate_journal_unlocked()
            return n

    def evict_stale(self, now: float | None = None):
        with self._lock:
            return self._evict_stale_unlocked(now)
