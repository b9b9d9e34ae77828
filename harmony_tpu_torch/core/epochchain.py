"""EpochChain: the beacon-epoch light chain.

The role of the reference's core/epochchain.go: a chain that stores
ONLY epoch-boundary beacon blocks — each must carry the next epoch's
shard state and a valid committee seal — so shard nodes can follow
beacon committee rotation (cross-shard verification, staking epochs)
without replaying the beacon chain's transactions
(epochchain.go:117-175 InsertChain: IsLastBlockInEpoch + signature
check + writeShardStateBytes + head bookkeeping).

Design differences from the full Blockchain: no state execution, no tx
pool, no receipts — headers + shard states only, keyed by EPOCH.  The
committee provider for foreign shards resolves through this chain
(closing the fail-closed gap in cli._committee_provider with real
data instead of rejection).

The port's copy of the JAX package's ``core/epochchain.py``.
"""

from __future__ import annotations

import threading

from ..chain.header import Header
from . import rawdb


class EpochChainError(ValueError):
    pass


class EpochChain:
    """Epoch-boundary header chain over its own KV namespace."""

    _HEAD = b"EC:head"        # -> epoch(8)
    _HEADER = b"EC:h"         # EC:h || epoch(8) -> header blob

    def __init__(self, db, genesis_committee_provider, engine=None,
                 config=None):
        """genesis_committee_provider(shard_id) -> serialized keys for
        epoch 0 (bootstraps verification of the first epoch block);
        engine: chain.engine.Engine for seal checks (None = unverified
        inserts, test-only)."""
        self.db = db
        self.engine = engine
        self.config = config
        self._genesis_committee = genesis_committee_provider
        self._lock = threading.RLock()

    # -- reads --------------------------------------------------------------

    def head_epoch(self) -> int | None:
        blob = self.db.get(self._HEAD)
        return int.from_bytes(blob, "little") if blob is not None else None

    def header_for_epoch(self, epoch: int) -> Header | None:
        blob = self.db.get(self._HEADER + epoch.to_bytes(8, "little"))
        return rawdb.decode_header(blob) if blob is not None else None

    def shard_state_for_epoch(self, epoch: int):
        return rawdb.read_shard_state(self.db, epoch)

    def committee_for(self, shard_id: int, epoch: int) -> list:
        """Serialized BLS pubkeys for (shard, epoch), or [] when the
        epoch chain has not seen that epoch (callers fail closed)."""
        state = self.shard_state_for_epoch(epoch)
        if state is not None:
            com = state.find_committee(shard_id)
            if com is not None and com.slots:
                return com.bls_pubkeys()
        if epoch == 0:
            return list(self._genesis_committee(shard_id))
        return []

    # -- inserts ------------------------------------------------------------

    def insert(self, header: Header, shard_state, sig_bytes: bytes = b"",
               bitmap: bytes = b"") -> None:
        """Insert one epoch-boundary header + the NEXT epoch's elected
        shard state, seal-verified against the header's own committee
        (epochchain.go:126-139: last-block-in-epoch gate + signature
        validation before any write)."""
        if shard_state is None:
            raise EpochChainError(
                "not an epoch block: no shard state carried"
            )
        head = self.head_epoch()
        if head is not None and header.epoch <= head:
            return  # idempotent: already followed through here
        # seal verification is the expensive step — pairing programs, a
        # device dispatch, possibly a sidecar RPC over a socket — and it
        # needs nothing this lock guards, so it runs BEFORE acquisition
        # (GL05/GL06: holding the epoch-chain lock across it stalled
        # every concurrent follower and nested the device/native locks
        # under ours).  The head re-check under the lock keeps inserts
        # idempotent when two threads verify the same epoch.
        if self.engine is not None:
            if not self.engine.verify_header_signature(
                header, sig_bytes, bitmap
            ):
                raise EpochChainError(
                    f"bad committee seal on epoch block {header.epoch}"
                )
        with self._lock:
            head = self.head_epoch()
            if head is not None and header.epoch <= head:
                return
            rawdb.write_shard_state(self.db, header.epoch + 1, shard_state)
            self.db.put(
                self._HEADER + header.epoch.to_bytes(8, "little"),
                rawdb.encode_header(header),
            )
            self.db.put(
                self._HEAD, header.epoch.to_bytes(8, "little")
            )
