"""State snapshots + historical-state pruning.

The chain persists one full serialized StateDB per block (rawdb
``S || root``) — simple and crash-safe, but unbounded: a long-running
node's store grows with every block.  This module is the framework's
analog of the reference's snapshot/pruning pair (reference:
core/state/snapshot/ flat snapshot tree, core/blockchain_pruner.go):

* **Pruning** deletes historical state blobs outside a retention
  window, incrementally on insert (O(1) per block) or in bulk.  Headers,
  bodies, receipts and commit proofs are kept — a pruned node is a full
  header-chain node with recent-state depth, exactly the shape a fast
  (snap) sync produces.
* **Snapshots** export one sealed block's state (header + commit proof +
  accounts) to a single file, and import it back with the SAME binding
  check fast sync uses (config.state_root vs the sealed header root), so
  a snapshot can restore a pruned node or bootstrap a fresh one.

Root sharing: consecutive blocks with identical state (no txs, no
rewards) reuse one ``S || root`` entry; the pruner defers deletion until
the NEXT block's root differs, so a retained block never loses its
state to the pruning of an older twin.

The port's copy of the JAX package's ``core/snapshot.py``.
"""

from __future__ import annotations

import os

from .. import prof
from . import rawdb
from .state import StateDB

_MAGIC = b"HTSNAP1\n"

# wire-serving page shape: a page closes at whichever bound hits first.
# Byte-bounded pages keep every frame far under the stream layer's
# response cap even when single accounts are huge (validator wrappers
# with long delegation lists)
SNAPSHOT_PAGE_ACCOUNTS = 512
SNAPSHOT_PAGE_BYTES = 4 * 1024 * 1024


class SnapshotError(ValueError):
    pass


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------

def prune_state_at(chain, num: int) -> bool:
    """Delete block ``num``'s state blob if it is safe: never the
    genesis state, and never a root shared with the NEXT block (the
    retained chain still references it).  Returns True if deleted."""
    if num <= 0:
        return False
    header = rawdb.read_header(chain.db, num)
    if header is None:
        return False
    nxt = rawdb.read_header(chain.db, num + 1)
    if nxt is not None and nxt.root == header.root:
        return False  # shared root: defer to the next block's pruning
    if rawdb.read_state(chain.db, header.root) is None:
        return False
    rawdb.delete_state(chain.db, header.root)
    return True


def prune_states(chain, retain: int) -> int:
    """Bulk prune: drop every state blob older than ``head - retain``
    (reference: core/blockchain_pruner.go's offline prune).  Returns
    how many blobs were deleted."""
    if retain < 1:
        raise SnapshotError("retention must be >= 1")
    deleted = 0
    for num in range(1, chain.head_number - retain + 1):
        if prune_state_at(chain, num):
            deleted += 1
    return deleted


# ---------------------------------------------------------------------------
# snapshot files
# ---------------------------------------------------------------------------

def _enc_blob(b: bytes) -> bytes:
    return len(b).to_bytes(8, "big") + b


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def blob(self) -> bytes:
        n = int.from_bytes(self.d[self.o:self.o + 8], "big")
        self.o += 8
        out = self.d[self.o:self.o + n]
        if len(out) != n:
            raise SnapshotError("truncated snapshot")
        self.o += n
        return out


def paginate_state(blob: bytes,
                   max_accounts: int = SNAPSHOT_PAGE_ACCOUNTS,
                   max_bytes: int = SNAPSHOT_PAGE_BYTES) -> list:
    """Partition a serialized StateDB blob (``[u32 n][(addr, account)
    pairs]``) into wire pages: ``[(start_off, end_off, count), ...]``
    covering the pair region exactly.  Page boundaries always fall on
    account boundaries, so every page is itself a decodable
    ``[u32 count] || pairs`` fragment once the count is prepended, and
    the concatenation of all pages reassembles the original blob
    byte-for-byte (the importer's root check then binds the exact
    bytes).  Raises SnapshotError on a structurally damaged blob — the
    walk is length-arithmetic only, no allocation."""
    total = len(blob)
    n = int.from_bytes(blob[:4], "little")
    if n > total - 4:
        raise SnapshotError("implausible account count in state blob")
    off = 4
    pages = []
    start, count = off, 0
    for _ in range(n):
        ln = int.from_bytes(blob[off:off + 4], "little")
        off += 4 + ln
        if off + 4 > total:
            raise SnapshotError("truncated state blob")
        ln = int.from_bytes(blob[off:off + 4], "little")
        off += 4 + ln
        if off > total:
            raise SnapshotError("truncated state blob")
        count += 1
        if count >= max_accounts or off - start >= max_bytes:
            pages.append((start, off, count))
            start, count = off, 0
    if count:
        pages.append((start, off, count))
    if off != total:
        raise SnapshotError("trailing bytes after state accounts")
    return pages


def export_snapshot(chain, path: str, num: int | None = None) -> int:
    """Write block ``num``'s (default: head) sealed state to ``path``.

    Layout: magic || header || commit-proof || state-accounts.  The
    commit proof ([96B agg sig || bitmap], empty when the store has
    none, e.g. genesis) lets the importer's operator audit the seal.
    """
    with prof.stage("snapshot.export"):
        num = chain.head_number if num is None else num
        header = rawdb.read_header(chain.db, num)
        if header is None:
            raise SnapshotError(f"no header {num}")
        blob = rawdb.read_state(chain.db, header.root)
        if blob is None:
            raise SnapshotError(
                f"no state for block {num} (pruned? export a newer block)"
            )
        proof = rawdb.read_commit_sig(chain.db, num) or b""
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(_enc_blob(rawdb.encode_header(header)))
            f.write(_enc_blob(proof))
            f.write(_enc_blob(blob))
        os.replace(tmp, path)
        return num


def import_snapshot(chain, path: str, trust: bool = False) -> int:
    """Install a snapshot file into ``chain``; returns its block number.

    Binding: the accounts must hash to the snapshot header's sealed
    state root (same check as fast sync's adopt_state).  The header
    itself is trusted EITHER because the chain already has the same
    header at that height (restore-after-prune / resync case) OR
    because the operator passed ``trust=True`` (bootstrapping a fresh
    node from an operator-asserted snapshot, the way a trusted snap
    init works).
    """
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        raise SnapshotError("not a snapshot file")
    r = _Reader(data[len(_MAGIC):])
    header = rawdb.decode_header(r.blob())
    proof = r.blob()
    state_blob = r.blob()
    num = header.block_num

    local = rawdb.read_header(chain.db, num)
    if local is not None:
        if local.hash() != header.hash():
            raise SnapshotError(
                f"snapshot header {num} does not match the local chain"
            )
    elif not trust:
        raise SnapshotError(
            f"chain has no header {num}: import with trust=True only if "
            "the snapshot source is operator-trusted"
        )
    return install_snapshot(chain, header, proof, state_blob)


def install_snapshot(chain, header, proof: bytes,
                     state_blob: bytes) -> int:
    """Atomically install a snapshot whose HEADER the caller has
    already established trust in (local-chain match, operator trust,
    or — the late-join bootstrap — a peer-majority hash agreement).
    The accounts are still bound here: they must hash to the header's
    sealed state root, or nothing is written.  Returns the block
    number."""
    with prof.stage("snapshot.install"):
        num = header.block_num
        state = StateDB.deserialize(state_blob)
        if chain.config.state_root(state, header.epoch) != header.root:
            raise SnapshotError(
                "snapshot accounts do not match the sealed state root"
            )

        with chain._insert_lock:
            # header + proof + state + head move in ONE atomic batch: a
            # crash mid-import must leave the store exactly as damaged
            # as before, never half-restored (same discipline as
            # adopt_state)
            from .kv import WriteBatch, commit_batch

            batch = WriteBatch()
            if rawdb.read_header(chain.db, num) is None:
                batch.put(
                    rawdb._num_key(rawdb._HEADER, num),
                    rawdb.encode_header(header),
                )
                batch.put(rawdb._num_key(rawdb._CANON, num), header.hash())
                batch.put(
                    rawdb._NUM_BY_HASH + header.hash(),
                    num.to_bytes(8, "little"),
                )
            if proof:
                rawdb.write_commit_sig(batch, num, proof)
            rawdb.write_state(batch, header.root, state_blob)
            moves_head = num >= chain.head_number
            if moves_head:
                rawdb.write_head_number(batch, num)
            commit_batch(chain.db, batch)
            if moves_head:
                chain._head_num = num
                chain._state = state
                chain._committee_cache.clear()
        return num
