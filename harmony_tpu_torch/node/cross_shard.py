"""Cross-shard receipt routing: source-shard export -> destination
inclusion, authenticated end to end.

The role of the reference's cross-shard plumbing (reference:
node/harmony/node_cross_shard.go — BroadcastCXReceipts after commit,
ProcessReceiptMessage on the destination; core/block_validator.go:
172-236 ValidateCXReceiptsProof): after a block commits on its shard,
each destination shard receives a CXReceiptsProof — the receipts, the
source header, its commit seal, and the sibling group roots — and can
verify the batch against the source shard's committee with ZERO trust
in the transport.  Fabricated receipts cannot mint balance: the proof
chain is receipts -> group root -> header.out_cx_root -> committee
seal.

The port's copy of the JAX package's ``node/cross_shard.py``.
"""

from __future__ import annotations

from ..core import rawdb
from ..core.blockchain import verify_cx_proof
from ..core.types import CXReceiptsProof, cx_group_root
from ..p2p.groups import GroupID


def cx_topic(network: str, to_shard: int) -> str:
    """Destination-shard receipt topic (reference: group per shard)."""
    return GroupID(network, to_shard, "cx").topic()


def export_receipts(chain, block_num: int, shard_count: int) -> dict:
    """Proofs for a committed block, one per destination shard with
    receipts (reference: core/blockchain_impl.go:2633 CXMerkleProof +
    node_cross_shard.go BroadcastCXReceipts).  The source node
    broadcasts each to its shard's topic.  Groups and sibling roots are
    computed ONCE and shared across all destinations."""
    groups = {
        sid: chain.outgoing_cx(sid, block_num)
        for sid in range(shard_count)
    }
    groups = {sid: g for sid, g in groups.items() if g}
    if not groups:
        return {}
    header = rawdb.read_header(chain.db, block_num)
    if header is None:
        return {}
    # no stored seal -> empty commit fields; an engine-wired destination
    # will reject such a proof (correct: an unsealed block's receipts
    # are not final), engine-less test chains accept it
    seal = chain.read_commit_sig(block_num) or b""
    if seal and len(seal) < 96:
        return {}
    shard_ids = sorted(groups)
    shard_hashes = [cx_group_root(groups[sid]) for sid in shard_ids]
    header_bytes = rawdb.encode_header(header)
    out = {}
    for to_shard in shard_ids:
        if to_shard == chain.shard_id:
            continue
        out[to_shard] = CXReceiptsProof(
            receipts=groups[to_shard],
            header_bytes=header_bytes,
            commit_sig=seal[:96],
            commit_bitmap=seal[96:],
            shard_ids=shard_ids,
            shard_hashes=shard_hashes,
        )
    return out


def make_cx_proof(chain, block_num: int, to_shard: int,
                  shard_count: int) -> CXReceiptsProof | None:
    """One destination's proof (see export_receipts)."""
    return export_receipts(chain, block_num, shard_count).get(to_shard)


def encode_cx_batch(proof: CXReceiptsProof) -> bytes:
    return proof.encode()


def decode_cx_batch(data: bytes) -> CXReceiptsProof:
    return rawdb.decode_cx_proof(data)


class CXPool:
    """Destination-side pending incoming receipt proofs (the role of
    the reference's pending CXReceipts store): every batch is FULLY
    verified at ingestion — merkle consistency against the source
    header plus the header's committee seal — deduplicated by
    (from_shard, block_num), and drained into the next proposal."""

    def __init__(self, shard_id: int, cap: int = 4096, engine=None,
                 config=None, spent=None):
        """engine/config: seal verification context (engine=None skips
        the seal check — only for engine-less test chains).  spent:
        callable (from_shard, num) -> bool for already-consumed batches
        (wire to rawdb.is_cx_spent on the destination chain)."""
        self.shard_id = shard_id
        self.cap = cap
        self.engine = engine
        self.config = config
        self.spent = spent or (lambda *_: False)
        self._pending: dict = {}  # (from_shard, block_num) -> proof

    def add_batch(self, data: bytes) -> int:
        """Ingest an encoded proof; returns receipts accepted (0 on any
        verification failure — unauthenticated receipts never enter)."""
        try:
            proof = decode_cx_batch(data)
            src = rawdb.decode_header(proof.header_bytes)
        except (ValueError, IndexError):
            return 0
        key = (src.shard_id, src.block_num)
        if key in self._pending or self.spent(*key):
            return 0
        if not verify_cx_proof(proof, self.shard_id, self.engine,
                               self.config):
            return 0
        total = sum(len(p.receipts) for p in self._pending.values())
        if total + len(proof.receipts) > self.cap:
            return 0
        self._pending[key] = proof
        return len(proof.receipts)

    def drain(self, max_receipts: int = 512) -> list:
        """Proofs for the next proposal, oldest source blocks first."""
        out, n = [], 0
        for key in sorted(self._pending):
            proof = self._pending[key]
            if n + len(proof.receipts) > max_receipts:
                break
            out.append(proof)
            n += len(proof.receipts)
            del self._pending[key]
        return out

    def __len__(self):
        return sum(len(p.receipts) for p in self._pending.values())
