"""Cross-links: beacon-chain verification of other shards' blocks.

Behavioral parity with the reference (reference:
internal/chain/engine.go:592 VerifyCrossLink + node/harmony/
node_cross_link.go): a cross-link carries (shard, block number, hash,
epoch, aggregate commit signature + bitmap); the beacon chain verifies
the aggregate against THAT shard's committee for THAT epoch.  This is
the biggest batching win in the reference's workload (SURVEY.md §2.7):
the beacon verifies many independent shard proofs — here they ride the
engine's batched replay path.

The port's copy of the JAX package's ``chain/crosslink.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..consensus.signature import construct_commit_payload
from .engine import Engine
from .header import Header


@dataclass
class CrossLink:
    shard_id: int
    block_num: int
    view_id: int
    epoch: int
    block_hash: bytes
    signature: bytes  # 96B aggregate
    bitmap: bytes

    def header_stub(self) -> "Header":
        """A header-shaped view carrying the signed identity; the commit
        payload is reconstructed from the carried hash, not recomputed
        from full header fields (the link does not carry them)."""
        return _StubHeader(self)


class _StubHeader(Header):
    """Header stand-in whose hash() is the cross-link's carried hash."""

    def __init__(self, link: CrossLink):
        super().__init__(
            shard_id=link.shard_id,
            block_num=link.block_num,
            epoch=link.epoch,
            view_id=link.view_id,
        )
        self._carried_hash = link.block_hash

    def hash(self) -> bytes:
        return self._carried_hash


def verify_crosslink(engine: Engine, link: CrossLink,
                     is_staking: bool = True) -> bool:
    """One cross-link check (engine.go:592)."""
    return engine.verify_header_signature(
        link.header_stub(), link.signature, link.bitmap, is_staking
    )


def verify_crosslinks_batch(engine: Engine, links: list,
                            is_staking: bool = True) -> list:
    """Beacon-side batch: all shards' proofs in one device program."""
    items = [(ln.header_stub(), ln.signature, ln.bitmap) for ln in links]
    return engine.verify_headers_batch(items, is_staking)


def crosslink_commit_payload(link: CrossLink, is_staking: bool = True):
    return construct_commit_payload(
        link.block_hash, link.block_num, link.view_id, is_staking
    )
