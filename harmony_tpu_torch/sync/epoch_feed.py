"""Beacon epoch feed: keep a shard node's EpochChain current.

The role of the reference's beacon-epoch sync (the EpochChain's
EPOCHSYNC insert path, core/epochchain.go:117-175, fed by the staged
sync's epoch-block stage): a non-beacon node needs each beacon epoch's
elected committees — and ONLY those — to verify cross-shard seals and
follow committee rotation.  This feed pulls, per unseen epoch:

* the epoch-boundary header + its commit proof (the ordinary
  block-by-number stream, last block of the epoch);
* the NEXT epoch's elected shard state (METHOD_EPOCH_STATE);

and hands them to EpochChain.insert, which seal-verifies the header
against its own committee before any write.

The port's copy of the JAX package's ``sync/epoch_feed.py``.
"""

from __future__ import annotations

from ..log import get_logger

_log = get_logger("epoch-feed")


class EpochFeed:
    def __init__(self, epoch_chain, client, blocks_per_epoch: int):
        """client: a SyncClient connected to a BEACON-shard node."""
        self.epoch_chain = epoch_chain
        self.client = client
        self.blocks_per_epoch = blocks_per_epoch

    def _boundary_block_num(self, epoch: int) -> int:
        """The last block of ``epoch`` (the one carrying the election —
        genesis-anchored fixed-width epochs, config/sharding layout)."""
        return (epoch + 1) * self.blocks_per_epoch - 1

    def feed_once(self, max_epochs: int = 64) -> int:
        """Pull every epoch the remote has completed that we lack;
        returns how many epoch blocks were inserted."""
        head_num, _ = self.client.get_head()
        remote_epoch = head_num // self.blocks_per_epoch
        start = self.epoch_chain.head_epoch()
        start = 0 if start is None else start + 1
        inserted = 0
        for epoch in range(start, remote_epoch):
            if inserted >= max_epochs:
                break
            num = self._boundary_block_num(epoch)
            got = self.client.get_blocks_by_number(num, 1)
            if not got:
                break
            block, proof = got[0]
            state = self.client.get_epoch_state(epoch + 1)
            if state is None:
                _log.warn(
                    "remote has no shard state for epoch", epoch=epoch + 1
                )
                break
            sig, bitmap = b"", b""
            if proof:
                sig, bitmap = proof[:96], proof[96:]
            self.epoch_chain.insert(block.header, state, sig, bitmap)
            inserted += 1
            _log.info("epoch block followed", epoch=epoch, block=num)
        return inserted
