"""Block assembly: the proposer's execution environment.

The role of the reference's node/harmony/worker (reference:
node/harmony/worker/worker.go:54-99 block-assembly env) + the proposal
flow of consensus/consensus_block_proposing.go:25-254 (ProposeNewBlock:
pull txs + staking txs + incoming cx receipts, execute speculatively,
seal the header with the post-state root — SURVEY.md §2.2): take the
chain tip, select from the mempool, run the state processor on a state
copy, and emit a sealed-but-unsigned Block whose header is what the
leader announces.

The port's copy of the JAX package's ``node/worker.py``.
"""

from __future__ import annotations

from ..chain.header import Header
from ..core import rawdb
from ..core.state_processor import ExecutionError
from ..core.types import (
    Block, group_cx_by_shard, out_cx_root, receipts_root,
)

DEFAULT_BLOCK_TX_CAP = 1024


class Worker:
    def __init__(self, chain, tx_pool=None):
        self.chain = chain
        self.tx_pool = tx_pool

    def propose_block(
        self,
        view_id: int,
        timestamp: int = 0,
        incoming_receipts: list | None = None,
        leader_extra: bytes = b"",
        max_txs: int = DEFAULT_BLOCK_TX_CAP,
        vrf: bytes = b"",
        vdf: bytes = b"",
        slashes: list | None = None,
    ) -> Block:
        """Assemble the next block on the current tip.

        Mempool selection is best-effort: a tx that fails execution is
        skipped (and left for the pool's next prune), exactly as the
        reference's worker drops failing txs from the proposal rather
        than aborting it.  ``slashes`` are verified double-sign
        ``slash.Record``s to include: each is dry-applied first and
        DROPPED from the proposal if it no longer applies (offender
        already banned by a competing block, evidence gone stale) —
        the proposer must never seal a block its own validators would
        reject.
        """
        parent = self.chain.current_header()
        num = parent.block_num + 1
        epoch = self.chain.epoch_of(num)

        plain, staking, order = [], [], []
        plain_receipts, staking_receipts = [], []
        outgoing = []
        state = self.chain.state().copy()
        gas_used = 0
        # EVM context must match what replay derives from the header
        from ..core.vm import Env

        self.chain.processor.set_env(Env(
            block_num=num, timestamp=timestamp,
            chain_id=self.chain.config.chain_id, epoch=epoch,
        ))
        if self.tx_pool is not None:
            for tx, is_staking in self.tx_pool.pending(max_txs):
                try:
                    if is_staking:
                        receipt = (
                            self.chain.processor.apply_staking_transaction(
                                state, tx, epoch, gas_used
                            )
                        )
                        staking.append(tx)
                        staking_receipts.append(receipt)
                    else:
                        receipt, cx = self.chain.processor.apply_transaction(
                            state, tx, num, gas_used
                        )
                        plain.append(tx)
                        plain_receipts.append(receipt)
                        if cx is not None:
                            outgoing.append(cx)
                    order.append(1 if is_staking else 0)
                    gas_used += receipt.gas_used
                except ExecutionError:
                    continue
        # incoming_receipts are CXReceiptsProof batches (authenticated
        # at pool ingestion AND re-verified by every validator/replayer)
        for proof in incoming_receipts or []:
            for cx in proof.receipts:
                self.chain.processor.apply_incoming_receipt(state, cx)
        # double-sign slash inclusion (reference: the leader packs
        # pending slashing records into the proposal — node.go
        # ProposeNewBlock's slash candidate drain): dry-apply each on a
        # throwaway copy so a record another block already consumed
        # (offender banned) is silently dropped, then apply the
        # surviving set for real — validators and replay re-run exactly
        # this via Blockchain.apply_slashes on header.slashes
        included_slashes: list = []
        from ..staking import slash as _SL

        if self.chain.config.header_version(epoch) != "v3":
            slashes = None  # only v3 headers HASH the slashes field
        if slashes:
            # ONE running dry state: each candidate verifies + applies
            # on top of the already-accepted set, so duplicates and
            # same-offender repeats fail "already banned" without
            # per-record full-state copies
            dry = state.copy()
            for record in slashes[:_SL.MAX_SLASHES_PER_BLOCK]:
                try:
                    self.chain.apply_slash_records(
                        dry, [record], num, observe=False
                    )
                except ValueError:
                    _SL.COUNTERS.inc("rejected")
                    continue
                included_slashes.append(record)
        if included_slashes:
            # observe=False: the proposal is speculative until it
            # commits — the insert path counts the ONE real apply
            self.chain.apply_slash_records(state, included_slashes, num,
                                           observe=False)
            _SL.COUNTERS.inc("included", len(included_slashes))
        # the parent's quorum proof rides in this header (reference:
        # block/header LastCommitSignature/Bitmap) and drives reward +
        # availability finalization
        parent_proof = self.chain.read_commit_sig(parent.block_num) or b""
        last_sig, last_bitmap = parent_proof[:96], parent_proof[96:]
        elected = self.chain.post_process(
            state, num, epoch, last_bitmap or None
        )

        block = Block(
            None,
            transactions=plain,
            staking_transactions=staking,
            incoming_receipts=list(incoming_receipts or []),
            execution_order=order,
        )
        block.header = Header(
            shard_id=self.chain.shard_id,
            block_num=num,
            epoch=epoch,
            view_id=view_id,
            parent_hash=parent.hash(),
            root=self.chain.config.state_root(state, epoch),
            tx_root=block.tx_root(self.chain.config.chain_id),
            receipt_root=receipts_root(plain_receipts + staking_receipts),
            out_cx_root=out_cx_root(group_cx_by_shard(outgoing)),
            timestamp=timestamp,
            last_commit_sig=last_sig,
            last_commit_bitmap=last_bitmap,
            # election blocks carry the NEXT epoch's elected committee
            # in the sealed header (reference: block header ShardState;
            # epochchain.go reads it back) — replay verifies the bytes
            # against its own election, and fast sync harvests verified
            # committees from here instead of trusting sync peers
            shard_state=(rawdb.encode_shard_state(elected)
                         if elected is not None else b""),
            slashes=(_SL.encode_records(included_slashes)
                     if included_slashes else b""),
            extra=leader_extra,
            vrf=vrf,
            vdf=vdf,
            version=self.chain.config.header_version(epoch),
        )
        return block
