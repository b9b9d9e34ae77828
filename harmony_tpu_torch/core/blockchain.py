"""The Blockchain: canonical chain + state + commit-sig storage.

The role of the reference's core.BlockChain (reference:
core/blockchain.go:47-360 interface, core/blockchain_impl.go:1666
InsertChain, WriteBlockWithState, ReadCommitSig/WriteCommitSig —
SURVEY.md §2.4): insert verified blocks, execute them against state,
persist everything through the rawdb schema, and expose the read
surface consensus and RPC consume.

Verification on insert mirrors the reference's sync path (SURVEY.md
§3.3): each block's commit proof arrives either in the NEXT header
(``last_commit_sig``) or as the explicitly passed proof for the tip;
signature checks route through the chain Engine (one aggregate pairing
per block, batched across an insert).

The port's copy of the JAX package's ``core/blockchain.py``.
"""

from __future__ import annotations

import threading

from ..chain.header import Header
from ..log import get_logger
from ..obs.replay import stage as replay_stage
from .genesis import Genesis
from .kv import WriteBatch, commit_batch
from .state import StateDB
from .state_processor import StateProcessor
from .types import Block
from . import rawdb, types

_log = get_logger("chain")


def verify_cx_proof(proof, dest_shard: int, engine, config) -> bool:
    """Authenticate one cross-shard receipt batch (reference:
    core/block_validator.go:172-236 ValidateCXReceiptsProof):

    (1) the receipts hash to the destination's group root;
    (2) the (shard, group-root) pairs hash to the source header's
        out_cx_root;
    (3) every receipt routes to this shard and claims the source
        header's shard/number;
    (4) the source header's seal verifies against the SOURCE shard's
        committee (engine.verify_header_signature) — skipped only when
        no engine is wired (test chains without consensus).

    Fabricated receipts fail (1)/(2); receipts lifted from another
    shard's group fail (3); a forged source header fails (4).
    """
    try:
        header = rawdb.decode_header(proof.header_bytes)
    except (ValueError, IndexError):
        return False
    if not proof.receipts:
        return False
    for cx in proof.receipts:
        if cx.to_shard != dest_shard:
            return False
        if cx.from_shard != header.shard_id or cx.block_num != header.block_num:
            return False
    if dest_shard not in proof.shard_ids:
        return False
    if len(proof.shard_ids) != len(proof.shard_hashes):
        return False
    group = proof.shard_hashes[proof.shard_ids.index(dest_shard)]
    if types.cx_group_root(proof.receipts) != group:
        return False
    out = bytearray()
    for sid, h in zip(proof.shard_ids, proof.shard_hashes):
        out += sid.to_bytes(4, "little") + h
    from ..ref.keccak import keccak256

    if keccak256(bytes(out)) != header.out_cx_root:
        return False
    if engine is not None:
        if len(proof.commit_sig) != 96:
            return False
        return engine.verify_header_signature(
            header, proof.commit_sig, proof.commit_bitmap,
            config.is_staking(header.epoch),
        )
    return True


class ChainError(ValueError):
    pass


class Blockchain:
    def __init__(self, db, genesis: Genesis, engine=None,
                 blocks_per_epoch: int = 32768, finalizer=None,
                 state_retention: int | None = None,
                 require_commit_sigs: bool | None = None):
        """engine: chain.engine.Engine or None (no seal checks — tests
        and block production before wiring consensus).  finalizer:
        chain.finalize.Finalizer or None (no rewards/election — the
        pre-staking chain shape).  state_retention: keep only the last
        N block states (None = archive node, every state kept).
        require_commit_sigs: recovery-on-open additionally requires a
        stored commit proof at every candidate head (None = derived
        from ``engine is not None`` — consensus-wired nodes always
        persist the proof with the block; proof-less test chains do
        not)."""
        self.db = db
        self.state_retention = state_retention
        self.genesis = genesis
        self.config = genesis.config
        self.shard_id = genesis.shard_id
        self.engine = engine
        self.finalizer = finalizer
        self.blocks_per_epoch = blocks_per_epoch
        self.processor = StateProcessor(self.config.chain_id, self.shard_id)
        self._committee_cache: dict[int, list] = {}
        self.recovered_blocks = 0  # head rollback depth at last open
        self._require_commit_sigs = (
            engine is not None if require_commit_sigs is None
            else require_commit_sigs
        )
        # insert_chain can be reached from two threads at once: the
        # consensus pump (commit path) and the background downloader
        # (node._spin_up_sync) — serialize writers
        self._insert_lock = threading.RLock()
        head = rawdb.read_head_number(db)
        if head is None:
            self._init_genesis()
        else:
            self._head_num, self._state = self._recover_head(head)

    # -- bootstrap ---------------------------------------------------------

    def _init_genesis(self):
        block = self.genesis.build_block()
        state = self.genesis.build_state()
        batch = WriteBatch()
        rawdb.write_block(batch, block, self.config.chain_id)
        rawdb.write_state(batch, block.header.root, state.serialize())
        rawdb.write_head_number(batch, 0)
        commit_batch(self.db, batch)
        self._head_num = 0
        self._state = state

    def _block_complete(self, num: int):
        """The stored Header of block ``num`` if its block records are
        whole — header present, canonical hash matches, commit proof
        present where this chain requires one — else None.  State is
        judged separately: a pruned node legitimately has no state
        below head, and that must NOT read as a torn block."""
        header = rawdb.read_header(self.db, num)
        if header is None:
            return None
        if rawdb.read_canonical_hash(self.db, num) != header.hash():
            return None
        if self._require_commit_sigs and num > 0 and (
            rawdb.read_commit_sig(self.db, num) is None
        ):
            return None
        return header

    def _recover_head(self, head: int):
        """Reopen-time head verification (the role of the reference's
        loadLastState + its SetHead repair, core/blockchain_impl.go):
        serve ``head`` only if its block records are whole and its
        state loads + re-derives the sealed root; roll back across any
        TORN blocks (missing header/canonical/proof, corrupt state
        blob) to the newest whole one.  A whole block whose state blob
        is simply ABSENT is a pruned/snapshot-restorable store, not a
        tear: raise the classic "missing state" instead of destroying
        the block records a snapshot import needs.  With atomic commit
        batches a tear can only come from a pre-batch DB or external
        damage — but a restarted node must NEVER crash on (or silently
        serve) one."""
        for num in range(head, -1, -1):
            header = self._block_complete(num)
            if header is None:
                continue
            blob = rawdb.read_state(self.db, header.root)
            if blob is None:
                raise ChainError(
                    f"missing state for root at block {num}"
                )
            try:
                state = StateDB.deserialize(blob)
            except (ValueError, IndexError, KeyError):
                continue  # corrupt state blob: torn, keep walking
            if self.config.state_root(state, header.epoch) != header.root:
                continue
            if num < head:
                batch = WriteBatch()
                for n in range(head, num, -1):
                    rawdb.delete_canonical(self.db, n, w=batch)
                rawdb.write_head_number(batch, num)
                commit_batch(self.db, batch)
                self.recovered_blocks = head - num
                _log.warn(
                    "torn head rolled back on open", stored_head=head,
                    recovered_head=num, shard=self.shard_id,
                )
            return num, state
        raise ChainError(
            f"no consistent head at or below {head}: storage is "
            "damaged beyond rollback (genesis itself is torn)"
        )

    def _load_state_at(self, num: int) -> StateDB:
        header = rawdb.read_header(self.db, num)
        if header is None:
            raise ChainError(f"missing header {num}")
        blob = rawdb.read_state(self.db, header.root)
        if blob is None:
            raise ChainError(f"missing state for root at block {num}")
        return StateDB.deserialize(blob)

    # -- reads -------------------------------------------------------------

    @property
    def head_number(self) -> int:
        return self._head_num

    def current_header(self) -> Header:
        return rawdb.read_header(self.db, self._head_num)

    def current_block(self) -> Block:
        return rawdb.read_block(self.db, self._head_num)

    def header_by_number(self, num: int) -> Header | None:
        return rawdb.read_header(self.db, num)

    def block_by_number(self, num: int) -> Block | None:
        return rawdb.read_block(self.db, num)

    def block_by_hash(self, block_hash: bytes) -> Block | None:
        num = rawdb.read_block_number(self.db, block_hash)
        return None if num is None else rawdb.read_block(self.db, num)

    def state(self) -> StateDB:
        """The CURRENT state (a live reference; copy() to speculate)."""
        return self._state

    def state_at(self, num: int) -> StateDB:
        return self._load_state_at(num)

    def epoch_of(self, num: int) -> int:
        return num // self.blocks_per_epoch

    def is_epoch_boundary(self, num: int) -> bool:
        return num % self.blocks_per_epoch == 0 and num > 0

    def is_election_block(self, num: int) -> bool:
        """Last block of its epoch: the committee-selection point
        (reference: engine.go:412 IsCommitteeSelectionBlock — the
        block before the epoch turns)."""
        return (num + 1) % self.blocks_per_epoch == 0

    def committee_for_epoch(self, epoch: int) -> list:
        """Serialized BLS pubkeys: the elected shard state if one was
        persisted for this epoch, else the genesis committee.  Cached —
        this sits on the gossip ingress hot path; the cache entry is
        dropped when an election writes that epoch's shard state."""
        cached = self._committee_cache.get(epoch)
        if cached is not None:
            return list(cached)
        keys = list(self.genesis.committee)
        state = rawdb.read_shard_state(self.db, epoch)
        if state is not None:
            com = state.find_committee(self.shard_id)
            if com is not None and com.slots:
                keys = com.bls_pubkeys()
        self._committee_cache[epoch] = keys
        return list(keys)

    def shard_state_for_epoch(self, epoch: int):
        return rawdb.read_shard_state(self.db, epoch)

    def read_commit_sig(self, num: int) -> bytes | None:
        return rawdb.read_commit_sig(self.db, num)

    def write_commit_sig(self, num: int, sig_and_bitmap: bytes):
        rawdb.write_commit_sig(self.db, num, sig_and_bitmap)

    def outgoing_cx(self, to_shard: int, num: int) -> list:
        return rawdb.read_outgoing_cx(self.db, to_shard, num)

    # -- insertion ---------------------------------------------------------

    def _verify_structure(self, block: Block, parent: Header):
        h = block.header
        if h.block_num != parent.block_num + 1:
            raise ChainError(
                f"non-sequential block {h.block_num} on {parent.block_num}"
            )
        if h.parent_hash != parent.hash():
            raise ChainError("parent hash mismatch")
        if h.shard_id != self.shard_id:
            raise ChainError("wrong shard")
        if h.epoch != self.epoch_of(h.block_num):
            raise ChainError("wrong epoch for block number")
        if block.tx_root(self.config.chain_id) != h.tx_root:
            raise ChainError("tx root does not commit to the body")

    def post_process(self, state, block_num: int, epoch: int,
                     prev_bitmap: bytes | None):
        """Everything after tx execution that feeds the sealed state
        root: rewards + availability (per block), undelegation payouts
        + EPoS status + election (at the boundary).  Shared verbatim by
        the proposer (worker) and replay so roots agree.  Returns the
        elected shard state at election blocks (caller persists on
        insert), else None."""
        if self.finalizer is not None:
            # the bitmap being consumed is the PARENT's commit proof,
            # taken over the parent's epoch committee (matters on the
            # first block after an election)
            prev_epoch = self.epoch_of(max(block_num - 1, 0))
            self.finalizer.finalize_block(
                state, self.shard_state_for_epoch(prev_epoch),
                self.shard_id, prev_bitmap,
            )
        if self.is_epoch_boundary(block_num):
            self.processor.payout_undelegations(state, epoch)
        if self.finalizer is not None and self.is_election_block(block_num):
            self.finalizer.compute_epos_status(state, epoch)
            return self.finalizer.elect(state, epoch + 1)
        return None

    # -- slashing (reference: staking/slash/double-sign.go Verify+Apply) ----

    def verify_slash_record(self, record, block_num: int) -> None:
        """Chain-side checks layered over the pure evidence
        verification (the reference's Verify does both: the ballot
        crypto AND the chain-state lookups): the moment must be in this
        chain's past, its committee must be resolvable locally, and the
        double-sign keys must have held slots in THAT epoch.  Raises
        ChainError."""
        from ..staking.slash import SlashVerifyError, verify_record

        ev = record.evidence
        m = ev.moment
        if m.shard_id != self.shard_id:
            raise ChainError("slash record from another shard")
        if m.height >= block_num:
            raise ChainError("slash evidence from the future")
        if m.epoch > self.epoch_of(block_num):
            raise ChainError("slash evidence epoch ahead of the chain")
        if m.epoch != self.epoch_of(m.height):
            raise ChainError("slash moment epoch/height disagree")
        committee = self.committee_for_epoch(m.epoch)
        try:
            verify_record(
                record, committee,
                is_staking=self.config.is_staking(m.epoch),
            )
        except SlashVerifyError as e:
            raise ChainError(f"invalid slash record: {e}") from e

    def apply_slash_records(self, state, records: list,
                            block_num: int, observe: bool = True) -> int:
        """Verify + apply ``records`` to ``state`` — the economics the
        reference runs in Finalize (double-sign.go Apply): slash the
        offender's delegations at the double-sign rate, reward the
        reporter half the slashed amount, BAN the offender (status 2 —
        which also bars its keys from every later election and, because
        a banned offender can never be slashed again, dedups the same
        evidence across blocks).  Deterministic: runs identically on
        the proposer, the pre-vote dry run, and replay, BEFORE the
        state root is sealed/checked.  Returns total atto slashed.
        ``observe=False`` suppresses the harmony_slash_* counters and
        the log line — dry runs (proposer candidate filtering, the
        validator's pre-vote speculation) must not inflate the
        'applied' stage or the atto amounts actually moved."""
        from ..staking import slash as SL

        if not records:
            return 0
        if len(records) > SL.MAX_SLASHES_PER_BLOCK:
            raise ChainError("too many slash records in one block")
        total = 0
        seen: set = set()
        for record in records:
            fp = SL.record_fingerprint(record)
            if fp in seen:
                raise ChainError("duplicate slash record in block")
            seen.add(fp)
            self.verify_slash_record(record, block_num)
            if observe:
                SL.COUNTERS.inc("verified")
            offender = record.evidence.offender
            w = state.validator(offender)
            if w is None:
                raise ChainError("slash offender is not a validator")
            if w.status == 2:
                raise ChainError("slash offender already banned")
            app = SL.apply_slash(w.total_delegation())
            # burn from delegations in order (deterministic; the
            # reference burns self-delegation first — delegations[0]
            # is the self-delegation by construction)
            left = app.total_slashed
            for d in w.delegations:
                take = min(d.amount, left)
                d.amount -= take
                left -= take
                if left == 0:
                    break
            w.status = 2  # double-sign ban (permanent)
            if record.reporter and record.reporter != offender:
                state.add_balance(
                    record.reporter, app.total_beneficiary_reward
                )
                if observe:
                    SL.AMOUNTS.inc(
                        "reward_atto", app.total_beneficiary_reward
                    )
            total += app.total_slashed
            if observe:
                SL.COUNTERS.inc("applied")
                SL.AMOUNTS.inc("slashed_atto", app.total_slashed)
                _log.warn(
                    "slash applied", offender=offender.hex()[:12],
                    slashed=app.total_slashed, block=block_num,
                    shard=self.shard_id,
                )
        return total

    def apply_slashes(self, state, slashes_bytes: bytes,
                      block_num: int, observe: bool = True,
                      version: str = "v3") -> int:
        """Header-bytes entry point (replay + the validator's pre-vote
        dry run): bounded decode, then verify + apply.  ``version`` is
        the carrying header's version: only v3 headers HASH the
        slashes field, so slashes riding any other version are
        unsigned malleable bytes — a relay could splice a valid record
        into an honest proposal without changing its hash and split
        the committee on the derived root.  Reject them outright."""
        from ..staking.slash import decode_records

        if not slashes_bytes:
            return 0
        if version != "v3":
            raise ChainError(
                f"header version {version!r} does not hash its "
                "slashes field; carried slash bytes are unsigned"
            )
        try:
            records = decode_records(slashes_bytes)
        except (ValueError, IndexError) as e:
            raise ChainError(f"bad slash payload: {e}") from e
        return self.apply_slash_records(state, records, block_num,
                                        observe=observe)

    def _execute(self, block: Block):
        state = self._state.copy()
        epoch = block.header.epoch
        result = self.processor.process(state, block, epoch)
        groups = types.group_cx_by_shard(result.outgoing_cx)
        if types.out_cx_root(groups) != block.header.out_cx_root:
            raise ChainError("outgoing receipt root mismatch")
        if types.receipts_root(
            result.receipts + result.staking_receipts
        ) != block.header.receipt_root:
            raise ChainError("receipt root mismatch after execution")
        # included slash records re-verify against the moment's epoch
        # committee and apply BEFORE finalization — the state the
        # header seals includes their effect, so a fabricated record
        # can never survive the root check, and an invalid one rejects
        # the whole block (exactly the reference's Verify-on-inclusion)
        self.apply_slashes(state, block.header.slashes, block.block_num,
                           version=block.header.version)
        elected = self.post_process(
            state, block.block_num, epoch,
            block.header.last_commit_bitmap or None,
        )
        # the header's carried committee must BE the election this
        # replay just computed (reference: VerifyShardState) — the
        # sealed bytes are what fast-syncing nodes will trust
        carried = block.header.shard_state
        want = (rawdb.encode_shard_state(elected)
                if elected is not None else b"")
        if carried != want:
            raise ChainError(
                f"header shard state mismatch at block {block.block_num}"
            )
        if self.config.state_root(state, epoch) != block.header.root:
            raise ChainError("state root mismatch after execution")
        return state, result, elected

    def revert_to(self, num: int) -> int:
        """Roll the chain head back to block ``num`` (reference:
        cmd/harmony's revert tooling / core RevertChain): resets the
        head pointer and live state to the target block and drops the
        canonical entries above it.  Returns how many blocks were
        reverted.  State snapshots/bodies above stay in the KV store
        (log-structured; unreachable entries are harmless), the
        canonical number index is what defines the chain."""
        with self._insert_lock:
            head = self.head_number
            if num >= head:
                return 0
            target = self.header_by_number(num)
            if target is None:
                raise ChainError(f"no canonical block {num} to revert to")
            batch = WriteBatch()
            for n in range(head, num, -1):
                # un-mark cx batches the reverted block consumed —
                # re-syncing the same block must not read as a double
                # spend (the whole point of reverting is to replay)
                block = self.block_by_number(n)
                if block is not None:
                    for proof in block.incoming_receipts:
                        try:
                            src = rawdb.decode_header(proof.header_bytes)
                        except (ValueError, IndexError):
                            continue
                        rawdb.delete_cx_spent(
                            batch, src.shard_id, src.block_num
                        )
                rawdb.delete_canonical(self.db, n, w=batch)
            rawdb.write_head_number(batch, num)
            # the whole revert is ONE atomic commit: a crash mid-revert
            # must not leave the head pointing above deleted blocks
            commit_batch(self.db, batch)
            self._head_num = num
            self._state = self._load_state_at(num)
            self._committee_cache.clear()
            return head - num

    def verify_incoming_receipts(self, block: Block) -> list:
        """Reject unauthenticated / double-spent CX batches (reference:
        core/blockchain_impl.go:441-478 VerifyIncomingReceipts).  Raises
        ChainError; returns the (from_shard, block_num) keys so insert
        can mark them spent without re-decoding."""
        seen: list = []
        for proof in block.incoming_receipts:
            try:
                src = rawdb.decode_header(proof.header_bytes)
            except (ValueError, IndexError) as e:
                raise ChainError(f"bad cx proof header: {e}") from e
            key = (src.shard_id, src.block_num)
            spender = rawdb.cx_spender(self.db, *key)
            if key in seen or (
                spender is not None and spender != block.block_num
            ):
                # spent by a DIFFERENT block = double spend; spent by
                # THIS block num = an idempotent re-insert (a replay
                # sync walking over a fast-synced range)
                raise ChainError("cx receipt batch double spend")
            seen.append(key)
            if not verify_cx_proof(proof, self.shard_id, self.engine,
                                   self.config):
                raise ChainError(
                    f"invalid cx proof from shard {src.shard_id} "
                    f"block {src.block_num}"
                )
        return seen

    def _resolve_and_verify(self, blocks, commit_sigs, parent,
                            verify_seals, lane=None):
        """Shared insert front-half (replay and fast-sync paths):
        structural checks against ``parent``, commit-proof resolution
        (blocks[i+1]'s carried header proof fills a None — the replay
        pattern, sig_verify.go:37-48), and ONE batched seal
        verification across the window.  Returns (blocks, proofs).
        ``lane`` is the verification-scheduler priority lane for the
        seal batch (None = the engine's default, the sync lane).
        """
        if commit_sigs is None:
            commit_sigs = [None] * len(blocks)
        proofs = []
        for i, block in enumerate(blocks):
            self._verify_structure(block, parent)
            proof = commit_sigs[i]
            if proof is None:
                nxt = (blocks[i + 1].header if i + 1 < len(blocks) else None)
                if nxt is not None and nxt.last_commit_sig:
                    proof = nxt.last_commit_sig + nxt.last_commit_bitmap
            proofs.append(proof)
            parent = block.header

        if verify_seals:
            if self.engine is None:
                raise ChainError("no engine wired; verify_seals=True")
            items, flags = [], []
            for block, proof in zip(blocks, proofs):
                if proof is None:
                    raise ChainError(
                        f"no commit proof for block {block.block_num}"
                    )
                sig, bitmap = proof[:96], proof[96:]
                items.append((block.header, sig, bitmap))
                flags.append(self.config.is_staking(block.header.epoch))
            with replay_stage("seal_verify", blocks=len(items)):
                ok = self.engine.verify_headers_batch(
                    items, flags, lane=lane
                )
            for block, good in zip(blocks, ok):
                if not good:
                    raise ChainError(
                        f"bad commit signature on block {block.block_num}"
                    )
        return blocks, proofs

    # -- fast (state) sync --------------------------------------------------

    def insert_headers_fast(self, blocks: list,
                            commit_sigs: list | None = None,
                            verify_seals: bool = True) -> int:
        """State-LESS insert for fast sync (reference:
        api/service/stagedstreamsync — the blockhashes/bodies stages
        persist verified blocks ahead of the states stage): structural
        checks + batched seal verification + block/proof persistence,
        WITHOUT execution and without moving the head.  The head and
        state move together in :meth:`adopt_state` once the account
        range download completes.  The CX spent-set IS reconstructed —
        each downloaded block's carried incoming_receipts name exactly
        the (from_shard, num) batches its committee consumed, and the
        blocks are seal-verified — so a fast-synced node later serving
        as leader cannot re-propose an already-credited batch.
        """
        if not blocks:
            return 0
        with self._insert_lock:
            first = blocks[0].block_num
            parent = self.header_by_number(first - 1)
            if parent is None:
                raise ChainError(f"fast insert with no parent {first - 1}")
            # pre-resolve carried proofs from the FULL window so
            # segmenting below can't lose a block's proof to a
            # boundary (blocks[i+1] holds blocks[i]'s commit proof)
            if commit_sigs is None:
                commit_sigs = [None] * len(blocks)
            commit_sigs = list(commit_sigs)
            for i in range(len(blocks) - 1):
                nxt = blocks[i + 1].header
                if commit_sigs[i] is None and nxt.last_commit_sig:
                    commit_sigs[i] = (
                        nxt.last_commit_sig + nxt.last_commit_bitmap
                    )
            # committees chain forward through the SEALED headers:
            # an election block (non-empty header.shard_state, sealed
            # by the current committee) carries the next epoch's
            # committee, so verify in segments and harvest each
            # boundary before verifying the blocks it elects for.
            # This is what makes fast sync trustless — no committee
            # bytes are ever taken from a sync peer unverified
            # (reference: stagedstreamsync + epochchain.go ShardState)
            start = 0
            for i, block in enumerate(blocks):
                if not (i == len(blocks) - 1
                        or block.header.shard_state):
                    continue
                seg = blocks[start:i + 1]
                seg, proofs = self._resolve_and_verify(
                    seg, commit_sigs[start:i + 1], parent, verify_seals
                )
                for b, proof in zip(seg, proofs):
                    # one atomic batch per fast block: reopen never
                    # sees a block without its proof or spent marks
                    batch = WriteBatch()
                    rawdb.write_block(batch, b, self.config.chain_id)
                    if proof is not None:
                        rawdb.write_commit_sig(batch, b.block_num, proof)
                    for cxp in b.incoming_receipts:
                        try:
                            src = rawdb.decode_header(cxp.header_bytes)
                        except (ValueError, IndexError,
                                UnicodeDecodeError) as e:
                            raise ChainError(
                                f"bad cx proof header in fast block "
                                f"{b.block_num}: {e}"
                            ) from e
                        rawdb.write_cx_spent(
                            batch, src.shard_id, src.block_num,
                            spender=b.block_num,
                        )
                    if b.header.shard_state:
                        rawdb.write_shard_state(
                            batch, b.header.epoch + 1,
                            rawdb.decode_shard_state(b.header.shard_state),
                        )
                    commit_batch(self.db, batch)
                    if b.header.shard_state:
                        self._committee_cache.pop(
                            b.header.epoch + 1, None
                        )
                parent = block.header
                start = i + 1
            return len(blocks)

    def adopt_state(self, num: int, state: StateDB) -> None:
        """Bind a downloaded StateDB to the stored header at ``num`` and
        move the head there — completion of the fast-sync states stage.
        The binding check is the chain's own state commitment
        (config.state_root: flat keccak or the epoch-gated MPT root), so
        a peer cannot serve a forged account set: the header root was
        already sealed by the committee's verified aggregate signature.
        """
        with self._insert_lock:
            header = self.header_by_number(num)
            if header is None:
                raise ChainError(f"adopt_state: no header {num}")
            if self.config.state_root(state, header.epoch) != header.root:
                raise ChainError(
                    "adopt_state: downloaded accounts do not match the "
                    f"sealed state root of block {num}"
                )
            batch = WriteBatch()
            rawdb.write_state(batch, header.root, state.serialize())
            rawdb.write_head_number(batch, num)
            # state + head move TOGETHER: a crash between them would
            # otherwise leave a head with no state to serve
            commit_batch(self.db, batch)
            self._head_num = num
            self._state = state
            self._committee_cache.clear()

    def write_synced_receipts(self, num: int, receipts: list) -> None:
        """Persist receipts fetched by the fast-sync receipts stage for
        a block in the skipped (unexecuted) range."""
        rawdb.write_receipts(self.db, num, receipts)

    def insert_chain(self, blocks: list, commit_sigs: list | None = None,
                     verify_seals: bool = True, lane=None) -> int:
        """Insert consecutive blocks; returns how many were inserted.

        ``commit_sigs[i]`` is the [96B sig || bitmap] proof for
        blocks[i]; where None, the proof is taken from blocks[i+1]'s
        header (the replay pattern — sig_verify.go:37-48).  Seal
        verification is batched across the insert through the engine;
        ``lane`` picks the scheduler lane (the consensus commit path
        passes its CONSENSUS lane, replay/sync take the default).  A
        seal check bound for the card that cannot run raises
        ``device.DeviceError`` out of the insert, which stores nothing.
        """
        if not blocks:
            return 0
        with self._insert_lock:
            return self._insert_chain_locked(
                blocks, commit_sigs, verify_seals, lane
            )

    def _insert_chain_locked(self, blocks, commit_sigs, verify_seals,
                             lane=None):
        if commit_sigs is None:
            commit_sigs = [None] * len(blocks)

        # blocks the OTHER writer already landed are skipped
        # idempotently (a sync pass and a consensus commit can race to
        # the same height); proofs stay aligned with their blocks
        pairs = [
            (b, s) for b, s in zip(blocks, commit_sigs)
            if b.block_num > self.head_number
        ]
        if not pairs:
            return 0
        blocks = [b for b, _ in pairs]
        commit_sigs = [s for _, s in pairs]

        # pre-resolve carried proofs over the FULL window (blocks[i+1]
        # holds blocks[i]'s proof) so the epoch segmentation below
        # can't lose the proof of a segment's last block
        commit_sigs = list(commit_sigs)
        for i in range(len(blocks) - 1):
            nxt = blocks[i + 1].header
            if commit_sigs[i] is None and nxt.last_commit_sig:
                commit_sigs[i] = (
                    nxt.last_commit_sig + nxt.last_commit_bitmap
                )

        # a replay window crossing an election boundary must verify in
        # SEGMENTS: the blocks after an election block (non-empty
        # header.shard_state) are sealed by the committee that election
        # seats, which this chain only learns by EXECUTING the election
        # block.  One up-front batch verified them against the stale
        # committee and rejected every honest post-boundary block (the
        # chaos sweep's election scenario found this — replay across
        # epoch 0 -> 1 failed with "bad commit signature").  Same
        # segmentation as insert_headers_fast.
        inserted = 0
        parent = self.current_header()
        start = 0
        for i, block in enumerate(blocks):
            if not (i == len(blocks) - 1 or block.header.shard_state):
                continue
            seg, seg_proofs = self._resolve_and_verify(
                blocks[start:i + 1], commit_sigs[start:i + 1],
                parent, verify_seals, lane,
            )
            inserted += self._execute_segment(seg, seg_proofs)
            parent = block.header
            start = i + 1
        return inserted

    def _execute_segment(self, blocks, proofs):
        """Execution + persistence pass over verified blocks.

        EVERY per-block write — block, state, receipts, commit proof,
        spent marks, outgoing cx, elected shard state, head pointer —
        stages into ONE WriteBatch committed atomically (the role of
        the reference's WriteBlockWithState batch over LevelDB): a
        crash at any byte of the commit leaves the previous head fully
        intact, never a block without its state or proof."""
        inserted = 0
        for block, proof in zip(blocks, proofs):
            with replay_stage("execute", block=block.block_num):
                spent_keys = self.verify_incoming_receipts(block)
                state, result, elected = self._execute(block)
            with replay_stage("kv_commit", block=block.block_num):
                batch = WriteBatch()
                for from_shard, num in spent_keys:
                    rawdb.write_cx_spent(
                        batch, from_shard, num, spender=block.block_num
                    )
                if elected is not None:
                    rawdb.write_shard_state(
                        batch, elected.epoch, elected
                    )
                rawdb.write_block(batch, block, self.config.chain_id)
                rawdb.write_state(
                    batch, block.header.root, state.serialize()
                )
                rawdb.write_receipts(
                    batch, block.block_num,
                    result.receipts + result.staking_receipts,
                )
                if proof is not None:
                    rawdb.write_commit_sig(
                        batch, block.block_num, proof
                    )
                by_shard: dict[int, list] = {}
                for cx in result.outgoing_cx:
                    by_shard.setdefault(cx.to_shard, []).append(cx)
                for to_shard, cxs in by_shard.items():
                    rawdb.write_outgoing_cx(
                        batch, to_shard, block.block_num, cxs
                    )
                rawdb.write_head_number(batch, block.block_num)
                commit_batch(self.db, batch)
            if elected is not None:
                self._committee_cache.pop(elected.epoch, None)
            if self.state_retention:
                # incremental prune AFTER the commit: the state falling
                # out of the retention window (O(1) per insert;
                # core/snapshot.py).  Losing a prune to a crash costs
                # one extra state blob, never consistency.
                from .snapshot import prune_state_at

                prune_state_at(
                    self, block.block_num - self.state_retention
                )
            self._head_num = block.block_num
            self._state = state
            inserted += 1
        return inserted
