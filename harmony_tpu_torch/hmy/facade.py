"""Harmony facade: chain/txpool/staking reads behind one object.

Behavioral parity with the reference's facade (reference:
hmy/hmy.go:48-85: BlockChain + TxPool + caches for leader, total
stake, validator information; rpc namespaces call only this).

The port's copy of the JAX package's ``hmy/facade.py``.
"""

from __future__ import annotations

import threading

from ..core import rawdb
from ..core.tx_pool import PoolError


class Harmony:
    def __init__(self, chain, tx_pool=None, node=None):
        self.chain = chain
        self.tx_pool = tx_pool
        self.node = node  # optional: consensus state reads
        self._lock = threading.Lock()
        self._total_stake_cache: tuple | None = None  # (epoch, value)

    # -- chain reads --------------------------------------------------------

    def block_number(self) -> int:
        return self.chain.head_number

    def header_by_number(self, num: int):
        return self.chain.header_by_number(num)

    def block_by_number(self, num: int):
        if num < 0:  # "latest"
            num = self.chain.head_number
        return self.chain.block_by_number(num)

    def block_by_hash(self, block_hash: bytes):
        return self.chain.block_by_hash(block_hash)

    def get_balance(self, address: bytes, block_num: int | None = None):
        if block_num is None or block_num >= self.chain.head_number:
            return self.chain.state().balance(address)
        return self.chain.state_at(block_num).balance(address)

    def get_nonce(self, address: bytes) -> int:
        return self.chain.state().nonce(address)

    def get_cx_receipt_by_hash(self, tx_hash: bytes):
        """The outgoing cross-shard receipt a source-shard tx produced
        (reference: rpc hmyv2_getCXReceiptByHash).  Also the operator's
        re-export handle when the committing leader's broadcast was
        lost: any validator holds the same rawdb batch."""
        from ..core import rawdb

        num = rawdb.read_receipt_block_num(self.chain.db, tx_hash)
        if num is None:
            return None
        block = self.chain.block_by_number(num)
        if block is None:
            return None
        tx = next(
            (t for t in block.transactions
             if t.hash(self.chain.config.chain_id) == tx_hash), None
        )
        if tx is None or not tx.is_cross_shard():
            return None
        for cx in self.chain.outgoing_cx(tx.to_shard, num):
            if cx.tx_hash == tx_hash:
                return cx
        return None

    def get_proof(self, address: bytes, slots: list,
                  block_num: int | None = None):
        """eth_getProof backing: (mpt_root, account leaf, account
        proof nodes, storage proofs) at a block's state."""
        if block_num is None or block_num >= self.chain.head_number:
            state = self.chain.state()
        else:
            state = self.chain.state_at(block_num)
        return state.account_proof(address, slots)

    def chain_id(self) -> int:
        return self.chain.config.chain_id

    def shard_id(self) -> int:
        return self.chain.shard_id

    def current_epoch(self) -> int:
        return self.chain.epoch_of(self.chain.head_number)

    def committee(self, epoch: int | None = None) -> list:
        if epoch is None:
            epoch = self.current_epoch()
        return self.chain.committee_for_epoch(epoch)

    def read_commit_sig(self, num: int):
        return self.chain.read_commit_sig(num)

    def get_transaction(self, tx_hash: bytes):
        """(block_num, index, tx) or None — linear scan fallback; an
        index column is a straightforward rawdb extension."""
        for num in range(self.chain.head_number, 0, -1):
            block = self.chain.block_by_number(num)
            if block is None:
                continue
            for i, tx in enumerate(block.transactions):
                if tx.hash(self.chain.config.chain_id) == tx_hash:
                    return num, i, tx
        return None

    def get_receipt(self, tx_hash: bytes):
        """(block_num, index, receipt) or None (reference:
        rpc GetTransactionReceipt over the rawdb tx-hash index)."""
        from ..core import rawdb

        num = rawdb.read_receipt_block_num(self.chain.db, tx_hash)
        if num is None:
            return None
        for i, rc in enumerate(rawdb.read_receipts(self.chain.db, num)):
            if rc.tx_hash == tx_hash:
                return num, i, rc
        return None

    def get_logs(self, from_block: int, to_block: int,
                 address: bytes | None = None,
                 topics: list | None = None) -> list:
        """Matching logs as (block_num, tx_hash, log_index, addr,
        topics, data) tuples (reference: eth filters GetLogs)."""
        from ..core import rawdb

        out = []
        to_block = min(to_block, self.chain.head_number)
        for num in range(max(from_block, 1), to_block + 1):
            idx = 0
            for rc in rawdb.read_receipts(self.chain.db, num):
                for addr, tps, data in rc.logs:
                    match = address is None or addr == address
                    if match and topics:
                        for want, got in zip(topics, tps):
                            if want is not None and want != got:
                                match = False
                                break
                        if len(topics) > len(tps):
                            match = False
                    if match:
                        out.append((num, rc.tx_hash, idx, addr, tps, data))
                    idx += 1
        return out

    def get_code(self, address: bytes) -> bytes:
        return self.chain.state().code(address)

    def get_storage_at(self, address: bytes, slot: bytes) -> int:
        return self.chain.state().storage_get(address, slot)

    def call(self, frm: bytes, to: bytes | None, value: int,
             data: bytes, gas: int, trace: bool = False):
        """Read-only EVM simulation against the head state (reference:
        rpc Call / DoEVMCall).  Returns (ok, gas_left, output, tracer)."""
        from ..core.vm import EVM, CallTracer, Env

        state = self.chain.state().copy()
        env = Env(
            block_num=self.chain.head_number,
            chain_id=self.chain.config.chain_id,
            epoch=self.current_epoch(),
            shard_id=self.chain.shard_id,
        )
        tracer = CallTracer() if trace else None
        evm = EVM(state, env, origin=frm, gas_price=1, tracer=tracer)
        if to is None:
            ok, gas_left, out = evm.create(frm, value, data, gas)
        else:
            ok, gas_left, out = evm.call(frm, to, value, data, gas)
        return ok, gas_left, out, tracer

    def estimate_gas(self, frm: bytes, to: bytes | None, value: int,
                     data: bytes) -> int:
        """Binary-search the minimum sufficient gas (reference:
        rpc EstimateGas shape, simplified to one upper-bound probe +
        bisection)."""
        hi = 10_000_000
        ok, gas_left, _, _ = self.call(frm, to, value, data, hi)
        if not ok:
            raise ValueError("execution reverts at gas cap")
        lo, best = 21000, hi
        while lo <= best:
            mid = (lo + best) // 2
            ok, _, _, _ = self.call(frm, to, value, data, mid)
            if ok:
                best = mid - 1
            else:
                lo = mid + 1
        return lo

    # -- staking reads ------------------------------------------------------

    def validator_addresses(self) -> list:
        return self.chain.state().validator_addresses()

    def validator_information(self, address: bytes):
        w = self.chain.state().validator(address)
        if w is None:
            return None
        return {
            "address": "0x" + address.hex(),
            "bls_keys": [k.hex() for k in w.bls_keys],
            "total_delegation": w.total_delegation(),
            "self_delegation": w.self_delegation(),
            "min_self_delegation": w.min_self_delegation,
            "commission_rate": w.commission_rate,
            "status": ("active", "inactive", "banned")[w.status],
            "blocks_signed": w.blocks_signed,
            "blocks_to_sign": w.blocks_to_sign,
            "last_epoch_in_committee": w.last_epoch_in_committee,
            "delegations": [
                {
                    "delegator": "0x" + d.delegator.hex(),
                    "amount": d.amount,
                    "reward": d.reward,
                    "undelegations": [
                        {"amount": a, "epoch": e}
                        for a, e in d.undelegations
                    ],
                }
                for d in w.delegations
            ],
        }

    def delegations_by_delegator(self, delegator: bytes) -> list:
        """Every (validator, amount, reward) this address delegates to
        (reference: rpc GetDelegationsByDelegator)."""
        out = []
        state = self.chain.state()
        for addr in state.validator_addresses():
            w = state.validator(addr)
            for d in w.delegations:
                if d.delegator == delegator:
                    out.append({
                        "validator_address": "0x" + addr.hex(),
                        "delegator_address": "0x" + delegator.hex(),
                        "amount": d.amount,
                        "reward": d.reward,
                        "undelegations": [
                            {"amount": a, "epoch": e}
                            for a, e in d.undelegations
                        ],
                    })
        return out

    def delegations_by_validator(self, validator: bytes) -> list:
        """All delegations into one validator (reference:
        rpc GetDelegationsByValidator)."""
        w = self.chain.state().validator(validator)
        if w is None:
            return []
        return [
            {
                "validator_address": "0x" + validator.hex(),
                "delegator_address": "0x" + d.delegator.hex(),
                "amount": d.amount,
                "reward": d.reward,
                "undelegations": [
                    {"amount": a, "epoch": e} for a, e in d.undelegations
                ],
            }
            for d in w.delegations
        ]

    def elected_validator_addresses(self) -> list:
        """Validators in the CURRENT epoch's committee (reference:
        rpc GetElectedValidatorAddresses)."""
        state = self.chain.shard_state_for_epoch(self.current_epoch())
        if state is None:
            return []
        out = set()
        for com in state.shards:
            for slot in com.slots:
                if slot.effective_stake is not None:
                    out.add(slot.ecdsa_address)
        return sorted(out)

    def median_raw_stake_snapshot(self):
        """The EPoS median-stake view of the upcoming auction
        (reference: rpc GetMedianRawStakeSnapshot over
        staking/effective's compute) — same eligibility filter and
        slot budget as the real election (chain/finalize.py elect)."""
        from ..staking.effective import SlotOrder, compute

        state = self.chain.state()
        orders = {}
        for addr in state.validator_addresses():
            w = state.validator(addr)
            if w.status != 0 or not w.bls_keys:
                continue
            if w.self_delegation() < w.min_self_delegation:
                continue
            orders[addr] = SlotOrder(
                stake=w.total_delegation(),
                spread_among=list(w.bls_keys),
                address=addr,
            )
        if not orders:
            return {"median_raw_stake": "0", "slot_count": 0}
        fin = getattr(self.chain, "finalizer", None)
        if fin is not None and getattr(fin, "cfg", None) is not None:
            pull = (
                fin.cfg.external_slots_per_shard * fin.cfg.shard_count
            )
        else:  # no finalizer wired (dev chains): whole candidate set
            pull = sum(len(o.spread_among) for o in orders.values())
        med, purchases = compute(orders, pull)
        return {
            "median_raw_stake": str(med),
            "slot_count": len(purchases),
        }

    def total_staking(self) -> int:
        """Network total delegation (cached per epoch — hmy.go:73
        totalStakeCache)."""
        epoch = self.current_epoch()
        with self._lock:
            if (
                self._total_stake_cache is not None
                and self._total_stake_cache[0] == epoch
            ):
                return self._total_stake_cache[1]
        state = self.chain.state()
        total = sum(
            state.validator(a).total_delegation()
            for a in state.validator_addresses()
        )
        with self._lock:
            self._total_stake_cache = (epoch, total)
        return total

    # -- writes -------------------------------------------------------------

    def send_raw_transaction(self, blob: bytes) -> bytes:
        """Decode, admit to the pool, return the tx hash (reference:
        SendRawTransaction -> AddPendingTransaction)."""
        if self.tx_pool is None:
            raise PoolError("node has no transaction pool")
        tx = rawdb.decode_tx(blob)
        # RPC-submitted txs are LOCAL: journaled across restarts
        # (reference: tx_journal.go locals semantics)
        self.tx_pool.add(tx, local=True)
        return tx.hash(self.chain.config.chain_id)

    def send_raw_staking_transaction(self, blob: bytes) -> bytes:
        if self.tx_pool is None:
            raise PoolError("node has no transaction pool")
        tx = rawdb.decode_staking_tx(blob)
        self.tx_pool.add(tx, is_staking=True, local=True)
        return tx.hash(self.chain.config.chain_id)
