"""Block execution: transfers, staking directives, cross-shard receipts.

The role of the reference's core/state_processor.go (699 LoC: tx,
staking-tx, and incoming-CXReceipt application) plus the staking
message validation of core/staking_verifier.go (SURVEY.md §2.4).
Contract transactions execute through core/vm.py (the interpreter
replacing the reference's go-ethereum EVM fork): ``to=None`` deploys,
a coded ``to`` runs a message call; EVM failures follow Ethereum
semantics — the tx is included with status 0, the fee is charged, the
nonce advances, the value stays with the sender.

Gas model (the subset consensus needs to be deterministic about):
intrinsic 21_000 per plain tx + 68/non-zero byte + 4/zero byte of
data, plus the EVM's per-opcode metering (core/vm.py); refunds capped
at used//2.  Fees are burned here (reward issuance is the engine's job
at Finalize, as in the reference's reward.go).

The port's copy of the JAX package's ``core/state_processor.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .state import Delegation, StateDB, ValidatorWrapper
from .types import (
    CXReceipt,
    Directive,
    Receipt,
    StakingTransaction,
    Transaction,
)

INTRINSIC_GAS = 21_000
STAKING_GAS = 21_000
DATA_GAS_NONZERO = 68
DATA_GAS_ZERO = 4
# EIP-2930 access-list pricing (reference: core/types AccessListTx +
# go-ethereum params): paid in intrinsic gas, pre-warmed for EIP-2929
ACCESS_LIST_ADDR_GAS = 2_400
ACCESS_LIST_SLOT_GAS = 1_900
UNDELEGATION_LOCK_EPOCHS = 7  # reference: staking undelegation maturity


class ExecutionError(ValueError):
    pass


def intrinsic_gas(tx: Transaction) -> int:
    g = INTRINSIC_GAS
    for b in tx.data:
        g += DATA_GAS_NONZERO if b else DATA_GAS_ZERO
    for addr, slots in tx.access_list:
        g += ACCESS_LIST_ADDR_GAS + ACCESS_LIST_SLOT_GAS * len(slots)
    return g


@dataclass
class ProcessResult:
    receipts: list = field(default_factory=list)
    staking_receipts: list = field(default_factory=list)
    outgoing_cx: list = field(default_factory=list)  # CXReceipts to export
    gas_used: int = 0


class StateProcessor:
    """Applies a block's transactions to a StateDB."""

    def __init__(self, chain_id: int, shard_id: int):
        self.chain_id = chain_id
        self.shard_id = shard_id
        self._env = None  # block-level EVM context, set per process()

    # -- plain transactions ------------------------------------------------

    def apply_transaction(
        self, state: StateDB, tx: Transaction, block_num: int,
        cumulative_gas: int,
    ) -> tuple[Receipt, CXReceipt | None]:
        try:
            sender = tx.sender(self.chain_id)
        except ValueError as e:
            raise ExecutionError(f"bad signature: {e}") from e
        if tx.shard_id != self.shard_id:
            raise ExecutionError("tx for a different shard")
        if tx.nonce != state.nonce(sender):
            raise ExecutionError(
                f"bad nonce: want {state.nonce(sender)} got {tx.nonce}"
            )
        gas = intrinsic_gas(tx)
        if tx.gas_limit < gas:
            raise ExecutionError("gas limit below intrinsic gas")
        if state.balance(sender) < tx.gas_limit * tx.gas_price + tx.value:
            raise ExecutionError("insufficient balance for value + fee")

        cx = None
        status = 1
        used = gas
        logs: list = []
        created = b""
        if tx.is_cross_shard():
            # cross-shard: value-transfer only (the reference routes no
            # contract execution across shards); data charged, ignored
            state.sub_balance(sender, gas * tx.gas_price + tx.value)
            state.set_nonce(sender, tx.nonce + 1)
            cx = CXReceipt(
                tx_hash=tx.hash(self.chain_id),
                sender=sender,
                to=tx.to or b"\x00" * 20,
                amount=tx.value,
                from_shard=tx.shard_id,
                to_shard=tx.to_shard,
                block_num=block_num,
            )
        elif tx.to is None or state.code(tx.to) or (
            tx.data and self._is_precompile(tx.to)
        ):
            # EVM path: deploy (to=None) or message call into code.
            # Fee bought upfront at the gas limit, unused gas refunded
            # after — Ethereum semantics; an EVM failure keeps the tx
            # in the block with status 0, fee charged, nonce advanced.
            from .vm import EVM, Env

            state.sub_balance(sender, tx.gas_limit * tx.gas_price)
            env = self._env if self._env is not None else Env(
                block_num=block_num, chain_id=self.chain_id,
                shard_id=self.shard_id,
            )
            evm = EVM(state, env, origin=sender, gas_price=tx.gas_price)
            if tx.to is not None:
                evm.warm_addrs.add(tx.to)  # EIP-2929: tx target warm
            for al_addr, al_slots in tx.access_list:
                # EIP-2930: listed entries start warm (paid above in
                # intrinsic gas)
                evm.warm_addrs.add(al_addr)
                for slot in al_slots:
                    evm.warm_slots.add((al_addr, slot))
            created = b""
            if tx.to is None:
                # evm.create advances the nonce and derives the address
                # from the pre-increment value (tx.nonce)
                ok, gas_left, _addr = evm.create(
                    sender, tx.value, tx.data, tx.gas_limit - gas
                )
                if ok:
                    created = _addr
            else:
                state.set_nonce(sender, tx.nonce + 1)
                ok, gas_left, _out = evm.call(
                    sender, tx.to, tx.value, tx.data, tx.gas_limit - gas
                )
            status = 1 if ok else 0
            logs = [(lg.address, lg.topics, lg.data) for lg in evm.logs]
            state.end_tx()  # settle the EVM frame journal
            used = tx.gas_limit - gas_left
            refund = min(evm.refund if ok else 0, used // 2)
            used -= refund
            state.add_balance(
                sender, (tx.gas_limit - used) * tx.gas_price
            )
        else:
            state.sub_balance(sender, gas * tx.gas_price + tx.value)
            state.set_nonce(sender, tx.nonce + 1)
            if tx.to is not None:
                state.add_balance(tx.to, tx.value)
        receipt = Receipt(
            tx_hash=tx.hash(self.chain_id),
            status=status,
            gas_used=used,
            cumulative_gas=cumulative_gas + used,
            logs=logs,
            contract_address=created,
        )
        return receipt, cx

    def set_env(self, env):
        """Block-level EVM context.  The PROPOSER must set this before
        speculative execution with the same (block_num, timestamp) it
        seals into the header — replay rebuilds the env from the header
        (process()), and any disagreement (e.g. the NUMBER opcode
        seeing a stale height) would fork the state root."""
        self._env = env

    @staticmethod
    def _is_precompile(addr: bytes | None) -> bool:
        from .vm import PRECOMPILES, STAKING_PRECOMPILE_ADDR

        return addr is not None and (
            int.from_bytes(addr, "big") in PRECOMPILES
            or addr == STAKING_PRECOMPILE_ADDR
        )

    def apply_incoming_receipt(self, state: StateDB, cx: CXReceipt):
        """Credit a cross-shard transfer on its destination shard
        (reference: core/state_processor ApplyIncomingReceipt)."""
        if cx.to_shard != self.shard_id:
            raise ExecutionError("cx receipt for a different shard")
        state.add_balance(cx.to, cx.amount)

    # -- staking directives ------------------------------------------------

    def apply_staking_transaction(
        self, state: StateDB, tx: StakingTransaction, epoch: int,
        cumulative_gas: int,
    ) -> Receipt:
        """Atomic: on any failure ``state`` is left untouched (so a
        proposer can skip a failing tx without poisoning its
        speculative state — the root it seals must match replay)."""
        try:
            sender = tx.sender(self.chain_id)
        except ValueError as e:
            raise ExecutionError(f"bad signature: {e}") from e
        if tx.shard_id != self.shard_id:
            # the shard is inside signing_bytes, so this binds the
            # SIGNATURE to one shard — a delegate/undelegate signed for
            # shard 0 must not replay on shard 1 at the same nonce
            raise ExecutionError("staking tx bound to a different shard")
        if tx.nonce != state.nonce(sender):
            raise ExecutionError(
                f"bad nonce: want {state.nonce(sender)} got {tx.nonce}"
            )
        if tx.gas_limit < STAKING_GAS:
            raise ExecutionError("gas limit below staking intrinsic gas")
        fee = STAKING_GAS * tx.gas_price
        if state.balance(sender) < fee:
            raise ExecutionError("insufficient balance for fee")
        work = state.copy()
        work.sub_balance(sender, fee)
        work.set_nonce(sender, tx.nonce + 1)
        handler = {
            Directive.CREATE_VALIDATOR: self._create_validator,
            Directive.EDIT_VALIDATOR: self._edit_validator,
            Directive.DELEGATE: self._delegate,
            Directive.UNDELEGATE: self._undelegate,
            Directive.COLLECT_REWARDS: self._collect_rewards,
        }[tx.directive]
        try:
            handler(work, sender, tx.fields, epoch)
        except ExecutionError:
            raise
        except (ValueError, KeyError, TypeError) as e:
            raise ExecutionError(f"{tx.directive.name}: {e}") from e
        state.absorb(work)
        return Receipt(
            tx_hash=tx.hash(self.chain_id),
            status=1,
            gas_used=STAKING_GAS,
            cumulative_gas=cumulative_gas + STAKING_GAS,
        )

    # validation rules mirror core/staking_verifier.go (SURVEY.md §2.4)

    def _create_validator(self, state, sender, f, epoch):
        if state.validator(sender) is not None:
            raise ExecutionError("validator already exists")
        amount = int(f.get("amount", 0))
        min_self = int(f.get("min_self_delegation", 0))
        if amount <= 0 or min_self < 0:
            raise ExecutionError("self-delegation must be positive")
        if amount < min_self:
            raise ExecutionError("initial self-delegation below minimum")
        keys = f.get("bls_keys")
        if not keys:
            raise ExecutionError("create-validator needs >=1 BLS key")
        if isinstance(keys, bytes):  # packed 48-byte keys
            keys = [keys[i:i + 48] for i in range(0, len(keys), 48)]
        if state.balance(sender) < amount:
            raise ExecutionError("insufficient balance for self-delegation")
        state.sub_balance(sender, amount)
        wrapper = ValidatorWrapper(
            address=sender,
            bls_keys=list(keys),
            commission_rate=int(f.get("commission_rate", 0)),
            max_commission_rate=int(f.get("max_commission_rate", 10**18)),
            max_change_rate=int(f.get("max_change_rate", 10**18)),
            min_self_delegation=min_self,
            max_total_delegation=int(f.get("max_total_delegation", 0)),
            delegations=[Delegation(sender, amount)],
            last_epoch_in_committee=epoch,
        )
        state.set_validator(wrapper)

    def _edit_validator(self, state, sender, f, epoch):
        w = state.validator(sender)
        if w is None:
            raise ExecutionError("no such validator")
        if "commission_rate" in f:
            new_rate = int(f["commission_rate"])
            if new_rate > w.max_commission_rate:
                raise ExecutionError("commission above max")
            if abs(new_rate - w.commission_rate) > w.max_change_rate:
                raise ExecutionError("commission change above max change")
            w.commission_rate = new_rate
        if "add_bls_key" in f:
            k = f["add_bls_key"]
            if k in w.bls_keys:
                raise ExecutionError("key already registered")
            w.bls_keys.append(k)
        if "remove_bls_key" in f:
            k = f["remove_bls_key"]
            if k not in w.bls_keys:
                raise ExecutionError("key not registered")
            if len(w.bls_keys) == 1:
                raise ExecutionError("cannot remove last BLS key")
            w.bls_keys.remove(k)

    def _delegate(self, state, sender, f, epoch):
        validator = f["validator"]
        amount = int(f["amount"])
        w = state.validator(validator)
        if w is None:
            raise ExecutionError("no such validator")
        if amount <= 0:
            raise ExecutionError("delegation must be positive")
        if w.max_total_delegation and (
            w.total_delegation() + amount > w.max_total_delegation
        ):
            raise ExecutionError("exceeds max total delegation")
        state.sub_balance(sender, amount)
        for d in w.delegations:
            if d.delegator == sender:
                d.amount += amount
                return
        w.delegations.append(Delegation(sender, amount))

    def _undelegate(self, state, sender, f, epoch):
        validator = f["validator"]
        amount = int(f["amount"])
        w = state.validator(validator)
        if w is None:
            raise ExecutionError("no such validator")
        if amount <= 0:
            raise ExecutionError("undelegation must be positive")
        for d in w.delegations:
            if d.delegator == sender:
                if d.amount < amount:
                    raise ExecutionError("undelegate exceeds delegation")
                d.amount -= amount
                d.undelegations.append((amount, epoch))
                if (
                    validator == sender
                    and d.amount < w.min_self_delegation
                ):
                    w.status = 1  # below self-delegation floor: inactive
                return
        raise ExecutionError("no delegation to undelegate")

    def _collect_rewards(self, state, sender, f, epoch):
        total = 0
        for addr in state.validator_addresses():
            w = state.validator(addr)
            for d in w.delegations:
                if d.delegator == sender and d.reward:
                    total += d.reward
                    d.reward = 0
        if total == 0:
            raise ExecutionError("no rewards to collect")
        state.add_balance(sender, total)

    # -- undelegation maturity (epoch boundary) ----------------------------

    def payout_undelegations(self, state: StateDB, epoch: int):
        """Release matured undelegations back to delegators (reference:
        internal/chain/engine.go:359 payoutUndelegations)."""
        for addr in state.validator_addresses():
            w = state.validator(addr)
            for d in w.delegations:
                kept, released = [], 0
                for amount, at_epoch in d.undelegations:
                    if epoch >= at_epoch + UNDELEGATION_LOCK_EPOCHS:
                        released += amount
                    else:
                        kept.append((amount, at_epoch))
                if released:
                    d.undelegations = kept
                    state.add_balance(d.delegator, released)

    # -- whole block -------------------------------------------------------

    def process(
        self, state: StateDB, block, epoch: int
    ) -> ProcessResult:
        """Execute a block against ``state`` (mutates it)."""
        from .vm import Env

        h = block.header
        self._env = Env(
            block_num=h.block_num, timestamp=h.timestamp,
            chain_id=self.chain_id, epoch=epoch,
            shard_id=self.shard_id,
        )
        res = ProcessResult()
        for tx, is_staking in block.ordered_txs():
            if is_staking:
                receipt = self.apply_staking_transaction(
                    state, tx, epoch, res.gas_used
                )
                res.staking_receipts.append(receipt)
            else:
                receipt, cx = self.apply_transaction(
                    state, tx, block.block_num, res.gas_used
                )
                res.receipts.append(receipt)
                if cx is not None:
                    res.outgoing_cx.append(cx)
            res.gas_used += receipt.gas_used
        for proof in block.incoming_receipts:
            for cx in proof.receipts:
                self.apply_incoming_receipt(state, cx)
        return res
