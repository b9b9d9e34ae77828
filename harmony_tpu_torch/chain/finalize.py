"""Block finalization: rewards, availability, and the epoch election.

The role of the reference's Finalize (reference:
internal/chain/engine.go:266-357: reward accumulation + availability
bookkeeping each block, undelegation payouts / EPoS status mutation /
committee election at the epoch boundary; block rewards pro-rata by
vote in internal/chain/reward.go:245).

Ordering contract: every step here runs identically on the proposer
(worker) and on replay (blockchain), BEFORE the header's state root is
sealed/checked — rewards and election results are consensus state.

The port's copy of the JAX package's ``chain/finalize.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import trace
from ..consensus.mask import bits_from_bytes
from ..numeric import Dec, new_dec
from ..staking.availability import SIGNING_THRESHOLD
from ..staking.effective import SlotOrder
from ..shard.committee import State as ShardState
from ..shard.committee import epos_staked_committee

# reference: internal/chain/reward.go — the staked-era base block reward
# (28 ONE in atto)
BASE_STAKED_REWARD = 28 * 10**18
COMMISSION_DENOM = 10**18


@dataclass
class FinalizeConfig:
    block_reward: int = BASE_STAKED_REWARD
    shard_count: int = 1
    external_slots_per_shard: int = 0
    harmony_accounts: list = field(default_factory=list)
    extended_bound: bool = False  # EPoS 0.35 bound gate


class Finalizer:
    """Applies per-block and per-epoch finalization to a StateDB."""

    def __init__(self, cfg: FinalizeConfig):
        self.cfg = cfg

    # -- per block ----------------------------------------------------------

    def finalize_block(self, state, committee: ShardState | None,
                       shard_id: int, prev_bitmap: bytes | None):
        """Reward + availability for ONE block, driven by the PREVIOUS
        block's commit bitmap (engine.go:266-357: Finalize looks one
        block back because the current block's signers aren't known
        until its child carries the proof)."""
        if committee is None or prev_bitmap is None:
            return
        com = committee.find_committee(shard_id)
        if com is None:
            return
        keys = com.bls_pubkeys()
        try:
            bits = bits_from_bytes(prev_bitmap, len(keys))
        except ValueError:
            return
        with trace.span("chain.finalize_block", component="chain",
                        shard=shard_id, slots=len(com.slots)):
            self._increment_counters(state, com, bits)
            self._accumulate_rewards(state, com, bits)

    def _slot_validator(self, state, slot):
        if slot.effective_stake is None:
            return None  # Harmony-operated slots earn no staking reward
        return state.validator(slot.ecdsa_address)

    def _increment_counters(self, state, com, bits):
        """measure.go:129-139 IncrementValidatorSigningCounts."""
        for slot, signed in zip(com.slots, bits):
            w = self._slot_validator(state, slot)
            if w is None:
                continue
            # per-SLOT accounting: a validator filling k slots is
            # expected to sign with all k keys (measure.go counts per
            # committee membership)
            w.blocks_to_sign += 1
            if signed:
                w.blocks_signed += 1

    def _accumulate_rewards(self, state, com, bits):
        """Split the block reward among SIGNING external slots pro-rata
        by effective stake (reward.go:245 pro-rata by vote); within a
        validator, commission first, the rest pro-rata by delegation."""
        signers = [
            s for s, b in zip(com.slots, bits)
            if b and s.effective_stake is not None
        ]
        if not signers:
            return
        total = Dec.from_int(0)
        for s in signers:
            total = total.add(s.effective_stake)
        if total.is_zero():
            return
        paid = 0
        reward = self.cfg.block_reward
        for i, slot in enumerate(signers):
            if i == len(signers) - 1:
                share = reward - paid  # exact conservation
            else:
                # Dec scale factors cancel in the ratio
                share = reward * slot.effective_stake.raw // total.raw
            paid += share
            self._credit_validator(state, slot.ecdsa_address, share)

    def _credit_validator(self, state, address: bytes, amount: int):
        w = state.validator(address)
        if w is None or amount <= 0:
            return
        commission = amount * w.commission_rate // COMMISSION_DENOM
        remainder = amount - commission
        total_del = w.total_delegation()
        paid = 0
        for i, d in enumerate(w.delegations):
            if total_del == 0:
                break
            if i == len(w.delegations) - 1:
                share = remainder - paid
            else:
                share = remainder * d.amount // total_del
            paid += share
            d.reward += share
        for d in w.delegations:
            if d.delegator == address:
                d.reward += commission + (remainder if total_del == 0
                                          else 0)
                break

    # -- per epoch ----------------------------------------------------------

    def compute_epos_status(self, state, epoch: int):
        """measure.go:188-233 ComputeAndMutateEPOSStatus: below-threshold
        signers go inactive; counters reset for the new period."""
        for addr in state.validator_addresses():
            w = state.validator(addr)
            if w.status == 2:  # banned stays banned
                continue
            if w.blocks_to_sign > 0:
                ratio = new_dec(w.blocks_signed).quo(
                    new_dec(w.blocks_to_sign)
                )
                if not ratio.gt(SIGNING_THRESHOLD):
                    w.status = 1  # inactive
                elif w.status == 1 and w.self_delegation() >= \
                        w.min_self_delegation:
                    w.status = 0
            w.blocks_signed = 0
            w.blocks_to_sign = 0

    def elect(self, state, epoch: int) -> ShardState:
        """Build next epoch's committees from on-chain validators
        (assignment.go:319-388 eposStakedCommittee)."""
        with trace.span("chain.elect", component="chain", epoch=epoch):
            return self._elect(state, epoch)

    def _elect(self, state, epoch: int) -> ShardState:
        orders = {}
        banned_keys: set = set()
        for addr in state.validator_addresses():
            w = state.validator(addr)
            if w.status == 2:
                # a slashed (banned) validator's KEYS are barred from
                # the auction outright — not just its order: a
                # double-sign key must not re-enter the committee under
                # any order (reference: banned validators never
                # re-elect; status is permanent)
                banned_keys.update(w.bls_keys)
                continue
            if w.status != 0 or not w.bls_keys:
                continue
            if w.self_delegation() < w.min_self_delegation:
                continue
            orders[addr] = SlotOrder(
                stake=w.total_delegation(),
                spread_among=list(w.bls_keys),
                address=addr,
            )
        elected = epos_staked_committee(
            epoch=epoch,
            shard_count=self.cfg.shard_count,
            harmony_accounts=self.cfg.harmony_accounts,
            harmony_per_shard=(
                len(self.cfg.harmony_accounts) // self.cfg.shard_count
            ),
            orders=orders,
            external_slots_total=(
                self.cfg.external_slots_per_shard * self.cfg.shard_count
            ),
            extended_bound=self.cfg.extended_bound,
            exclude_keys=frozenset(banned_keys),
        )
        # membership bookkeeping only for validators actually elected
        # (the reference stamps LastEpochInCommittee from the NEW shard
        # state, not from the candidate set)
        for com in elected.shards:
            for slot in com.slots:
                if slot.effective_stake is None:
                    continue
                w = state.validator(slot.ecdsa_address)
                if w is not None:
                    w.last_epoch_in_committee = epoch
        return elected
