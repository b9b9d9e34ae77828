"""Committee model + EPoS election.

Behavioral parity with the reference's committee assignment (reference:
shard/shard_state.go:28-49 — Slot/Committee/State model;
shard/committee/assignment.go:319-388 — eposStakedCommittee):

- Harmony-operated slots fill round-robin: shard i gets configured
  accounts at indexes i, i + shardCount, i + 2*shardCount, ...;
- the EPoS auction (staking/effective.py) picks external winners, each
  landing on shard (pubkey-as-big-int mod shardCount);
- a committee's device pubkey table (for the device mask/agg-verify path)
  is built once per epoch and cached — the analog of the reference's
  epoch-ctx LRU (reference: internal/chain/engine.go:644-663).

The port's copy of the JAX package's ``shard/committee.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..numeric import Dec
from ..staking import effective


@dataclass
class Slot:
    """reference: shard/shard_state.go:40-49."""

    ecdsa_address: bytes
    bls_pubkey: bytes  # 48-byte serialized form
    effective_stake: Dec | None = None  # None for Harmony-operated slots


@dataclass
class Committee:
    shard_id: int
    slots: list = field(default_factory=list)

    def bls_pubkeys(self):
        return [s.bls_pubkey for s in self.slots]

    def device_pubkey_table(self):
        """(N, 2, 32) affine mont tensor of the committee's pubkeys on the
        node's device (``device.resolve_device()``) — the epoch-keyed
        device-resident table of SURVEY.md §7.3."""
        from .. import device as DV
        from ..ops import interop as I
        from ..ref import bls as RB

        pts = [RB.pubkey_from_bytes(k) for k in self.bls_pubkeys()]
        return I.g1_batch_affine(pts).to(DV.resolve_device())


@dataclass
class State:
    """Per-epoch sharding state: one committee per shard."""

    epoch: int
    shards: list = field(default_factory=list)

    def find_committee(self, shard_id: int) -> Committee | None:
        for c in self.shards:
            if c.shard_id == shard_id:
                return c
        return None


def epos_staked_committee(
    epoch: int,
    shard_count: int,
    harmony_accounts: list,  # [(address, bls_pubkey)] in schedule order
    harmony_per_shard: int,
    orders: dict,  # address -> effective.SlotOrder
    external_slots_total: int,
    extended_bound: bool = False,
    exclude_keys=frozenset(),  # slashed keys barred from the auction
) -> State:
    """Build the epoch committee state: Harmony slots round-robin +
    EPoS auction winners sharded by key value."""
    state = State(epoch=epoch)
    for i in range(shard_count):
        com = Committee(shard_id=i)
        for j in range(harmony_per_shard):
            idx = i + j * shard_count
            addr, pub = harmony_accounts[idx]
            com.slots.append(Slot(ecdsa_address=addr, bls_pubkey=pub))
        state.shards.append(com)

    _, winners = effective.apply(
        orders, external_slots_total, extended_bound, exclude_keys
    )
    for w in winners:
        shard_id = int.from_bytes(w.key, "big") % shard_count
        state.shards[shard_id].slots.append(
            Slot(
                ecdsa_address=w.addr,
                bls_pubkey=w.key,
                effective_stake=w.epos_stake,
            )
        )
    return state
