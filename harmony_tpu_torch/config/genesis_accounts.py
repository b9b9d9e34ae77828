"""The reference's genesis account tables, loaded from the extracted
data artifact (genesis_accounts.json.gz — built by
tools/extract_genesis.py from reference internal/genesis/*.go).

Chain constants, not code: ~6,800 (index, one1-address, BLS pubkey)
triples across the mainnet foundational eras, Harmony-operated sets,
testnet and localnet tables.  ``committee_slots`` assembles them into
a shard's genesis committee with the reference's round-robin
distribution (reference: shard/committee/assignment.go
preStakingEnabledCommittee — slot j of shard i takes account
i + j*num_shards).

The port's copy of the JAX package's ``config/genesis_accounts.py``.
"""

from __future__ import annotations

import gzip
import json
import os
from functools import lru_cache

_ARTIFACT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "genesis_accounts.json.gz")


@lru_cache(maxsize=1)
def _tables() -> dict:
    with gzip.open(_ARTIFACT, "rb") as f:
        return json.loads(f.read())


def table_names() -> list:
    return sorted(_tables())


def table(name: str) -> list:
    """[(address20, bls_pubkey_48B)] in index order."""
    from ..accounts.bech32 import one_to_address

    entries = _tables().get(name)
    if entries is None:
        raise KeyError(f"no genesis account table {name!r}")
    out = []
    for e in sorted(entries, key=lambda e: e["index"]):
        out.append((one_to_address(e["address"]), bytes.fromhex(e["bls"])))
    return out


def committee_slots(instance, shard_id: int) -> list:
    """Shard ``shard_id``'s genesis committee under a schedule
    Instance: harmony-operated slots then external (foundational)
    slots, each drawn round-robin across shards exactly as the
    reference assigns them (assignment.go: index = i + j*num_shards).

    Returns [(ecdsa_address20, bls_pubkey_48B, is_external)].
    """
    if instance.hmy_accounts_table is None:
        raise ValueError("instance carries no genesis account tables")
    hmy = table(instance.hmy_accounts_table)
    fn = table(instance.fn_accounts_table)
    n = instance.num_shards
    if not 0 <= shard_id < n:
        raise ValueError(f"shard {shard_id} out of range for {n} shards")
    slots = []
    for j in range(instance.harmony_nodes_per_shard):
        addr, bls = hmy[shard_id + j * n]
        slots.append((addr, bls, False))
    for j in range(instance.external_slots_per_shard()):
        addr, bls = fn[shard_id + j * n]
        slots.append((addr, bls, True))
    return slots
