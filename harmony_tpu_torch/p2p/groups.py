"""Gossip topic naming.

Behavioral parity with the reference's group ids (reference:
internal/configs/node/group.go — per-(network, shard, purpose) topic
strings; p2p/host.go:73 SendMessageToGroups publishes to them): one
topic per shard for consensus-bound traffic, one for client/node
traffic, a global one for cross-shard links on the beacon.

The port's copy of the JAX package's ``p2p/groups.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GroupID:
    network: str  # "mainnet", "testnet", "localnet", ...
    shard_id: int
    purpose: str  # "consensus" | "node" | "client" | "crosslink"

    def topic(self) -> str:
        return f"harmony-tpu/{self.network}/{self.shard_id}/{self.purpose}"


def consensus_topic(network: str, shard_id: int) -> str:
    return GroupID(network, shard_id, "consensus").topic()


def node_topic(network: str, shard_id: int) -> str:
    return GroupID(network, shard_id, "node").topic()


def client_topic(network: str, shard_id: int) -> str:
    return GroupID(network, shard_id, "client").topic()


def crosslink_topic(network: str) -> str:
    """Beacon-chain bound (shard 0) cross-link submissions."""
    return GroupID(network, 0, "crosslink").topic()


def aggregation_topic(network: str, shard_id: int, slot: int) -> str:
    """Per-SLOT directed topic for the Handel vote-aggregation overlay
    (consensus.aggregation): a node subscribes only to the topics of
    slots it holds keys for, so publishing a partial aggregate to a
    slot's topic reaches exactly that slot's owner on both transports
    — the overlay's point-to-point edges over gossip plumbing."""
    return GroupID(network, shard_id, f"aggregation/{slot}").topic()


def slash_topic(network: str, shard_id: int) -> str:
    """Double-sign evidence gossip (the reference publishes slashing
    candidates so non-leader observers aren't silenced; records dedup
    by evidence fingerprint on receipt)."""
    return GroupID(network, shard_id, "slash").topic()
