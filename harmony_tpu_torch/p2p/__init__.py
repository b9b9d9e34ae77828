"""Host-side networking: gossip, discovery-lite, gating, sync streams.

The role of the reference's libp2p stack (reference: p2p/host.go:59-80
Host interface, gossipsub topics, p2p/gating + p2p/security peer
control, p2p/stream request/response sync — SURVEY.md §2.5), rebuilt
on the standard library: the WAN gossip layer is host CPU work by
nature (SURVEY.md §2.5 "TPU-relevant note") — the device boundary is
the crypto batch, not the socket.

- groups:   topic naming per (network, shard, purpose);
- host:     Host API with an in-process hub (tests/localnet-in-one-
            process) and a TCP flood-gossip implementation;
- gating:   connection limits and blocklists;
- stream:   length-prefixed request/response sync protocol.

The port's copy of the JAX package's ``p2p/__init__.py``.
"""

from .gating import Gater
from .groups import GroupID, aggregation_topic, consensus_topic, node_topic, slash_topic
from .host import Host, InProcessNetwork, TCPHost

__all__ = [
    "Gater",
    "GroupID",
    "Host",
    "InProcessNetwork",
    "TCPHost",
    "aggregation_topic",
    "consensus_topic",
    "node_topic",
    "slash_topic",
]
