"""Peer discovery: PEX maintenance loop + bootnode entry point.

The reference's discovery service wraps libp2p's Kademlia DHT —
Advertise() announces the node under its shard topic and FindPeers()
streams candidates back (reference: p2p/discovery/discovery.go:41-79),
with bootnodes as the DHT's entry points (cmd/bootnode/main.go).  This
transport keeps the same contract with an explicit peer-exchange
protocol on the TCP flood host (p2p/host.py ADVERT/PEERS_REQ frames):

* every connection ADVERTs its dialable address;
* ``Discovery`` periodically pulls peer lists (PEX) and dials unknown
  addresses until ``target_peers`` connections are live;
* a bootnode is just a Discovery-running host with no consensus stack —
  it learns every ADVERT and answers every PEERS_REQ, seeding the mesh.

All dials go through the host's Gater (p2p/gating.py), so banned /
rate-limited addresses stay unreachable exactly as for inbound peers.

The port's copy of the JAX package's ``p2p/discovery.py``.
"""

from __future__ import annotations

import os
import threading
import time

from ..log import get_logger
from ..ref.keccak import keccak256
from .host import TCPHost

_log = get_logger("discovery")


class RoutingTable:
    """Kademlia-style k-buckets over peer ADDRESSES (node id =
    keccak(addr)): known peers sorted into 256 buckets by XOR-distance
    prefix from our own id, k entries per bucket.  Guarantees the
    stored view spans the WHOLE id space instead of clustering around
    whoever answered PEX first — the property that makes iterative
    closest-first lookups converge in O(log N) steps (the role of
    libp2p's dht routing table under reference:
    p2p/discovery/discovery.go:41-79)."""

    K = 16

    def __init__(self, my_addr: str):
        self.my_id = int.from_bytes(keccak256(my_addr.encode()), "big")
        self._buckets: list[list] = [[] for _ in range(256)]
        self._lock = threading.Lock()

    @staticmethod
    def _id(addr: str) -> int:
        return int.from_bytes(keccak256(addr.encode()), "big")

    def _bucket_of(self, addr: str) -> int:
        d = self._id(addr) ^ self.my_id
        return d.bit_length() - 1 if d else 0

    def add(self, addr: str) -> bool:
        """Insert (LRU within the bucket); full buckets evict the
        oldest entry (no liveness ping on this transport — PEX entries
        are refreshed every pull)."""
        with self._lock:
            b = self._buckets[self._bucket_of(addr)]
            if addr in b:
                b.remove(addr)
            elif len(b) >= self.K:
                b.pop(0)
            b.append(addr)
            return True

    def remove(self, addr: str):
        with self._lock:
            b = self._buckets[self._bucket_of(addr)]
            if addr in b:
                b.remove(addr)

    def closest(self, target: bytes, k: int = K) -> list:
        t = int.from_bytes(target, "big")
        with self._lock:
            allv = [a for b in self._buckets for a in b]
        allv.sort(key=lambda a: self._id(a) ^ t)
        return allv[:k]

    def random_target(self) -> bytes:
        """A uniformly random id — refresh lookups probe the sparse
        regions the PEX gossip never reaches organically."""
        return os.urandom(32)

    def __len__(self):
        with self._lock:
            return sum(len(b) for b in self._buckets)


class Discovery:
    """Routed discovery: k-bucket table + PEX pulls + iterative
    random-target lookups, dialing toward ``target_peers``."""

    def __init__(self, host: TCPHost, bootnodes: list | None = None,
                 target_peers: int = 8, interval: float = 2.0):
        self.host = host
        self.bootnodes = list(bootnodes or [])
        self.target_peers = target_peers
        self.interval = interval
        self.table = RoutingTable(f"127.0.0.1:{host.port}")
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.dials = 0
        self._rounds = 0

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "Discovery":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
        )  # graftlint: thread-role=serving
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()

    # -- the loop -----------------------------------------------------------

    def _my_addr(self) -> str:
        return f"127.0.0.1:{self.host.port}"

    def _dial(self, addr: str) -> bool:
        host_part, _, port_part = addr.rpartition(":")
        try:
            self.host.connect(int(port_part), host_part or "127.0.0.1")
            self.dials += 1
            return True
        except (OSError, ValueError, ConnectionError):
            return False

    def step(self):
        """One maintenance round (callable directly from tests)."""
        me = self._my_addr()
        if self.host.peer_count() == 0 and self.bootnodes:
            for b in self.bootnodes:
                self._dial(b)
        # fold everything the host has learned into the k-buckets
        for addr in list(self.host.known_addrs):
            if addr != me:
                self.table.add(addr)
        if self.host.peer_count() >= self.target_peers:
            # table refresh only: a routed lookup toward a random
            # region every few rounds keeps bucket coverage broad
            self._rounds += 1
            if self._rounds % 4 == 0:
                self.host.request_peers(self.table.random_target())
            return
        # below target: plain PEX pull + a routed lookup toward our own
        # id (closest-first fills our nearest buckets — the peers best
        # placed to answer future lookups for us)
        self.host.request_peers()
        self.host.request_peers(
            keccak256(me.encode())
        )
        connected = self.host.connected_addrs()
        # dial closest-first from the routing table: deterministic
        # convergence instead of whatever order PEX happened to learn
        for addr in self.table.closest(keccak256(me.encode()), k=64):
            if self.host.peer_count() >= self.target_peers:
                break
            if addr == me or addr in connected or addr in self.bootnodes:
                continue
            if self._dial(addr):
                _log.info("pex dial", me=me, peer=addr)
                # one dial per step per address; connection handshake
                # (HELLO+ADVERT) lands asynchronously
                connected.add(addr)
            else:
                self.table.remove(addr)  # dead address: drop the entry

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — keep discovering
                _log.warn("discovery step failed", err=str(e))
            self._stop.wait(self.interval)


def run_bootnode(port: int = 9876, name: str = "bootnode") -> TCPHost:
    """The bootnode entry point (reference: cmd/bootnode/main.go): a
    bare host whose only job is to accumulate ADVERTs and answer
    PEERS_REQs.  Returns the listening host."""
    host = TCPHost(name=name, listen_port=port)
    _log.info("bootnode listening", port=host.port)
    return host


def main(argv=None):
    import argparse
    import signal

    p = argparse.ArgumentParser(description="harmony-tpu bootnode")
    p.add_argument("--port", type=int, default=9876)
    args = p.parse_args(argv)
    # SIGTERM closes the host and exits 0, as Ctrl-C does: a supervisor
    # (a localnet script, systemd) stops a bootnode with SIGTERM
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    host = run_bootnode(args.port)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        host.close()


if __name__ == "__main__":
    main()
