"""Gossip hosts: publish/subscribe over topics.

The role of the reference's p2p.Host (reference: p2p/host.go:59-80 —
AddStreamProtocol, SendMessageToGroups, subscription with per-topic
validators; gossipsub under the hood).  Two implementations:

- ``InProcessNetwork`` + its hosts — a shared hub delivering messages
  synchronously between hosts in one process: the localnet-in-one-
  process test pattern (the reference's consensus tests likewise run
  real hosts on localhost — SURVEY.md §4).
- ``TCPHost`` — flood gossip over TCP with message-id dedup: each
  frame is [u32 len][u8 kind][payload]; PUBLISH payloads carry
  (topic, msg-id, body) and are re-flooded to every peer except the
  arrival peer until the id is seen.  Validators run before re-flood,
  mirroring gossipsub's validate-then-propagate contract
  (p2p/host.go:92-97 registers 8192-concurrency validators).

Message size cap mirrors the reference's 2 MB (p2p/host.go:98-99).

The port's copy of the JAX package's ``p2p/host.py``.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
import time
from collections import OrderedDict

from ..log import get_logger
from ..metrics import Counter, LockedCounters
from ..ref.keccak import keccak256
from .gating import Gater

_log = get_logger("p2p")

MAX_MESSAGE_BYTES = 2 * 1024 * 1024  # reference: p2p/host.go:98-99

# hostile-wire observability (exposed as harmony_p2p_* via
# metrics.Registry): invalid-message verdicts per transport, the
# throttle/drop/ban ladder, and the worst per-peer score ever
# observed per host (a low-water mark — it does not recover when the
# offending peer disconnects or decays back)
P2P_COUNTERS = LockedCounters(
    "invalid_inproc", "invalid_tcp", "throttled", "conns_dropped",
    "ips_banned", "peers_muted",
)
_WORST_LOCK = threading.Lock()
_WORST_SCORE: dict[str, float] = {}  # host name -> worst live peer score

# consensus-bearing inbound accounting (both transports route every
# subscribed delivery through Host._deliver): how many vote-shaped
# messages each node ingests per phase — THE quantity the Handel
# aggregation overlay exists to shrink at the leader (O(log N)
# aggregates vs N ballots).  Labelled family for /metrics; the
# per-host dict feeds the chaos runner's leader_inbound_msgs_per_round
INBOUND_VOTES = Counter(
    "harmony_consensus_inbound_votes_total",
    "consensus vote-bearing messages delivered, by phase and kind",
)

# CONSENSUS-category envelope types (node.ingress MsgType values; the
# envelope layout [category u8][type u8][payload] is peeked here —
# importing node.ingress would cycle, p2p must stay below node)
_CONSENSUS_KINDS = {
    0: ("prepare", "proposal"),   # ANNOUNCE
    1: ("prepare", "ballot"),     # PREPARE
    2: ("prepare", "proof"),      # PREPARED
    3: ("commit", "ballot"),      # COMMIT
    4: ("commit", "proof"),       # COMMITTED
    5: ("viewchange", "vote"),    # VIEWCHANGE
    6: ("viewchange", "proof"),   # NEWVIEW
}
_AGG_PHASES = {1: "prepare", 2: "commit"}


def _classify_inbound(topic: str, payload: bytes):
    """(phase, kind) of a consensus-bearing delivery, else None."""
    if len(payload) < 3:
        return None
    if topic.endswith("/consensus"):
        if payload[0] != 0x00:  # MessageCategory.CONSENSUS
            return None
        return _CONSENSUS_KINDS.get(payload[1])
    if "/aggregation/" in topic:
        if payload[0] != 0x01 or payload[1] != 0x11:  # NODE / AGG
            return None
        # aggregation body leads with its phase discriminant
        return _AGG_PHASES.get(payload[2], "unknown"), "aggregate"
    return None


def _note_score(host_name: str, score: float):
    with _WORST_LOCK:
        cur = _WORST_SCORE.get(host_name, 0.0)
        _WORST_SCORE[host_name] = min(cur, score)
        if len(_WORST_SCORE) > 256:  # cardinality bound
            _WORST_SCORE.pop(next(iter(_WORST_SCORE)))


def worst_peer_scores() -> dict:
    """Snapshot for metrics exposition (harmony_p2p_peer_score)."""
    with _WORST_LOCK:
        return dict(_WORST_SCORE)
_FRAME = struct.Struct("<IB")
_KIND_PUBLISH = 1
_KIND_HELLO = 2
# peer exchange (the reference's discovery rides libp2p's DHT —
# p2p/discovery/discovery.go:41-79 Advertise/FindPeers; this transport
# carries the same contract as explicit frames: each peer ADVERTs its
# dialable address, and PEERS_REQ/RESP gossip known addresses around)
_KIND_ADVERT = 3      # payload: "ip:port" this peer is dialable at
_KIND_PEERS_REQ = 4   # payload: empty, or a 32B routing target (Kad)
_KIND_PEERS_RESP = 5  # payload: "\n"-joined "ip:port" list
# mesh gossip control frames (gossipsub's GRAFT/PRUNE/IHAVE/IWANT
# roles — reference: p2p/host.go:73-99 rides libp2p gossipsub; this
# transport carries the same degree-bounded mesh + lazy pull protocol
# explicitly)
_KIND_SUBS = 6        # payload: "\n"-joined topic list (full set)
_KIND_GRAFT = 7       # payload: topic — add me to your mesh
_KIND_PRUNE = 8       # payload: topic — drop me from your mesh
_KIND_IHAVE = 9       # payload: [u8 tlen][topic][32B mid]*
_KIND_IWANT = 10      # payload: [32B mid]*

# validator verdicts (gossipsub semantics)
ACCEPT = 0
REJECT = 1   # drop and do not propagate
IGNORE = 2   # drop silently (still counts as seen)


class _SeenCache:
    """Bounded message-id dedup."""

    def __init__(self, cap: int = 65536):
        self._d: OrderedDict[bytes, bool] = OrderedDict()
        self.cap = cap
        self._lock = threading.Lock()

    def seen(self, mid: bytes) -> bool:
        """True if already present; marks it present."""
        with self._lock:
            if mid in self._d:
                self._d.move_to_end(mid)
                return True
            self._d[mid] = True
            while len(self._d) > self.cap:
                self._d.popitem(last=False)
            return False

    def forget(self, mid: bytes):
        """Un-mark a message (shed at an overflow, not processed):
        a later re-flood by another peer must still be ingestible."""
        with self._lock:
            self._d.pop(mid, None)

    def has(self, mid: bytes) -> bool:
        """Non-marking membership probe (IHAVE digest filtering)."""
        with self._lock:
            return mid in self._d


class _MsgCache:
    """Recent full messages by id (gossipsub's mcache): serves IWANT
    pulls and feeds the heartbeat's IHAVE digests.  Bounded by count
    and age."""

    def __init__(self, cap: int = 2048, ttl: float = 60.0):
        self._d: OrderedDict[bytes, tuple] = OrderedDict()  # mid->(topic,body,t)
        self.cap = cap
        self.ttl = ttl
        self._lock = threading.Lock()

    def put(self, mid: bytes, topic: str, body: bytes):
        now = time.monotonic()
        with self._lock:
            self._d[mid] = (topic, body, now)
            self._d.move_to_end(mid)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)

    def get(self, mid: bytes) -> bytes | None:
        with self._lock:
            ent = self._d.get(mid)
        if ent is None or time.monotonic() - ent[2] > self.ttl:
            return None
        return ent[1]

    def recent_ids(self, topic: str, window: float = 6.0) -> list:
        """Message ids for ``topic`` seen within the gossip window."""
        cutoff = time.monotonic() - window
        with self._lock:
            return [mid for mid, (t, _, at) in self._d.items()
                    if t == topic and at >= cutoff]

    def recent_topics(self, window: float = 6.0) -> list:
        """Topics with messages inside the gossip window — includes
        topics this host only PUBLISHES to (gossipsub's fanout): a
        publisher that is not itself subscribed must still advertise
        ids, or a message published before the peer's SUBS announcement
        lands is lost forever."""
        cutoff = time.monotonic() - window
        with self._lock:
            return sorted({t for (t, _, at) in self._d.values()
                           if at >= cutoff})


class Host:
    """Common topic/validator bookkeeping for both transports."""

    def __init__(self, name: str = ""):
        self.name = name
        self._handlers: dict[str, list] = {}
        self._validators: dict[str, list] = {}
        # NOTE: message dedup (_SeenCache) lives on TCPHost only — the
        # in-process hub is single-hop, so every delivery is already
        # exactly-once per publish and re-publishes are deliberately
        # fresh messages (the consensus sender's retry semantics)
        self._lock = threading.Lock()
        # (phase, kind) -> count of consensus-bearing deliveries THIS
        # host actually handled (see _classify_inbound)
        self.inbound_votes: dict[tuple, int] = {}
        # target slot -> count of aggregation contributions delivered
        # to that slot's directed topic: a localnet host multiplexes
        # many committee slots, so per-HOST totals bundle rung traffic
        # a real deployment spreads over one machine per slot — the
        # per-slot split is what lets the chaos runner read off the
        # leader slot's (the ladder's hottest target) actual ingest
        self.inbound_agg_slots: dict[int, int] = {}

    # -- subscription API (reference: host.go:66-71) ------------------------

    def subscribe(self, topic: str, handler):
        """handler(topic, payload, from_name)."""
        with self._lock:
            self._handlers.setdefault(topic, []).append(handler)

    def add_validator(self, topic: str, validator):
        """validator(payload, from_name) -> ACCEPT/REJECT/IGNORE."""
        with self._lock:
            self._validators.setdefault(topic, []).append(validator)

    def topics(self) -> list:
        with self._lock:
            return sorted(set(self._handlers) | set(self._validators))

    def _validate(self, topic: str, payload: bytes, frm: str) -> int:
        with self._lock:
            validators = list(self._validators.get(topic, ()))
        for v in validators:
            verdict = v(payload, frm)
            if verdict != ACCEPT:
                return verdict
        return ACCEPT

    def _deliver(self, topic: str, payload: bytes, frm: str):
        with self._lock:
            handlers = list(self._handlers.get(topic, ()))
        if not handlers:
            return  # the in-process hub delivers to every host; only
            #         a SUBSCRIBED host's ingest counts as inbound
        cls = _classify_inbound(topic, payload)
        if cls is not None:
            with self._lock:
                self.inbound_votes[cls] = self.inbound_votes.get(cls, 0) + 1
                if cls[1] == "aggregate":
                    slot = int(topic.rsplit("/", 1)[1])
                    self.inbound_agg_slots[slot] = (
                        self.inbound_agg_slots.get(slot, 0) + 1
                    )
            INBOUND_VOTES.inc(phase=cls[0], kind=cls[1])
        for h in handlers:
            h(topic, payload, frm)

    # -- to implement -------------------------------------------------------

    def publish(self, topic: str, payload: bytes):
        raise NotImplementedError

    def publish_to_groups(self, topics: list, payload: bytes):
        """reference: p2p/host.go:73 SendMessageToGroups."""
        for t in topics:
            self.publish(t, payload)

    def close(self):
        pass


class InProcessNetwork:
    """Hub connecting InProcess hosts (deterministic, synchronous).

    Carries the same invalid-message scoring ladder as TCPHost (the
    gossipsub score function's role) so in-process Byzantine scenarios
    exercise the REAL defense: every REJECT verdict scores the sender
    down; past ``THROTTLE_FLOOR`` only every other message is routed;
    past ``MUTE_FLOOR`` the sender is muted off the hub entirely."""

    THROTTLE_FLOOR = -24.0
    MUTE_FLOOR = -60.0

    def __init__(self):
        self._hosts: list = []
        self._lock = threading.Lock()
        self.partitioned: set = set()  # names cut off (failure injection)
        self.muted: set = set()        # names dropped for spam
        self.scores: dict[str, float] = {}
        self._throttle_ctr: dict[str, int] = {}
        self.invalid_total = 0         # REJECT verdicts observed
        # optional per-directed-link conditioner
        # (chaostest.netem.NetEm): latency/jitter/loss/dup/reorder/
        # rate per (from, to) host pair — None costs one attribute
        # check on the delivery path
        self.netem = None

    def host(self, name: str) -> "_InProcessHost":
        h = _InProcessHost(name, self)
        with self._lock:
            self._hosts.append(h)
        return h

    def remove(self, host) -> None:
        """Detach a host from the hub (a killed node's process would
        take its sockets with it; the in-process analog must stop
        delivering to — and accepting validation verdicts from — the
        dead node's object, or a restart under the same name would
        leave two receivers)."""
        with self._lock:
            self._hosts = [h for h in self._hosts if h is not host]

    def route(self, topic: str, payload: bytes, frm: str):
        if len(payload) > MAX_MESSAGE_BYTES:
            raise ValueError("message exceeds 2 MB cap")
        if frm in self.partitioned:
            return
        with self._lock:
            if frm in self.muted:
                return  # dropped for spam: nothing propagates
            if self.scores.get(frm, 0.0) <= self.THROTTLE_FLOOR:
                # rate-limit tier: a misbehaving-but-not-yet-dropped
                # sender gets every other message routed
                n = self._throttle_ctr.get(frm, 0) + 1
                self._throttle_ctr[frm] = n
                if n % 2:
                    P2P_COUNTERS.inc("throttled")
                    return
            hosts = list(self._hosts)
        # no dedup on the hub: it is single-hop (each publish visits
        # each host exactly once, no multipath to suppress), and
        # content-hash dedup here marked REJECTED messages seen
        # FOREVER — the consensus sender's retry re-publishes (the
        # mechanism that recovers a transiently IGNOREd NEWVIEW) were
        # dead on arrival for ~50 s until cache eviction.  libp2p ids
        # are (sender, seqno): every publish is a fresh message —
        # TCPHost stamps the same semantics into its PUBLISH bodies.
        nm = self.netem
        if nm is not None and not nm.armed:
            nm = None  # disarmed conditioner: skip closures entirely
        for h in hosts:
            if h.name == frm or h.name in self.partitioned:
                continue
            if nm is not None and nm.send(
                frm, h.name, len(payload),
                lambda h=h: self._deliver_one(
                    topic, payload, frm, h, recheck=True
                ),
            ):
                continue  # conditioned: dropped or scheduled
            self._deliver_one(topic, payload, frm, h)

    def _deliver_one(self, topic: str, payload: bytes, frm: str, h,
                     recheck: bool = False):
        """Validate + deliver to ONE host — the hub's per-link
        delivery chokepoint.  ``recheck`` is set by netem-DELAYED
        deliveries only: a message that spent time in flight must
        re-check partition state and host liveness (its destination
        may have been partitioned or killed meanwhile); the inline
        path already checked all of that in ``route`` and keeps its
        lock-free cost."""
        if recheck:
            if frm in self.partitioned or h.name in self.partitioned:
                return
            with self._lock:
                if frm in self.muted or not any(
                    x is h for x in self._hosts
                ):
                    return
        verdict = h._validate(topic, payload, frm)
        if verdict == ACCEPT:
            h._deliver(topic, payload, frm)
        elif verdict == REJECT:
            self._punish(frm, 1)

    def _punish(self, frm: str, rejects: int):
        """Score a sender down for REJECT verdicts (malformed/bogus
        bytes — IGNORE stays free, exactly the TCPHost contract)."""
        P2P_COUNTERS.inc("invalid_inproc", rejects)
        with self._lock:
            self.invalid_total += rejects
            score = self.scores.get(frm, 0.0) - float(rejects)
            self.scores[frm] = score
            if len(self.scores) > 1024:
                self.scores.pop(next(iter(self.scores)))
            mute = score <= self.MUTE_FLOOR and frm not in self.muted
            if mute:
                self.muted.add(frm)
        _note_score(f"hub:{frm}", score)
        if mute:
            P2P_COUNTERS.inc("peers_muted")
            _log.warn("hub peer muted for spam", peer=frm,
                      score=round(score, 1))


class _InProcessHost(Host):
    def __init__(self, name: str, net: InProcessNetwork):
        super().__init__(name)
        self._net = net

    def publish(self, topic: str, payload: bytes):
        self._net.route(topic, payload, self.name)


class TCPHost(Host):
    """Flood gossip over TCP.

    Peers are symmetric: either side connects (``connect``), both ends
    then exchange HELLO (name) and flood PUBLISH frames.  Validation,
    delivery, and re-flood run on a BOUNDED worker pool, decoupled from
    the per-peer reader threads (reference: p2p/host.go:92-99 — the
    8192-slot validate pool; readers must keep draining sockets while a
    validator does pairing work, and a message flood must translate
    into dropped messages + a counter, not unbounded thread growth).

    Peer scoring (the role of gossipsub's score function): every
    validator IGNORE decrements the sender's score; below the floor
    the peer is dropped and its IP banned through the gater.
    """

    VALIDATE_QUEUE_CAP = 8192  # reference: p2p/host.go maxSize
    VALIDATE_WORKERS = 4
    SCORE_FLOOR = -20.0
    THROTTLE_FLOOR = -10.0  # rate-limit tier BEFORE the drop: half of
    #                         a misbehaving peer's messages shed at
    #                         ingress while its score still decays back
    SCORE_DECAY_PER_S = 0.5  # forgiveness rate for honest mistakes
    # mesh degree bounds (gossipsub's D/D_lo/D_hi): eager push goes to
    # at most MESH_D_HI peers per topic; everyone else gets lazy IHAVE
    # digests on the heartbeat — per-node egress stays bounded as the
    # peer set grows (a flood hub would be O(peers))
    MESH_D = 6
    MESH_D_LO = 4
    MESH_D_HI = 8
    GOSSIP_LAZY = 6          # IHAVE targets per topic per heartbeat
    HEARTBEAT_S = 1.0
    IWANT_MAX = 32           # served per IWANT frame (anti-amplification)
    IHAVE_MAX = 120          # ids per IHAVE digest (fits the 4 KB frame
    #                          cap; a burst bigger than one digest
    #                          drains over successive heartbeats)

    def __init__(self, name: str = "", listen_port: int = 0,
                 gater: Gater | None = None,
                 msg_rate: float = 500.0, msg_burst: int = 1000):
        from ..ratelimit import RateLimiter

        super().__init__(name)
        self.gater = gater or Gater()
        # per-peer ingress rate limit, ahead of the validate pool
        # (reference: the stream-layer limiter tiers; gossipsub's
        # per-peer throttling role): one chatty peer must not own the
        # shared validation queue.  Generous defaults — an N-validator
        # committee's worst honest burst is ~N msgs per phase + the
        # sender retry tails
        self._msg_limiter = RateLimiter(msg_rate, msg_burst)
        self.dropped_rate_limited = 0
        self._peers: dict[object, str] = {}  # socket -> peer name
        self._peer_lock = threading.Lock()
        self._closing = False
        # peer-exchange state: addresses this host knows to be dialable
        # (its own + those ADVERTed by / learned from peers)
        self.known_addrs: dict[str, float] = {}  # "ip:port" -> learned-at
        self._peer_addr: dict[object, str] = {}  # socket -> advertised
        # bounded validation pool + scoring
        self._send_locks: dict[int, threading.Lock] = {}
        self._val_queue: queue.Queue = queue.Queue(self.VALIDATE_QUEUE_CAP)
        self.dropped_overflow = 0  # messages shed at the full queue
        self._score_lock = threading.Lock()
        self._scores: dict[int, tuple[float, float]] = {}  # sockid->(s,at)
        self._throttle_ctr: dict[int, int] = {}  # sockid -> msg counter
        self._ip_strikes: dict[str, int] = {}  # floor hits per address
        # mesh state (under _peer_lock): per-topic eager-push peer sets,
        # per-peer announced topic sets (None until first SUBS =
        # wildcard: eligible everywhere, the bootstrap posture)
        self._mesh: dict[str, set] = {}
        self._peer_topics: dict[object, set | None] = {}
        self._graft_backoff: dict[tuple, float] = {}  # (sockid,topic)->t
        self._mcache = _MsgCache()
        self._seen = _SeenCache()  # flood-dedup: TCP re-floods multipath
        # optional per-directed-link conditioner on the publish path
        # (chaostest.netem.NetEm), keyed (self.name -> peer HELLO name)
        self.netem = None
        # per-publish id salt+counter (stamped into PUBLISH bodies by
        # _pack_publish; salt makes ids unique ACROSS hosts publishing
        # identical payloads)
        import os as _os

        self._pub_salt = _os.urandom(4)
        self._pub_seq = 0
        self._pub_seq_lock = threading.Lock()
        self._iwant_asked: dict[bytes, float] = {}  # mid -> asked-at
        self.sent_publish_frames = 0  # egress accounting (tests/metrics)
        self.sent_ihave_frames = 0
        self.served_iwant = 0
        # liveness watchdog registration: the validate pool
        # and the mesh heartbeat are the host's long-lived threads — a
        # wedged validate worker silently eats a share of all gossip
        from .. import health

        self._hbs = []
        for i in range(self.VALIDATE_WORKERS):
            hb = health.register(f"p2p.validate[{name}#{i}]")
            t = threading.Thread(
                # graftlint: thread-role=serving
                target=self._validate_worker, args=(hb,), daemon=True,
                name=f"p2p-validate-{name}-{i}",
            )
            t.start()
            hb.bind(t)
            self._hbs.append(hb)
        mesh_hb = health.register(f"p2p.mesh[{name}]")
        t = threading.Thread(
            # graftlint: thread-role=serving
            target=self._heartbeat_loop, args=(mesh_hb,), daemon=True,
            name=f"p2p-heartbeat-{name}",
        )
        t.start()
        mesh_hb.bind(t)
        self._hbs.append(mesh_hb)
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", listen_port))
        self._srv.listen(64)
        self.port = self._srv.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, daemon=True,  # graftlint: thread-role=serving
        ).start()

    # -- wire ---------------------------------------------------------------

    def _send_frame(self, sock, kind: int, payload: bytes):
        # one frame at a time per socket: floods now run on several
        # validate workers, and interleaved sendall would corrupt the
        # length-prefixed framing
        lock = self._send_locks.setdefault(id(sock), threading.Lock())
        with lock:
            sock.sendall(_FRAME.pack(len(payload), kind) + payload)

    @staticmethod
    def _recv_exact(sock, n: int) -> bytes | None:
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    def _accept_loop(self):
        while not self._closing:
            try:
                sock, addr = self._srv.accept()
            except OSError:
                return
            if not self.gater.allow(addr[0]):
                sock.close()
                continue
            threading.Thread(
                # graftlint: thread-role=transient — per-connection
                target=self._peer_loop, args=(sock, addr[0]), daemon=True
            ).start()

    def connect(self, port: int, host: str = "127.0.0.1"):
        sock = socket.create_connection((host, port), timeout=10)
        if not self.gater.allow(host):
            sock.close()
            raise ConnectionError("gater refused outbound peer")
        threading.Thread(
            # graftlint: thread-role=transient — per-connection
            target=self._peer_loop, args=(sock, host), daemon=True
        ).start()

    def _peer_loop(self, sock, ip: str):
        try:
            self._send_frame(sock, _KIND_HELLO, self.name.encode())
            hdr = self._recv_exact(sock, _FRAME.size)
            if hdr is None:
                return
            ln, kind = _FRAME.unpack(hdr)
            if kind != _KIND_HELLO or ln > 256:
                return
            peer_name = (self._recv_exact(sock, ln) or b"").decode()
            with self._peer_lock:
                self._peers[sock] = peer_name
            _log.info(
                "peer connected", me=self.name, peer=peer_name, ip=ip
            )
            # advertise our own dialable address for peer exchange,
            # then announce subscribed topics (mesh eligibility)
            self._send_frame(
                sock, _KIND_ADVERT, f"127.0.0.1:{self.port}".encode()
            )
            self._send_frame(
                sock, _KIND_SUBS, "\n".join(self.topics()).encode()
            )
            while not self._closing:
                hdr = self._recv_exact(sock, _FRAME.size)
                if hdr is None:
                    return
                ln, kind = _FRAME.unpack(hdr)
                if ln > MAX_MESSAGE_BYTES + 4096:
                    return  # oversized: drop the peer
                body = self._recv_exact(sock, ln)
                if body is None:
                    return
                if kind == _KIND_PUBLISH:
                    self._on_publish(body, sock, peer_name, ip)
                elif kind == _KIND_ADVERT and ln <= 64:
                    addr = body.decode(errors="replace")
                    with self._peer_lock:
                        self._peer_addr[sock] = addr
                        self._remember_addr(addr, time.monotonic())
                elif kind == _KIND_PEERS_REQ:
                    with self._peer_lock:
                        known = list(self.known_addrs)
                    known.append(f"127.0.0.1:{self.port}")
                    if ln == 32:
                        # routed lookup (the Kad FIND_NODE contract):
                        # serve the K known addresses CLOSEST to the
                        # target by XOR distance of keccak(addr)
                        target = int.from_bytes(body, "big")
                        known.sort(key=lambda a: int.from_bytes(
                            keccak256(a.encode()), "big") ^ target)
                        addrs = known[:16]
                    else:
                        addrs = known[:32]
                    self._send_frame(
                        sock, _KIND_PEERS_RESP, "\n".join(addrs).encode()
                    )
                elif kind == _KIND_PEERS_RESP and ln <= 4096:
                    now = time.monotonic()
                    with self._peer_lock:
                        for addr in body.decode(errors="replace").split("\n"):
                            if addr and addr.count(":") == 1:
                                self._remember_addr(addr, now)
                elif kind == _KIND_SUBS and ln <= 4096:
                    topics = set(
                        t for t in body.decode(errors="replace").split("\n")
                        if t
                    )
                    with self._peer_lock:
                        self._peer_topics[sock] = topics
                        # a peer that unsubscribed leaves those meshes
                        for t, mesh in self._mesh.items():
                            if t not in topics:
                                mesh.discard(sock)
                elif kind == _KIND_GRAFT and ln <= 256:
                    self._on_graft(sock, body.decode(errors="replace"))
                elif kind == _KIND_PRUNE and ln <= 256:
                    with self._peer_lock:
                        self._mesh.get(
                            body.decode(errors="replace"), set()
                        ).discard(sock)
                        self._graft_backoff[
                            (id(sock), body.decode(errors="replace"))
                        ] = time.monotonic() + 30.0
                elif kind == _KIND_IHAVE and ln <= 4096:
                    self._on_ihave(sock, body)
                elif kind == _KIND_IWANT and ln <= 4096:
                    self._on_iwant(sock, body)
        except OSError:
            pass
        finally:
            with self._peer_lock:
                dropped = self._peers.pop(sock, None)
                self._peer_addr.pop(sock, None)
                self._peer_topics.pop(sock, None)
                for mesh in self._mesh.values():
                    mesh.discard(sock)
                live = {id(s) for s in self._peers}
            self._send_locks.pop(id(sock), None)
            self._msg_limiter.drop(str(id(sock)))
            with self._score_lock:
                self._scores.pop(id(sock), None)
                self._throttle_ctr.pop(id(sock), None)
            # an in-flight flood can setdefault a lock back after the
            # pop above; prune stale ids when churn accumulates them
            if len(self._send_locks) > 2 * len(live) + 16:
                for sid in list(self._send_locks):
                    if sid not in live:
                        self._send_locks.pop(sid, None)
            if dropped is not None and not self._closing:
                _log.info("peer disconnected", me=self.name, peer=dropped)
            self.gater.release(ip)
            try:
                sock.close()
            except OSError:
                pass

    # -- gossip -------------------------------------------------------------

    def _pack_publish(self, topic: str, payload: bytes) -> bytes:
        """[8B publish id][u8 tlen][topic][payload].  The publish id
        (4B per-host salt + 4B counter) is stamped at ORIGIN and rides
        the body through every re-flood, so the derived message id
        keccak256(body) stays identical network-wide (loop prevention
        intact) while a RE-PUBLISH of the same payload — the consensus
        sender's retry, the mechanism that recovers a transiently
        IGNOREd NEWVIEW — gets a fresh id instead of dying forever in
        every peer's seen-cache (libp2p's (sender, seqno) message-id
        semantics; the in-process hub got the same fix)."""
        t = topic.encode()
        with self._pub_seq_lock:
            self._pub_seq += 1
            seq = self._pub_seq
        return (self._pub_salt + (seq & 0xFFFFFFFF).to_bytes(4, "big")
                + bytes([len(t)]) + t + payload)

    def _on_publish(self, body: bytes, src_sock, frm: str, ip: str):
        # keyed on CONNECTION identity, like the scores: a spoofed
        # HELLO name must not drain an honest peer's bucket
        if not self._msg_limiter.allow(str(id(src_sock))):
            with self._score_lock:
                self.dropped_rate_limited += 1
            return  # NOT marked seen: another (slower) peer may relay
        now = time.monotonic()
        with self._score_lock:
            throttled = False
            ent = self._scores.get(id(src_sock))
            if ent is not None:
                # apply the forgiveness decay on the READ path too —
                # a peer that stopped misbehaving must throttle out of
                # the tier by time alone, not by misbehaving again
                score, at = ent
                score = min(
                    0.0, score + (now - at) * self.SCORE_DECAY_PER_S
                )
                self._scores[id(src_sock)] = (score, now)
                if score <= self.THROTTLE_FLOOR:
                    # throttle tier: a peer feeding garbage loses half
                    # its ingress before the score floor drops it
                    n = self._throttle_ctr.get(id(src_sock), 0) + 1
                    self._throttle_ctr[id(src_sock)] = n
                    throttled = bool(n % 2)
        if throttled:
            P2P_COUNTERS.inc("throttled")
            return
        mid = keccak256(body)
        if self._seen.seen(mid):
            return
        try:
            self._val_queue.put_nowait((body, src_sock, frm, ip, mid))
        except queue.Full:
            # DoS economy: shed load here, count it, keep reading —
            # and un-mark the id so another peer's re-flood of the
            # same message stays ingestible after the burst
            self._seen.forget(mid)
            with self._score_lock:
                self.dropped_overflow += 1

    def _validate_worker(self, hb):
        while not self._closing:
            hb.beat()
            try:
                body, src_sock, frm, ip, mid = self._val_queue.get(
                    timeout=0.5
                )
            except queue.Empty:
                continue
            try:
                # [8B publish id][u8 tlen][topic][payload]
                tlen = body[8]
                topic = body[9:9 + tlen].decode()
                payload = body[9 + tlen:]
                verdict = self._validate(topic, payload, frm)
            except Exception:  # noqa: BLE001 — malformed frame
                verdict = REJECT
            if verdict == REJECT:
                # gossipsub semantics: only REJECT (malformed/bogus
                # bytes) is punishable; IGNORE is routine filtering
                # (role-bound types, stale views) and must cost the
                # sender nothing
                self._punish(ip, src_sock)
                continue
            if verdict != ACCEPT:
                continue
            try:
                if topic in self._handlers:
                    self._deliver(topic, payload, frm)
                # validate-then-propagate: eager push to the topic mesh
                # only; everyone else learns the id from the heartbeat's
                # IHAVE digest and pulls on demand
                self._mcache.put(mid, topic, body)
                self._mesh_push(topic, body, exclude=src_sock)
            except Exception:  # noqa: BLE001 — a raising subscriber
                # must not kill the pool (4 such and the host goes
                # permanently deaf); surface it and move on
                _log.error(
                    "gossip handler raised", me=self.name, topic=topic,
                )

    # distinct connections from one IP that must hit the score floor
    # before the IP itself is gater-banned (a single bad
    # connection must not collaterally ban every honest peer behind a
    # shared address — the localnet's 127.0.0.1, NAT'd topologies)
    IP_BAN_STRIKES = 3

    def _punish(self, ip: str, sock):
        """Score the CONNECTION down for a rejected message; at the
        floor, drop THAT connection (the per-peer ban — gossipsub
        scoring's role, on the flood topology).  The IP-level gater ban
        is reserved for repeated offenses across distinct connections,
        and never applied to loopback, so shared-IP peers aren't
        collaterally refused."""
        now = time.monotonic()
        P2P_COUNTERS.inc("invalid_tcp")
        with self._score_lock:
            score, at = self._scores.get(id(sock), (0.0, now))
            score = min(
                0.0, score + (now - at) * self.SCORE_DECAY_PER_S
            ) - 1.0
            self._scores[id(sock)] = (score, now)
        _note_score(self.name or "tcp", score)
        if score <= self.SCORE_FLOOR:
            with self._score_lock:
                self._scores.pop(id(sock), None)
                self._throttle_ctr.pop(id(sock), None)
                strikes = self._ip_strikes.get(ip, 0) + 1
                self._ip_strikes[ip] = strikes
            P2P_COUNTERS.inc("conns_dropped")
            loopback = ip.startswith("127.") or ip in ("::1", "localhost")
            if strikes >= self.IP_BAN_STRIKES and not loopback:
                _log.warn(
                    "ip banned for repeated spam", me=self.name, ip=ip,
                    strikes=strikes,
                )
                P2P_COUNTERS.inc("ips_banned")
                self.gater.ban(ip)
            else:
                _log.warn(
                    "peer connection dropped for spam", me=self.name,
                    ip=ip, score=round(score, 1), strikes=strikes,
                )
            try:
                sock.close()  # reader thread unwinds and releases
            except OSError:
                pass

    # -- mesh ---------------------------------------------------------------

    def subscribe(self, topic: str, handler):
        """Subscribe + announce the topic to every peer (mesh
        eligibility rides SUBS announcements)."""
        super().subscribe(topic, handler)
        self._announce_subs()

    def add_validator(self, topic: str, validator):
        super().add_validator(topic, validator)
        self._announce_subs()

    def _announce_subs(self):
        subs = "\n".join(self.topics()).encode()
        with self._peer_lock:
            socks = list(self._peers)
        for s in socks:
            try:
                self._send_frame(s, _KIND_SUBS, subs)
            except OSError:
                pass

    def _eligible(self, topic: str, sock) -> bool:
        """Caller holds _peer_lock: peer announced the topic, or has
        not announced anything yet (wildcard bootstrap posture)."""
        topics = self._peer_topics.get(sock)
        return topics is None or topic in topics

    def _mesh_peers(self, topic: str) -> list:
        """Current mesh for ``topic``, built on first use from eligible
        peers (caller does NOT hold _peer_lock)."""
        with self._peer_lock:
            mesh = self._mesh.setdefault(topic, set())
            mesh.intersection_update(self._peers)
            if not mesh:
                import random

                cands = [s for s in self._peers
                         if self._eligible(topic, s)]
                random.shuffle(cands)
                mesh.update(cands[: self.MESH_D])
            return list(mesh)

    def _mesh_push(self, topic: str, body: bytes, exclude=None):
        """The TCPHost publish path — netem-conditioned per directed
        (self -> peer) link when a conditioner is installed (publish
        AND re-flood both funnel through here; IWANT repair serves
        from the mcache unconditioned, like a retransmit)."""
        nm = self.netem
        if nm is not None and not nm.armed:
            nm = None  # disarmed conditioner: skip closures entirely
        peers = self._mesh_peers(topic)
        names = {}
        if nm is not None:
            with self._peer_lock:
                # a mesh peer whose HELLO name is somehow unknown
                # (drop racing this snapshot) conditions as "?": a
                # wildcard rule — a total partition — still applies;
                # only name-specific rules need the identity
                names = {id(s): self._peers.get(s) or "?"
                         for s in peers}
        for s in peers:
            if s is exclude:
                continue
            if nm is not None and nm.send(
                self.name, names.get(id(s), "?"), len(body),
                lambda s=s: self._send_publish(s, body),
            ):
                continue  # conditioned: dropped or scheduled
            self._send_publish(s, body)

    def _send_publish(self, s, body: bytes):
        try:
            self._send_frame(s, _KIND_PUBLISH, body)
            self.sent_publish_frames += 1
        except OSError:
            pass

    def _on_graft(self, sock, topic: str):
        with self._peer_lock:
            if sock not in self._peers or not self._eligible(topic, sock):
                return
            mesh = self._mesh.setdefault(topic, set())
            if sock in mesh:
                return
            if len(mesh) >= self.MESH_D_HI:
                over = True
            else:
                mesh.add(sock)
                over = False
        if over:
            try:
                self._send_frame(sock, _KIND_PRUNE, topic.encode())
            except OSError:
                pass

    def _on_ihave(self, sock, body: bytes):
        """Lazy pull: request messages we have not seen.  ``_seen`` is
        NOT marked — the full message arrives as a normal PUBLISH."""
        if not body:
            return
        tlen = body[0]
        mids_raw = body[1 + tlen:]
        now = time.monotonic()
        want = []
        for i in range(0, len(mids_raw) - 31, 32):
            mid = mids_raw[i:i + 32]
            asked = self._iwant_asked.get(mid, 0.0)
            if now - asked < 2.0:
                continue  # an earlier IWANT is in flight
            if not self._seen.has(mid):
                want.append(mid)
            if len(want) >= self.IWANT_MAX:
                break  # the rest re-appears in the next digest
        # only the ids actually REQUESTED get the in-flight stamp —
        # stamping the overflow too would back it off for 2 s without
        # any request in flight, stretching burst recovery
        for mid in want:
            self._iwant_asked[mid] = now
        if len(self._iwant_asked) > 4096:
            cutoff = now - 10.0
            self._iwant_asked = {
                m: t for m, t in self._iwant_asked.items() if t > cutoff
            }
        if want:
            try:
                self._send_frame(sock, _KIND_IWANT, b"".join(want))
            except OSError:
                pass

    def _on_iwant(self, sock, body: bytes):
        served = 0
        for i in range(0, len(body) - 31, 32):
            if served >= self.IWANT_MAX:
                break
            cached = self._mcache.get(body[i:i + 32])
            if cached is None:
                continue
            try:
                self._send_frame(sock, _KIND_PUBLISH, cached)
                self.sent_publish_frames += 1
                self.served_iwant += 1
                served += 1
            except OSError:
                return

    def _heartbeat_loop(self, hb):
        import random

        while not self._closing:
            hb.beat()
            time.sleep(self.HEARTBEAT_S)
            try:
                self._heartbeat(random)
            except Exception:  # noqa: BLE001 — keep the mesh alive
                _log.error("heartbeat failed", me=self.name)

    def _heartbeat(self, random):
        """Mesh maintenance + lazy gossip (gossipsub heartbeat): keep
        every subscribed topic's mesh within [D_LO, D_HI], and send
        IHAVE digests of recent messages to a few non-mesh peers.

        Digests cover subscribed topics AND fanout topics (recently
        published, not subscribed): a proposer publishing into a topic
        it does not consume must still heal peers that missed the eager
        push — e.g. when the publish raced the peer's SUBS announcement
        and the mesh view was still empty."""
        now = time.monotonic()
        # snapshot subscriptions and the message cache BEFORE taking
        # _peer_lock: topics() and recent_ids() take their own locks,
        # and nesting them under _peer_lock put undeclared edges in the
        # whole-program lock-order graph (GL05) for zero benefit — both
        # reads are advisory for this round
        subscribed = self.topics()
        gossip_topics = sorted(
            set(subscribed) | set(self._mcache.recent_topics())
        )
        recent = {t: self._mcache.recent_ids(t) for t in gossip_topics}
        grafts, prunes, gossip = [], [], []
        with self._peer_lock:
            for topic in subscribed:
                mesh = self._mesh.setdefault(topic, set())
                mesh.intersection_update(self._peers)
                cands = [
                    s for s in self._peers
                    if s not in mesh and self._eligible(topic, s)
                    and self._graft_backoff.get((id(s), topic), 0) < now
                ]
                if len(mesh) < self.MESH_D_LO and cands:
                    random.shuffle(cands)
                    add = cands[: self.MESH_D - len(mesh)]
                    mesh.update(add)
                    grafts += [(s, topic) for s in add]
                elif len(mesh) > self.MESH_D_HI:
                    drop = random.sample(
                        sorted(mesh, key=id), len(mesh) - self.MESH_D
                    )
                    for s in drop:
                        mesh.discard(s)
                    prunes += [(s, topic) for s in drop]
            for topic in gossip_topics:
                mids = recent.get(topic) or []
                if mids:
                    # IHAVE digests go to a random sample of ALL
                    # eligible peers — mesh members included, so a
                    # freshly-grafted peer (a partition bridge) still
                    # learns ids it missed; digests are tiny and
                    # already-seen ids cost the receiver nothing
                    targets = [s for s in self._peers
                               if self._eligible(topic, s)]
                    random.shuffle(targets)
                    t = topic.encode()
                    frame = (bytes([len(t)]) + t
                             + b"".join(mids[-self.IHAVE_MAX:]))
                    gossip += [
                        (s, frame) for s in targets[: self.GOSSIP_LAZY]
                    ]
            if len(self._graft_backoff) > 4096:
                self._graft_backoff = {
                    k: t for k, t in self._graft_backoff.items() if t > now
                }
        for s, topic in grafts:
            try:
                self._send_frame(s, _KIND_GRAFT, topic.encode())
            except OSError:
                pass
        for s, topic in prunes:
            try:
                self._send_frame(s, _KIND_PRUNE, topic.encode())
            except OSError:
                pass
        for s, frame in gossip:
            try:
                self._send_frame(s, _KIND_IHAVE, frame)
                self.sent_ihave_frames += 1
            except OSError:
                pass

    def publish(self, topic: str, payload: bytes):
        if len(payload) > MAX_MESSAGE_BYTES:
            raise ValueError("message exceeds 2 MB cap")
        body = self._pack_publish(topic, payload)
        mid = keccak256(body)
        self._seen.seen(mid)  # don't re-deliver to self
        self._mcache.put(mid, topic, body)
        self._mesh_push(topic, body)

    _KNOWN_ADDRS_CAP = 256

    def _remember_addr(self, addr: str, now: float):
        """Bounded peer-address store (caller holds _peer_lock): a
        hostile peer flooding fabricated addresses must not grow
        memory — oldest entries rotate out."""
        if addr in self.known_addrs:
            return
        while len(self.known_addrs) >= self._KNOWN_ADDRS_CAP:
            self.known_addrs.pop(next(iter(self.known_addrs)))
        self.known_addrs[addr] = now

    def request_peers(self, target: bytes = b""):
        """Ask every connected peer for known addresses (PEX pull).
        With a 32-byte ``target``, peers answer with their closest-K
        by XOR distance instead (the Kad FIND_NODE contract) —
        iterative lookups converge on any region of the id space.
        Responses land asynchronously in ``known_addrs``."""
        with self._peer_lock:
            socks = list(self._peers)
        for s in socks:
            try:
                self._send_frame(s, _KIND_PEERS_REQ, target)
            except OSError:
                pass

    def connected_addrs(self) -> set:
        """Advertised addresses of currently-connected peers."""
        with self._peer_lock:
            return set(self._peer_addr.values())

    def peer_count(self) -> int:
        with self._peer_lock:
            return len(self._peers)

    def wait_for_peers(self, n: int, timeout: float = 10.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.peer_count() >= n:
                return True
            time.sleep(0.01)
        return False

    def close(self):
        self._closing = True
        for hb in getattr(self, "_hbs", ()):
            hb.close()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._peer_lock:
            socks = list(self._peers)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
