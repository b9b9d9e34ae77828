"""Sync streams: request/response block download protocol.

The role of the reference's p2p/stream framework (reference:
p2p/stream/protocols/sync/protocol.go:86-177 — protocol id
hmy/sync/<network>/<shard>/<version>; client.go GetBlocksByNumber /
GetBlockHashes; streammanager pooling + requestmanager matching —
SURVEY.md §2.5).  Here a stream is one TCP connection per peer pair;
requests carry ids so responses match out-of-order; the server side
answers from a Blockchain.

Wire: [u32 len][u8 kind][u64 req_id][payload]; kinds are REQ/RESP with
a method byte leading the payload.  Bit 6 of kind marks an optional
trace context: the payload is then prefixed [u8 tc_len][traceparent]
(the trace module's binary form) — requests only, responses stay plain.
Untraced clients speak the original wire format unchanged; a traced
client needs a flag-aware server (a pre-flag server drops flagged
requests), so arm tracing fleet-wide, not per node, when mixing
versions.

The port's copy of the JAX package's ``p2p/stream.py``.
"""

from __future__ import annotations

import bisect
import socket
import struct
import threading

from .. import faultinject as FI
from .. import trace
from ..core import rawdb
from ..core.types import _enc_bytes, _enc_int
from ..core.types import Reader as _Reader
from ..metrics import Counter

SNAPSHOT_SERVED = Counter(
    "harmony_snapshot_served_total",
    "snapshot responses served to late-joining peers, by method",
)

PROTOCOL_VERSION = 1
_HDR = struct.Struct("<IBQ")
_REQ, _RESP = 1, 2
_TRACE_FLAG = 0x40

METHOD_BLOCK_HASHES = 1    # [u64 start][u32 count] -> [hash...]
METHOD_BLOCKS_BY_NUM = 2   # [u64 start][u32 count] -> [block blob...]
METHOD_HEAD = 3            # [] -> [u64 head][32B hash]
METHOD_EPOCH_STATE = 4     # [u64 epoch] -> [encoded shard state | empty]
METHOD_RECEIPTS = 5        # [u64 start][u32 count] -> per-block receipt blobs
METHOD_ACCOUNT_RANGE = 6   # [u64 block][len-pfx start addr][u32 limit]
#                            -> [u32 n][(addr, account blob)...]
METHOD_SNAPSHOT_META = 7   # [u64 block (0 = latest)] -> empty |
#                            [u64 num][u32 n_pages][u64 state_len]
#                            [len-pfx header][len-pfx commit proof]
METHOD_SNAPSHOT_PAGE = 8   # [u64 block][u32 page] -> empty |
#                            [u32 count][(addr, account blob) pairs]
MAX_BLOCKS_PER_REQUEST = 128   # server-side clamp
MAX_ACCOUNTS_PER_REQUEST = 512  # account-range clamp
MAX_SNAPSHOT_PAGES = 1_000_000   # client-side plausibility bound
MAX_SNAPSHOT_STATE_BYTES = 1 << 30  # client assembles this in memory
# wire plausibility bounds, checked BEFORE any allocation: every
# request is a method byte + a handful of fixed fields (+ one short
# address), and responses are assembled under the soft byte budget
# below — a peer claiming more is feeding garbage and is dropped
MAX_REQUEST_BYTES = 4096
MAX_RESPONSE_BYTES = 32 * 1024 * 1024
RESPONSE_SOFT_BUDGET = 8 * 1024 * 1024  # server stops packing past this


def protocol_id(network: str, shard_id: int) -> str:
    """reference: protocol.go:86 — hmy/sync/<net>/<shard>/<version>."""
    return f"harmony-tpu/sync/{network}/{shard_id}/{PROTOCOL_VERSION}"


def _checked_count(r: _Reader, width: int = 4) -> int:
    """Bounded count for PEER response bodies — Reader.checked_count
    (a forged count must cost its own wire size, never a
    4-billion-iteration decode loop)."""
    return r.checked_count(width)


def decode_snapshot_meta(resp: bytes):
    """Pure decode of a METHOD_SNAPSHOT_META response body (module
    level so the wire-fuzz tier drives it without a socket): ``(num,
    n_pages, state_len, header_blob, proof)``, or None for the empty
    not-serving response.  Both counts are plausibility-bounded BEFORE
    the caller allocates anything against them — a hostile peer's meta
    frame is the root of the whole download budget."""
    if not resp:
        return None
    r = _Reader(resp)
    num = r.int_()
    n_pages = r.int_(4)
    state_len = r.int_()
    if n_pages > MAX_SNAPSHOT_PAGES:
        raise ValueError(
            f"implausible snapshot page count {n_pages}"
        )
    if state_len > MAX_SNAPSHOT_STATE_BYTES:
        raise ValueError(
            f"implausible snapshot state size {state_len}"
        )
    header_blob = r.bytes_()
    proof = r.bytes_()
    return num, n_pages, state_len, header_blob, proof


def decode_snapshot_page(resp: bytes, num: int = 0) -> tuple:
    """Pure decode of a METHOD_SNAPSHOT_PAGE response body:
    ``(account_count, raw pair bytes)``.  The count is bounded by the
    payload the peer actually paid to send; an empty body is the
    protocol's typed not-serving signal (ConnectionError — the
    downloader rotates peers or restarts with fresh meta)."""
    if not resp:
        raise ConnectionError(
            f"peer no longer serves snapshot at block {num}"
        )
    count = int.from_bytes(resp[:4], "little")
    payload = resp[4:]
    if count > len(payload):
        raise ValueError(
            f"implausible snapshot page count {count} with "
            f"{len(payload)} bytes"
        )
    return count, payload


class SyncServer:
    """Serves a chain over the stream protocol.

    Per-connection request rate limiting mirrors the reference's
    stream-layer rate limiter tiers (p2p/stream rate limiting): a
    token bucket refilled at ``rate_per_sec`` with ``burst`` capacity;
    a peer that exceeds it gets throttled, not disconnected (lagging
    nodes catching up are bursty by design)."""

    def __init__(self, chain, listen_port: int = 0,
                 rate_per_sec: float = 200.0, burst: int = 400):
        from ..ratelimit import RateLimiter

        self.chain = chain
        self.limiter = RateLimiter(rate_per_sec, burst)
        # account-range paging cache: one (block num -> sorted account
        # items) entry, so a full state download costs ONE state
        # deserialize + sort instead of one per page (O(N) not
        # O(N^2/limit) in account count)
        self._range_cache: tuple | None = None
        self._range_lock = threading.Lock()
        # snapshot-serving cache: one (num, header blob, proof, state
        # blob, page offsets) entry — the page walk runs once per
        # served block, every page request after that is a slice.
        # Single-entry: concurrent importers at DIFFERENT blocks
        # thrash it (one O(N) rewalk per flip), which is bounded and
        # rare — a late joiner bootstraps once
        self._snap_cache: tuple | None = None
        self._snap_lock = threading.Lock()
        self._closing = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", listen_port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        threading.Thread(
            target=self._accept_loop, daemon=True,  # graftlint: thread-role=serving
        ).start()

    def _accept_loop(self):
        while not self._closing:
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                # graftlint: thread-role=transient — per-connection
                target=self._serve_conn, args=(sock,), daemon=True
            ).start()

    def _serve_conn(self, sock):
        conn_key = str(id(sock))
        try:
            while not self._closing:
                hdr = _recv_exact(sock, _HDR.size)
                if hdr is None:
                    return
                ln, kind, req_id = _HDR.unpack(hdr)
                if ln > MAX_REQUEST_BYTES:
                    return  # implausible request frame: drop the peer
                body = _recv_exact(sock, ln)
                if body is None or (kind & ~_TRACE_FLAG) != _REQ:
                    return
                tc = b""
                if kind & _TRACE_FLAG:
                    if not body or len(body) < 1 + body[0]:
                        return  # truncated trace prefix: drop the conn
                    tc, body = body[1:1 + body[0]], body[1 + body[0]:]
                # back-pressure, not drop: every request consumes a
                # token, waiting for one when the bucket is dry
                self.limiter.wait(conn_key)
                with trace.resume(tc, "p2p.serve", component="p2p",
                                  method=body[0] if body else -1):
                    resp = self._handle(body)
                sock.sendall(_HDR.pack(len(resp), _RESP, req_id) + resp)
        except OSError:
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _handle(self, body: bytes) -> bytes:
        method = body[0]
        r = _Reader(body[1:])
        if method == METHOD_HEAD:
            head = self.chain.head_number
            return (
                head.to_bytes(8, "little")
                + self.chain.current_header().hash()
            )
        if method == METHOD_EPOCH_STATE:
            epoch = r.int_()
            state = rawdb.read_shard_state(self.chain.db, epoch)
            if state is None:
                return b""
            return rawdb.encode_shard_state(state)
        if method == METHOD_ACCOUNT_RANGE:
            # snap-style state serving (reference: p2p/stream sync
            # client.go GetAccountRange): sorted accounts of the state
            # at a given block, strictly after ``start``, paged by
            # ``limit`` — the fast-sync states stage reads these.
            num = r.int_()
            start_addr = r.bytes_()
            limit = min(r.int_(4), MAX_ACCOUNTS_PER_REQUEST)
            with self._range_lock:
                if self._range_cache and self._range_cache[0] == num:
                    _, keys, everything = self._range_cache
                else:
                    try:
                        state = self.chain.state_at(num)
                    except Exception:  # noqa: BLE001 — peer lacks the
                        # state (e.g. it fast-synced itself); the count
                        # sentinel is distinct from a legitimate empty
                        # page so the client moves on to another peer
                        # instead of adopting nothing
                        return _enc_int(0xFFFFFFFF, 4)
                    everything = [
                        (addr, acct.encode())
                        for addr, acct in state._live_accounts()
                    ]
                    keys = [a for a, _ in everything]
                    self._range_cache = (num, keys, everything)
            lo = bisect.bisect_right(keys, start_addr)
            items = everything[lo:lo + limit]
            body = bytearray()
            n = 0
            for addr, blob in items:
                body += _enc_bytes(addr) + _enc_bytes(blob)
                n += 1
                if len(body) > RESPONSE_SOFT_BUDGET:
                    break  # short page: the client pages onward
            return bytes(_enc_int(n, 4) + body)
        if method == METHOD_SNAPSHOT_META:
            snap = self._snapshot(r.int_())
            if snap is None:
                return b""
            SNAPSHOT_SERVED.inc(method="meta")
            num, header_blob, proof, state_blob, pages = snap
            return (
                num.to_bytes(8, "little")
                + len(pages).to_bytes(4, "little")
                + len(state_blob).to_bytes(8, "little")
                + _enc_bytes(header_blob) + _enc_bytes(proof)
            )
        if method == METHOD_SNAPSHOT_PAGE:
            num = r.int_()
            idx = r.int_(4)
            snap = self._snapshot(num)
            if snap is None or idx >= len(snap[4]):
                return b""  # unknown/stale block or page out of range
            _, _, _, state_blob, pages = snap
            start_off, end_off, n = pages[idx]
            SNAPSHOT_SERVED.inc(method="page")
            return (n.to_bytes(4, "little")
                    + state_blob[start_off:end_off])
        start = r.int_()
        count = min(r.int_(4), MAX_BLOCKS_PER_REQUEST)
        if method == METHOD_BLOCK_HASHES:
            out = bytearray()
            for num in range(start, start + count):
                h = rawdb.read_canonical_hash(self.chain.db, num)
                if h is None:
                    break
                out += h
            return bytes(out)
        if method == METHOD_RECEIPTS:
            # per-block receipt lists (reference: client.go GetReceipts
            # feeding the stagedstreamsync receipts stage)
            blobs = []
            total = 0
            for num in range(start, start + count):
                if num > self.chain.head_number or (
                    total > RESPONSE_SOFT_BUDGET
                ):
                    break
                receipts = rawdb.read_receipts(self.chain.db, num)
                blob = bytearray(_enc_int(len(receipts), 4))
                for rc in receipts:
                    blob += rc.encode()
                blobs.append(bytes(blob))
                total += len(blob)
            out = bytearray(_enc_int(len(blobs), 4))
            for blob in blobs:
                out += _enc_bytes(blob)
            return bytes(out)
        if method == METHOD_BLOCKS_BY_NUM:
            out = bytearray()
            blobs = []
            total = 0
            for num in range(start, start + count):
                block = self.chain.block_by_number(num)
                if block is None or total > RESPONSE_SOFT_BUDGET:
                    break
                blob = (
                    _enc_bytes(rawdb.encode_header(block.header))
                    + _enc_bytes(
                        rawdb.encode_body(block, self.chain.config.chain_id)
                    )
                    + _enc_bytes(self.chain.read_commit_sig(num) or b"")
                )
                blobs.append(blob)
                total += len(blob)
            out += _enc_int(len(blobs), 4)
            for blob in blobs:
                out += _enc_bytes(blob)
            return bytes(out)
        return b""

    def _snapshot(self, num: int) -> tuple | None:
        """The served snapshot at block ``num`` (0 = current head):
        (num, header blob, commit proof, state blob, page offsets), or
        None when the header/state is unknown or pruned.  Pages come
        from core.snapshot.paginate_state over the stored serialized
        state, so serving never deserializes accounts at all."""
        from ..core.snapshot import SnapshotError, paginate_state

        with self._snap_lock:
            if num == 0:
                num = self.chain.head_number
            c = self._snap_cache
            if c is not None and c[0] == num:
                return c
            header = rawdb.read_header(self.chain.db, num)
            if header is None:
                return None
            state_blob = rawdb.read_state(self.chain.db, header.root)
            if state_blob is None:
                return None  # pruned past: client rotates peers
            proof = rawdb.read_commit_sig(self.chain.db, num) or b""
            try:
                pages = paginate_state(state_blob)
            except SnapshotError:
                return None  # damaged local blob: don't serve garbage
            c = (num, rawdb.encode_header(header), proof, state_blob,
                 pages)
            self._snap_cache = c
            return c

    def close(self):
        self._closing = True
        try:
            # wake the blocked accept NOW (a bare close is deferred
            # while another thread sits in accept on this fd)
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._srv.close()
        except OSError:
            pass


class _PendingReply:
    __slots__ = ("event", "body")

    def __init__(self):
        self.event = threading.Event()
        self.body: bytes | None = None


class SyncClient:
    """One peer's sync stream (reference: sync/client.go).

    Connects LAZILY and reconnects on the next call after a failure:
    peers come up in arbitrary order (a localnet's node 0 boots before
    its neighbour's server exists) and restart across a node's
    lifetime; a sync peer being down is a per-call error for the
    downloader's peer rotation, never a constructor crash.

    Requests are PIPELINED: the protocol already matches responses by
    req_id, so ``_call`` registers a pending slot, sends, and waits on
    its own event while a shared reader thread demultiplexes replies.
    The old design held ``_lock`` across the socket recv (GL06), which
    serialized every concurrent downloader stage behind one in-flight
    request for up to the 30 s timeout — and made ``close`` unable to
    take the lock at all."""

    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 30.0):
        self._addr = (host, port)
        self.peer_key = f"{host}:{port}"  # faultinject/log identity
        self._timeout = timeout
        self._sock: socket.socket | None = None
        self._next_id = 0
        self._lock = threading.Lock()  # connection + id + pending map
        self._send_lock = threading.Lock()  # frame atomicity only
        self._pending: dict[int, _PendingReply] = {}

    def _ensure_connected(self, deadline=None) -> socket.socket:
        """Current socket, dialing lazily — the dial itself (a blocking
        connect with a long timeout) runs with NO lock held; racing
        dialers resolve by the loser closing its spare socket.  The
        caller's deadline bounds the dial too: a peer black-holed at
        connect time costs the request budget, not the stream's full
        default timeout."""
        with self._lock:
            if self._sock is not None:
                return self._sock
        dial_timeout = (self._timeout if deadline is None
                        else deadline.bound(self._timeout))
        if dial_timeout is not None and dial_timeout <= 0:
            raise ConnectionError("sync request deadline exhausted")
        sock = socket.create_connection(self._addr,
                                        timeout=dial_timeout)
        # TCP self-connect quirk: dialing a freed localhost port can
        # land on our own ephemeral port and "succeed" — a dead peer
        # must look dead, not echo our frames back
        if sock.getsockname() == sock.getpeername():
            try:
                sock.close()
            except OSError:
                pass
            raise ConnectionError("self-connected socket (peer is down)")
        # blocking mode from here: the reader thread recvs continuously
        # and must survive idle periods; per-call deadlines are enforced
        # by the waiter's event timeout, not the socket
        sock.settimeout(None)
        with self._lock:
            if self._sock is None:
                self._sock = sock
                threading.Thread(
                    # graftlint: thread-role=transient — per-connection
                    target=self._read_loop, args=(sock,), daemon=True
                ).start()
                return sock
            loser, sock = sock, self._sock
        try:
            loser.close()
        except OSError:
            pass
        return sock

    def _read_loop(self, sock):
        """Demultiplex responses to their waiters by req_id."""
        while True:
            hdr = _recv_exact(sock, _HDR.size)
            if hdr is None:
                break
            ln, kind, rid = _HDR.unpack(hdr)
            if ln > MAX_RESPONSE_BYTES:
                break  # implausible frame: drop the stream, fail waiters
            body = _recv_exact(sock, ln)
            if body is None:
                break
            if kind != _RESP:
                continue
            with self._lock:
                slot = self._pending.get(rid)
            if slot is not None:
                slot.body = body
                slot.event.set()
        self._drop(sock)

    def _drop(self, sock):
        """Retire a dead socket and fail every waiter parked on it.
        Only the CURRENT socket's death fails the pending map — a stale
        reader unwinding after a redial must not kill the healthy
        waiters already registered against the new connection."""
        stale: list = []
        with self._lock:
            if self._sock is sock:
                self._sock = None
                stale = list(self._pending.values())
                self._pending.clear()
        for slot in stale:
            slot.event.set()  # body stays None -> waiter raises
        try:
            # shutdown first: a bare close() while the reader thread is
            # blocked in recv is deferred by the kernel (no FIN, reader
            # stays parked); shutdown wakes it with EOF immediately
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            sock.close()
        except OSError:
            pass

    def _call(self, payload: bytes, deadline=None) -> bytes:
        """One request/response.  ``deadline`` (a resilience.Deadline)
        tightens this call's wait below the stream's default timeout —
        the downloader propagates one budget across a whole stage so a
        black-holed peer costs bounded time, not 30 s per request."""
        FI.fire("p2p.stream", key=self.peer_key)
        with trace.span("p2p.request", component="p2p",
                        peer=self.peer_key,
                        method=payload[0] if payload else -1):
            sock = self._ensure_connected(deadline)
            # the wait budget is re-taken AFTER the dial so a slow
            # connect and the response wait share ONE deadline, not two
            timeout = (self._timeout if deadline is None
                       else deadline.bound(self._timeout))
            if timeout is not None and timeout <= 0:
                raise ConnectionError("sync request deadline exhausted")
            tc = trace.traceparent()
            kind = _REQ | _TRACE_FLAG if tc else _REQ
            wire = (bytes([len(tc)]) + tc + payload) if tc else payload
            with self._lock:
                self._next_id += 1
                req_id = self._next_id
                slot = _PendingReply()
                self._pending[req_id] = slot
            try:
                try:
                    # _send_lock only keeps concurrent frames from
                    # interleaving; the response wait below happens with
                    # NO lock held, so calls overlap on the wire
                    with self._send_lock:
                        sock.sendall(  # graftlint: disable=GL06 frame-atomicity lock, held per send, never across the response wait
                            _HDR.pack(len(wire), kind, req_id) + wire
                        )
                except OSError:
                    self._drop(sock)
                    raise
                if not slot.event.wait(timeout):
                    self._drop(sock)  # wedged peer: fail all, redial
                    raise ConnectionError("sync request timed out")
                if slot.body is None:
                    raise ConnectionError("sync stream closed")
                return slot.body
            finally:
                with self._lock:
                    self._pending.pop(req_id, None)

    def get_head(self, deadline=None) -> tuple[int, bytes]:
        resp = self._call(bytes([METHOD_HEAD]), deadline)
        return int.from_bytes(resp[:8], "little"), resp[8:40]

    def get_block_hashes(self, start: int, count: int,
                         deadline=None) -> list:
        resp = self._call(
            bytes([METHOD_BLOCK_HASHES])
            + start.to_bytes(8, "little") + count.to_bytes(4, "little"),
            deadline,
        )
        return [resp[i:i + 32] for i in range(0, len(resp), 32)]

    def get_blocks_by_number(self, start: int, count: int,
                             deadline=None) -> list:
        """[(Block, commit_sig_or_None)] — the replay feed."""
        resp = self._call(
            bytes([METHOD_BLOCKS_BY_NUM])
            + start.to_bytes(8, "little") + count.to_bytes(4, "little"),
            deadline,
        )
        r = _Reader(resp)
        out = []
        for _ in range(_checked_count(r)):
            item = _Reader(r.bytes_())
            header = rawdb.decode_header(item.bytes_())
            txs, stxs, cxs, order = rawdb.decode_body(item.bytes_())
            sig = item.bytes_()
            from ..core.types import Block

            out.append(
                (Block(header, txs, stxs, cxs, order), sig or None)
            )
        return out

    def get_receipts(self, start: int, count: int, deadline=None) -> list:
        """[[Receipt]] — one list per block from ``start``."""
        from ..core.types import Receipt

        resp = self._call(
            bytes([METHOD_RECEIPTS])
            + start.to_bytes(8, "little") + count.to_bytes(4, "little"),
            deadline,
        )
        r = _Reader(resp)
        out = []
        for _ in range(_checked_count(r)):
            item = _Reader(r.bytes_())
            out.append([Receipt.decode(item)
                        for _ in range(_checked_count(item))])
        return out

    def get_account_range(self, num: int, start_addr: bytes = b"",
                          limit: int = MAX_ACCOUNTS_PER_REQUEST,
                          deadline=None) -> list:
        """[(addr, account blob)] of the remote state at block ``num``,
        strictly after ``start_addr``; page until a short page."""
        resp = self._call(
            bytes([METHOD_ACCOUNT_RANGE]) + num.to_bytes(8, "little")
            + _enc_bytes(start_addr) + limit.to_bytes(4, "little"),
            deadline,
        )
        r = _Reader(resp)
        n = r.int_(4)
        if n == 0xFFFFFFFF:
            raise ConnectionError(f"peer has no state at block {num}")
        if n > len(r.view) - r.off:
            raise ValueError(
                f"implausible account count {n} in sync response"
            )  # same bound as checked_count; n was already consumed
        return [(r.bytes_(), r.bytes_()) for _ in range(n)]

    def get_snapshot_meta(self, num: int = 0, deadline=None):
        """The peer's served snapshot at block ``num`` (0 = its head):
        ``(num, n_pages, state_len, header_blob, proof)`` or None when
        the peer has nothing to serve.  Every count is plausibility-
        bounded BEFORE the caller allocates anything against it — the
        meta frame is the root of the whole download budget."""
        resp = self._call(
            bytes([METHOD_SNAPSHOT_META]) + num.to_bytes(8, "little"),
            deadline,
        )
        return decode_snapshot_meta(resp)

    def get_snapshot_page(self, num: int, idx: int,
                          deadline=None) -> tuple[int, bytes]:
        """Page ``idx`` of the snapshot at block ``num``:
        ``(account_count, raw pair bytes)``.  Raises ConnectionError
        when the peer no longer serves that block (head moved, pruned)
        so the downloader rotates or restarts with fresh meta."""
        resp = self._call(
            bytes([METHOD_SNAPSHOT_PAGE]) + num.to_bytes(8, "little")
            + idx.to_bytes(4, "little"),
            deadline,
        )
        return decode_snapshot_page(resp, num)

    def get_epoch_state(self, epoch: int, deadline=None):
        """The elected shard State recorded for ``epoch`` on the remote
        chain, or None (feeds the beacon EpochChain)."""
        resp = self._call(
            bytes([METHOD_EPOCH_STATE]) + epoch.to_bytes(8, "little"),
            deadline,
        )
        if not resp:
            return None
        return rawdb.decode_shard_state(resp)

    def close(self):
        # retire the socket NOW (null the slot, fail waiters, close the
        # fd) rather than waiting for the reader thread to notice — the
        # very next call must redial, not trip over a dead descriptor
        with self._lock:
            s = self._sock
        if s is not None:
            self._drop(s)


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf
