"""Python sidecar client (tests + Python-side nodes).  The C++ twin for
non-Python hosts lives in native/sidecar_client.cpp.

Resilient by contract (the failure-mode matrix in docs/ANALYSIS.md):

- every RPC runs under a ``Deadline`` (connect + call timeouts bound
  every socket wait — a client without them blocks forever in ``recv``);
- ANY error mid-call fails CLOSED: the connection is dropped, every
  in-flight waiter gets a typed ``SidecarUnavailable``, and the next
  call redials.  A half-read frame or mismatched reply can therefore
  never leave ``_req_id`` out of step and poison later calls;
- reconnect happens lazily with bounded backoff (``RetryPolicy``), and
  committee state is REPLAYED onto the fresh connection before any
  request uses it — ``agg_verify`` never hits STATUS_UNKNOWN_COMMITTEE
  just because the sidecar restarted;
- requests are pipelined like p2p/stream.SyncClient: a reader thread
  demultiplexes replies by request id, so no lock is ever held across
  socket I/O (GL06) and concurrent callers overlap on the wire.
"""

from __future__ import annotations

import socket
import threading

from .. import faultinject as FI
from .. import trace
from ..log import get_logger
from ..resilience import Deadline, RetryPolicy
from . import protocol as P

_log = get_logger("sidecar")


class SidecarUnavailable(ConnectionError):
    """The sidecar cannot serve this call within its deadline.  The
    connection has been dropped (fail closed); a later call redials
    and replays committee state."""


class _Pending:
    __slots__ = ("event", "frame")

    def __init__(self):
        self.event = threading.Event()
        self.frame: tuple | None = None  # (resp type, body) when set


class _AsyncCall:
    """A pipelined in-flight ``agg_verify``: the frame is already on
    the wire; ``result()`` awaits the demultiplexed reply."""

    __slots__ = ("_client", "_sock", "_rid", "_slot", "_epoch",
                 "_shard", "_deadline")

    def __init__(self, client, sock, rid, slot, epoch, shard, deadline):
        self._client = client
        self._sock = sock
        self._rid = rid
        self._slot = slot
        self._epoch = epoch
        self._shard = shard
        self._deadline = deadline

    def result(self) -> bool:
        status, body = self._client._await(
            self._sock, P.MSG_AGG_VERIFY, self._rid, self._slot,
            self._deadline,
        )
        return SidecarClient._agg_verify_result(
            self._epoch, self._shard, status, body
        )


class SidecarClient:
    def __init__(self, address, connect_timeout: float = 5.0,
                 call_timeout: float = 10.0,
                 retry: RetryPolicy | None = None,
                 label: str = ""):
        self._address = address
        self._connect_timeout = connect_timeout
        self._call_timeout = call_timeout
        # watchdog participant label: one client = one monitored reader
        # ("sidecar.reader[<label>]"); callers running several clients
        # in one process (the chaos localnet) pass distinct labels
        self._label = label or (
            address if isinstance(address, str)
            else f"{address[0]}:{address[1]}"
        )
        self._retry = retry or RetryPolicy(
            attempts=3, base_delay_s=0.05, max_delay_s=0.5
        )
        self._lock = threading.Lock()  # socket slot + req ids + pending
        self._send_lock = threading.Lock()  # frame atomicity only
        self._sock: socket.socket | None = None
        self._ready = threading.Event()  # committee replay finished
        self._req_id = 0
        self._pending: dict[int, _Pending] = {}
        # (epoch, shard) -> serialized pubkeys, replayed on reconnect
        self._committees: dict = {}
        # constructor contract: a dead address fails NOW, not on first
        # use (SidecarUnavailable is a
        # ConnectionError so existing callers keep working)
        self._ensure_connected(Deadline.after(connect_timeout))

    # -- connection lifecycle ------------------------------------------------

    def _dial(self, timeout: float) -> socket.socket:
        if isinstance(self._address, str):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        try:
            sock.connect(self._address)
            # TCP self-connect quirk: dialing a FREED localhost port can
            # land on the dialer's own ephemeral port and "succeed" —
            # the frames we send would echo back as garbage responses.
            # A dead sidecar must look dead.
            if (sock.family == socket.AF_INET
                    and sock.getsockname() == sock.getpeername()):
                raise ConnectionError("self-connected socket "
                                      "(sidecar is down)")
        except OSError:
            sock.close()
            raise
        # blocking mode from here: the reader thread recvs continuously;
        # per-call deadlines are enforced by each waiter's event timeout
        sock.settimeout(None)
        return sock

    def _ensure_connected(self, deadline: Deadline) -> socket.socket:
        """Current socket, dialing lazily.  The dial winner replays the
        cached committee state BEFORE ``_ready`` is set; racing callers
        wait on it so no request can race ahead of the replay and draw
        a spurious STATUS_UNKNOWN_COMMITTEE."""
        with self._lock:
            sock, ready = self._sock, self._ready
        if sock is None:
            # the caller's deadline bounds the dial: a dead sidecar
            # costs at most the remaining budget, never a full
            # connect_timeout past it (no lock held: blocking connect)
            deadline.check("sidecar dial")
            dialed = self._dial(deadline.bound(self._connect_timeout))
            replay = False
            with self._lock:
                if self._sock is None:
                    self._sock = sock = dialed
                    self._ready = ready = threading.Event()
                    replay = True
                    threading.Thread(
                        # graftlint: thread-role=sidecar.reader
                        target=self._read_loop, args=(dialed,),
                        daemon=True,
                    ).start()
                else:
                    sock, ready = self._sock, self._ready
            if replay:
                try:
                    self._replay_committees(sock, deadline)
                except BaseException:
                    self._drop(sock)
                    raise
                ready.set()
                return sock
            try:
                dialed.close()  # lost the dial race: spare socket
            except OSError:
                pass
        if not ready.wait(deadline.bound(self._call_timeout)):
            raise SidecarUnavailable("sidecar committee replay stalled")
        return sock

    def _replay_committees(self, sock, deadline: Deadline) -> None:
        with self._lock:
            cached = sorted(self._committees.items())
        for (epoch, shard), pubkeys in cached:
            status, _ = self._request(
                sock, P.MSG_SET_COMMITTEE,
                P.build_set_committee(epoch, shard, pubkeys), deadline,
            )
            if status != P.STATUS_OK:
                raise SidecarUnavailable(
                    f"committee replay refused: status {status}"
                )
        if cached:
            _log.info("sidecar committees replayed", count=len(cached))

    def _read_loop(self, sock) -> None:
        """Demultiplex response frames to their waiters by request id.
        Any protocol violation — truncated frame, garbage, a reply to
        an id nobody is waiting on — is a stream desync: fail closed
        (and fire the flight recorder; a desynced verification stream
        is exactly the snapshot an operator wants)."""
        from .. import health

        # the reader registers with the liveness watchdog: parked in
        # recv with no traffic it is IDLE (healthy); silent while BUSY
        # past max_age is a wedged reader — the exact fault the
        # wedged_thread_recovery scenario injects via sidecar.frame.
        # No restart supervisor: recovery is the client's own lazy
        # redial + committee replay, which a dead reader triggers
        # through _drop on every exit path below.
        hb = health.register(f"sidecar.reader[{self._label}]",
                             thread=threading.current_thread())
        desync = None
        while True:
            try:
                hb.beat()
                # keyed by client label: scenarios can wedge ONE named
                # reader (un-keyed arms still match every client)
                FI.fire("sidecar.frame", key=self._label)
                hb.idle()  # about to park in recv: quiet != wedged.
                # The on_header hook flips back to busy the moment a
                # frame is in flight, so a peer stalling MID-frame is
                # a detectable wedge, not an invisible idle wait
                frame = P.read_frame(sock, on_header=hb.beat)
                hb.beat()
            except ValueError as e:
                desync = f"garbage frame: {e}"
                break  # never trust the stream again
            except OSError:
                break  # dead socket
            if frame is None:
                break  # clean EOF
            rtype, rid, rbody = frame
            with self._lock:
                slot = self._pending.get(rid)
            if slot is None:
                desync = f"reply to unknown request id {rid}"
                break  # reply to nobody: mid-frame desync, fail closed
            slot.frame = (rtype, rbody)
            slot.event.set()
        hb.close(reason="desync" if desync is not None else "eof")
        self._drop(sock)
        if desync is not None:
            _log.warn("sidecar stream desync", error=desync)
            trace.anomaly("sidecar_desync", error=desync)

    def _drop(self, sock) -> None:
        """Retire a socket and fail every waiter parked on it.  Only
        the CURRENT socket's death clears the pending map — a stale
        reader unwinding after a redial must not kill healthy waiters
        registered against the new connection."""
        stale: list = []
        with self._lock:
            if self._sock is sock:
                self._sock = None
                stale = list(self._pending.values())
                self._pending.clear()
        for slot in stale:
            slot.event.set()  # frame stays None -> waiter raises
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

    def close(self):
        with self._lock:
            s = self._sock
        if s is not None:
            self._drop(s)

    # -- framed RPC ----------------------------------------------------------

    def _begin(self, sock, msg_type: int, body: bytes) -> tuple:
        """Register a waiter and put the frame on the wire; returns
        (rid, slot).  The reply wait is separate (``_await``) so
        callers — notably the scheduler's backend worker — can send a
        whole batch of frames before awaiting any reply."""
        with self._lock:
            self._req_id += 1
            rid = self._req_id
            slot = _Pending()
            self._pending[rid] = slot
        try:
            # _send_lock only keeps concurrent frames from
            # interleaving; the response wait runs with NO lock held,
            # so calls overlap on the wire
            with self._send_lock:
                sock.sendall(  # graftlint: disable=GL06 frame-atomicity lock, held per send, never across the response wait
                    P.pack_frame(msg_type, rid, body,
                                 trace.traceparent())
                )
        except OSError as e:
            with self._lock:
                self._pending.pop(rid, None)
            self._drop(sock)
            raise SidecarUnavailable(f"sidecar send failed: {e}") from e
        except BaseException:
            # e.g. pack_frame's ValueError on an oversized frame:
            # nothing went on the wire, so the connection is fine —
            # but the registered waiter must not leak
            with self._lock:
                self._pending.pop(rid, None)
            raise
        return rid, slot

    def _await(self, sock, msg_type: int, rid: int, slot: "_Pending",
               deadline: Deadline):
        try:
            if not slot.event.wait(deadline.bound(self._call_timeout)):
                self._drop(sock)  # wedged sidecar: fail closed, redial
                raise SidecarUnavailable("sidecar call timed out")
            if slot.frame is None:
                raise SidecarUnavailable("sidecar connection lost")
            rtype, rbody = slot.frame
            if rtype != (msg_type | P.RESP_FLAG):
                self._drop(sock)  # wrong reply type: stream desync
                raise SidecarUnavailable("sidecar response type mismatch")
            if not rbody:
                self._drop(sock)
                raise SidecarUnavailable("empty sidecar response")
            return rbody[0], rbody[1:]
        finally:
            with self._lock:
                self._pending.pop(rid, None)

    def _request(self, sock, msg_type: int, body: bytes,
                 deadline: Deadline):
        rid, slot = self._begin(sock, msg_type, body)
        return self._await(sock, msg_type, rid, slot, deadline)

    def _call(self, msg_type: int, body: bytes,
              deadline: Deadline | None = None):
        dl = deadline or Deadline.after(self._call_timeout)
        FI.fire("sidecar.call")

        def attempt():
            sock = self._ensure_connected(dl)
            return self._request(sock, msg_type, body, dl)

        # the span covers dial + retries + replay: the time consensus
        # actually waited on the sidecar, not one socket round-trip.
        # _request reads traceparent() inside this context, so the
        # server resumes the round's trace across reconnects too.
        with trace.span("sidecar.call", component="sidecar",
                        msg_type=msg_type):
            try:
                return self._retry.run(
                    attempt, retry_on=(OSError,), deadline=dl,
                    key="sidecar",
                )
            except SidecarUnavailable as e:
                trace.annotate(error=str(e))
                raise
            except OSError as e:  # dial failures, DeadlineExceeded
                trace.annotate(error=str(e))
                raise SidecarUnavailable(
                    f"sidecar unreachable: {e}"
                ) from e

    # -- API -----------------------------------------------------------------

    def ping(self, deadline: Deadline | None = None) -> int:
        status, body = self._call(P.MSG_PING, b"", deadline)
        if status != P.STATUS_OK:
            raise RuntimeError(f"ping failed: {status}")
        return int.from_bytes(body[:2], "little")

    def set_committee(self, epoch: int, shard: int, pubkeys: list,
                      deadline: Deadline | None = None):
        status, _ = self._call(
            P.MSG_SET_COMMITTEE,
            P.build_set_committee(epoch, shard, pubkeys), deadline,
        )
        if status != P.STATUS_OK:
            raise RuntimeError(f"set_committee failed: {status}")
        with self._lock:
            self._committees[(epoch, shard)] = list(pubkeys)

    @staticmethod
    def _agg_verify_result(epoch: int, shard: int, status: int,
                           body: bytes) -> bool:
        if status == P.STATUS_UNKNOWN_COMMITTEE:
            raise KeyError(f"no committee for epoch {epoch} shard {shard}")
        if status != P.STATUS_OK:
            raise RuntimeError(f"agg_verify failed: {status}")
        return bool(body[0])

    def agg_verify(
        self, epoch: int, shard: int, payload: bytes, bitmap: bytes,
        sig: bytes, deadline: Deadline | None = None,
    ) -> bool:
        status, body = self._call(
            P.MSG_AGG_VERIFY,
            P.build_agg_verify(epoch, shard, payload, bitmap, sig),
            deadline,
        )
        return self._agg_verify_result(epoch, shard, status, body)

    def agg_verify_begin(
        self, epoch: int, shard: int, payload: bytes, bitmap: bytes,
        sig: bytes, deadline: Deadline | None = None,
    ) -> "_AsyncCall":
        """Pipelined agg_verify: the frame goes on the wire NOW; the
        returned handle's ``result()`` awaits and decodes the reply.
        One attempt, no retry/backoff — the scheduler's backend worker
        uses this to stream a whole header batch, and a failed call
        falls back to the retrying synchronous path at the caller."""
        dl = deadline or Deadline.after(self._call_timeout)
        FI.fire("sidecar.call")
        sock = self._ensure_connected(dl)
        rid, slot = self._begin(
            sock, P.MSG_AGG_VERIFY,
            P.build_agg_verify(epoch, shard, payload, bitmap, sig),
        )
        return _AsyncCall(self, sock, rid, slot, epoch, shard, dl)

    def verify_batch(self, items: list,
                     deadline: Deadline | None = None) -> list:
        status, body = self._call(
            P.MSG_VERIFY_BATCH, P.build_verify_batch(items), deadline
        )
        if status != P.STATUS_OK:
            raise RuntimeError(f"verify_batch failed: {status}")
        n = int.from_bytes(body[:4], "little")
        return [bool(b) for b in body[4 : 4 + n]]
