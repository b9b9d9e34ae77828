"""WebSocket JSON-RPC: the push half of the RPC surface.

The role of the reference's WS servers (reference: rpc/harmony/rpc.go
startHTTP/startWS pair — every namespace is served over both; plus
eth_subscribe push for newHeads/logs).  Stdlib-only RFC 6455:

* handshake: HTTP/1.1 Upgrade with the Sec-WebSocket-Accept digest;
* frames: FIN+opcode, masked client payloads, text frames only, close
  and ping handled; fragmented and >16 MB frames rejected;
* dispatch: the SAME RPCServer.dispatch as HTTP, plus
  eth_subscribe("newHeads" | "logs") — a per-connection poller thread
  pushes notifications in the eth_subscription envelope.

The port's copy of the JAX package's ``rpc/ws.py``.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
import time

_WS_MAGIC = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_FRAME = 16 * 1024 * 1024


def _accept_key(client_key: str) -> str:
    return base64.b64encode(
        hashlib.sha1(client_key.encode() + _WS_MAGIC).digest()
    ).decode()


def _recv_exact(sock, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def read_frame(sock):
    """(opcode, payload) or None on close/EOF/protocol error."""
    hdr = _recv_exact(sock, 2)
    if hdr is None:
        return None
    fin, opcode = hdr[0] & 0x80, hdr[0] & 0x0F
    masked, ln = hdr[1] & 0x80, hdr[1] & 0x7F
    if not fin:
        return None  # fragmentation unsupported: drop the connection
    if ln == 126:
        ext = _recv_exact(sock, 2)
        if ext is None:
            return None
        ln = struct.unpack(">H", ext)[0]
    elif ln == 127:
        ext = _recv_exact(sock, 8)
        if ext is None:
            return None
        ln = struct.unpack(">Q", ext)[0]
    if ln > MAX_FRAME:
        return None
    mask = _recv_exact(sock, 4) if masked else b"\x00" * 4
    if mask is None:
        return None
    payload = _recv_exact(sock, ln)
    if payload is None:
        return None
    if masked:
        payload = bytes(
            b ^ mask[i % 4] for i, b in enumerate(payload)
        )
    return opcode, payload


def write_frame(sock, payload: bytes, opcode: int = 0x1):
    ln = len(payload)
    hdr = bytes([0x80 | opcode])
    if ln < 126:
        hdr += bytes([ln])
    elif ln < 1 << 16:
        hdr += bytes([126]) + struct.pack(">H", ln)
    else:
        hdr += bytes([127]) + struct.pack(">Q", ln)
    sock.sendall(hdr + payload)


class WSServer:
    """WebSocket front over an RPCServer's dispatch + subscriptions."""

    def __init__(self, rpc, port: int = 0, poll_interval: float = 0.25):
        self.rpc = rpc  # RPCServer (dispatch + hmy facade)
        self.poll_interval = poll_interval
        self._closing = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(16)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(
            # graftlint: thread-role=serving
            target=self._accept_loop, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._closing = True
        try:
            self._srv.close()
        except OSError:
            pass

    # -- connection handling ------------------------------------------------

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

    def _handshake(self, sock) -> bool:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = sock.recv(4096)
            if not chunk or len(data) > 16384:
                return False
            data += chunk
        headers = {}
        for line in data.split(b"\r\n")[1:]:
            if b":" in line:
                k, _, v = line.partition(b":")
                headers[k.strip().lower()] = v.strip()
        key = headers.get(b"sec-websocket-key")
        if key is None:
            return False
        sock.sendall(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Upgrade: websocket\r\nConnection: Upgrade\r\n"
            b"Sec-WebSocket-Accept: "
            + _accept_key(key.decode()).encode() + b"\r\n\r\n"
        )
        return True

    def _serve_conn(self, sock):
        subs: dict[str, dict] = {}  # sub id -> {"kind", "last_block"}
        lock = threading.Lock()
        # one writer at a time: the request loop and the pusher thread
        # share this socket, and interleaved sendall calls would splice
        # two WS frames together mid-header.  Held only around a single
        # write_frame — never across dispatch or chain reads
        wlock = threading.Lock()
        stop = threading.Event()

        def write(payload: bytes, opcode: int = 0x1):
            with wlock:
                write_frame(sock, payload, opcode)

        def pusher():
            while not stop.is_set() and not self._closing:
                try:
                    self._push_round(subs, lock, write)
                except OSError:
                    return
                stop.wait(self.poll_interval)

        try:
            if not self._handshake(sock):
                return
            threading.Thread(
                target=pusher, daemon=True,  # graftlint: thread-role=transient
            ).start()
            while not self._closing:
                frame = read_frame(sock)
                if frame is None:
                    return
                opcode, payload = frame
                if opcode == 0x8:  # close
                    write(b"", 0x8)
                    return
                if opcode == 0x9:  # ping
                    write(payload, 0xA)
                    continue
                if opcode != 0x1:
                    continue
                try:
                    req = json.loads(payload)
                except ValueError:
                    continue
                out = self._dispatch_ws(req, subs, lock)
                write(json.dumps(out).encode())
        except OSError:
            pass
        finally:
            stop.set()
            try:
                sock.close()
            except OSError:
                pass

    # -- subscription dispatch ----------------------------------------------

    def _dispatch_ws(self, req, subs, lock):
        method = req.get("method", "")
        if method.endswith("_subscribe"):
            params = req.get("params") or []
            kind = params[0] if params else ""
            if kind not in ("newHeads", "logs",
                            "newPendingTransactions"):
                return self.rpc._error(
                    req.get("id"), -32602, f"unsupported: {kind}"
                )
            sub_id = hex(int(time.monotonic_ns()))
            with lock:
                subs[sub_id] = {
                    "kind": kind,
                    "criteria": params[1] if len(params) > 1 else {},
                    "last_block": self.rpc.hmy.block_number(),
                    # pending-tx subs push only txs admitted AFTER the
                    # subscription (geth semantics); the pool's
                    # admission ring catches txs that enter and leave
                    # within one poll interval
                    "seq": self._pool_seq(),
                }
            return {"jsonrpc": "2.0", "id": req.get("id"),
                    "result": sub_id}
        if method.endswith("_unsubscribe"):
            params = req.get("params") or []
            with lock:
                ok = subs.pop(params[0] if params else "", None)
            return {"jsonrpc": "2.0", "id": req.get("id"),
                    "result": ok is not None}
        return self.rpc.dispatch(req)

    def _pool_seq(self) -> int:
        pool = getattr(self.rpc.hmy, "tx_pool", None)
        return pool.add_seq if pool is not None else 0

    def _push_round(self, subs, lock, write):
        with lock:
            items = list(subs.items())
        head = self.rpc.hmy.block_number()
        for sub_id, sub in items:
            if sub["kind"] == "newPendingTransactions":
                pool = getattr(self.rpc.hmy, "tx_pool", None)
                if pool is None:
                    continue
                sub["seq"], hashes = pool.adds_since(sub["seq"])
                for h in hashes:
                    self._notify(write, sub_id, "0x" + h.hex())
                continue
            since = sub["last_block"]
            if head <= since:
                continue
            sub["last_block"] = head
            if sub["kind"] == "newHeads":
                for n in range(since + 1, head + 1):
                    h = self.rpc.hmy.header_by_number(n)
                    if h is None:
                        continue
                    self._notify(
                        write, sub_id, self.rpc._header_dict(h, False)
                    )
            else:  # logs
                crit = dict(sub["criteria"])
                crit.setdefault("fromBlock", since + 1)
                crit.setdefault("toBlock", head)
                frm, to, address, topics = self.rpc._parse_log_criteria(
                    crit
                )
                for entry in self.rpc.hmy.get_logs(
                    max(frm, since + 1), to, address, topics
                ):
                    self._notify(
                        write, sub_id,
                        self.rpc._log_dict(*entry, False),
                    )

    @staticmethod
    def _notify(write, sub_id, result):
        write(json.dumps({
            "jsonrpc": "2.0",
            "method": "eth_subscription",
            "params": {"subscription": sub_id, "result": result},
        }).encode())
