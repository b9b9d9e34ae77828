"""Explorer service: address-indexed chain browsing over HTTP.

The role of the reference's explorer (reference: api/service/explorer —
a LevelDB-backed index of blocks/txs per address served as JSON over
HTTP, run by explorer-node configs), in the reference's operational
shape:

* the index is PERSISTENT: entries live in the chain's KV store under
  explorer-prefixed keys, so a restarted node resumes from its indexed
  height instead of rescanning the chain;
* /address paginates (pageIndex/pageSize, newest-first) the way the
  reference's GetExplorerAddress does — a whale address cannot OOM the
  response;
* staking transactions index alongside plain ones (type STAKING);
* addresses are accepted and rendered in both 0x and one1 bech32 form.

    GET /blocks?from=N&to=M                   -> header summaries
    GET /tx?id=0x..                           -> one transaction
    GET /address?id=<0x..|one1..>&pageIndex=N&pageSize=K
    GET /height                               -> indexed height

The port's copy of the JAX package's ``explorer.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

# KV key prefixes (disjoint from core/rawdb's single-letter space by
# the "x!" lead-in)
_K_HEIGHT = b"x!h"
_K_COUNT = b"x!c"   # + addr -> u64 entry count
_K_ENTRY = b"x!a"   # + addr + seq(8 BE) -> num(8) || hash(32) || dir(1)
_K_TX = b"x!t"      # + tx hash -> num(8) || idx(4) || staking(1)

_DIRS = {0: "SENT", 1: "RECEIVED", 2: "STAKING"}
_MAX_PAGE = 1000


class ExplorerIndex:
    """Address -> transaction-history index, persisted in the chain's
    KV store (reference: explorer storage.go's LevelDB index)."""

    def __init__(self, chain):
        self.chain = chain
        blob = chain.db.get(_K_HEIGHT)
        self.height = int.from_bytes(blob, "big") if blob else 0
        self._lock = threading.Lock()

    # -- writes -------------------------------------------------------------

    def _append(self, addr: bytes, num: int, tx_hash: bytes, dir_: int):
        db = self.chain.db
        cnt_key = _K_COUNT + addr
        blob = db.get(cnt_key)
        seq = int.from_bytes(blob, "big") if blob else 0
        db.put(
            _K_ENTRY + addr + seq.to_bytes(8, "big"),
            num.to_bytes(8, "big") + tx_hash + bytes([dir_]),
        )
        db.put(cnt_key, (seq + 1).to_bytes(8, "big"))

    def index_through(self, head: int | None = None):
        head = self.chain.head_number if head is None else head
        chain_id = self.chain.config.chain_id
        with self._lock:
            for num in range(self.height + 1, head + 1):
                block = self.chain.block_by_number(num)
                if block is None:
                    continue
                for i, tx in enumerate(block.transactions):
                    h = tx.hash(chain_id)
                    self.chain.db.put(
                        _K_TX + h,
                        num.to_bytes(8, "big") + i.to_bytes(4, "big")
                        + b"\x00",
                    )
                    self._append(tx.sender(chain_id), num, h, 0)
                    if tx.to is not None:
                        self._append(tx.to, num, h, 1)
                for i, stx in enumerate(block.staking_transactions):
                    h = stx.hash(chain_id)
                    self.chain.db.put(
                        _K_TX + h,
                        num.to_bytes(8, "big") + i.to_bytes(4, "big")
                        + b"\x01",
                    )
                    self._append(stx.sender(chain_id), num, h, 2)
                self.height = num
                self.chain.db.put(_K_HEIGHT, num.to_bytes(8, "big"))

    # -- reads --------------------------------------------------------------

    def address_count(self, addr: bytes) -> int:
        blob = self.chain.db.get(_K_COUNT + addr)
        return int.from_bytes(blob, "big") if blob else 0

    def address_page(self, addr: bytes, page_index: int,
                     page_size: int) -> list:
        """Newest-first page of (num, tx_hash, direction)."""
        total = self.address_count(addr)
        start = total - 1 - page_index * page_size
        out = []
        for seq in range(start, max(start - page_size, -1), -1):
            blob = self.chain.db.get(
                _K_ENTRY + addr + seq.to_bytes(8, "big")
            )
            if blob is None:
                continue
            out.append((
                int.from_bytes(blob[:8], "big"), blob[8:40],
                _DIRS.get(blob[40], "?"),
            ))
        return out

    def tx_location(self, tx_hash: bytes):
        blob = self.chain.db.get(_K_TX + tx_hash)
        if blob is None:
            return None
        return (int.from_bytes(blob[:8], "big"),
                int.from_bytes(blob[8:12], "big"), blob[12] == 1)


def _parse_addr(s: str) -> bytes:
    if s.startswith("one1"):
        from .accounts.bech32 import one_to_address

        return one_to_address(s)
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


class ExplorerServer:
    """HTTP front-end over the index (reference: explorer service.go
    GetExplorerBlocks / GetExplorerTransaction / GetExplorerAddress)."""

    def __init__(self, chain, port: int = 0):
        self.index = ExplorerIndex(chain)
        self.chain = chain
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                url = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    body = outer._route(url.path, q)
                except (ValueError, KeyError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                if body is None:
                    self._reply(404, {"error": "not found"})
                else:
                    self._reply(200, body)

            def _reply(self, status, obj):
                data = json.dumps(obj).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()

    # -- routes -------------------------------------------------------------

    def _header_summary(self, h):
        return {
            "number": h.block_num,
            "hash": "0x" + h.hash().hex(),
            "parentHash": "0x" + h.parent_hash.hex(),
            "epoch": h.epoch,
            "shardID": h.shard_id,
            "viewID": h.view_id,
            "timestamp": h.timestamp,
        }

    def _tx_summary(self, tx, num):
        chain_id = self.chain.config.chain_id
        return {
            "hash": "0x" + tx.hash(chain_id).hex(),
            "from": "0x" + tx.sender(chain_id).hex(),
            "to": ("0x" + tx.to.hex()) if tx.to else None,
            "value": tx.value,
            "blockNumber": num,
        }

    def _route(self, path: str, q: dict):
        self.index.index_through()
        if path == "/height":
            return {"height": self.index.height}
        if path == "/blocks":
            frm = int(q.get("from", max(self.index.height - 9, 0)))
            to = int(q.get("to", self.index.height))
            if to - frm > 256:
                raise ValueError("range too wide (max 256)")
            out = []
            for num in range(frm, to + 1):
                h = self.chain.header_by_number(num)
                if h is not None:
                    out.append(self._header_summary(h))
            return out
        if path == "/tx":
            tx_hash = bytes.fromhex(q["id"][2:])
            loc = self.index.tx_location(tx_hash)
            if loc is None:
                return None
            num, i, staking = loc
            block = self.chain.block_by_number(num)
            txs = (block.staking_transactions if staking
                   else block.transactions)
            out = self._tx_summary(txs[i], num)
            if staking:
                out["type"] = "STAKING"
            return out
        if path == "/address":
            from .accounts.bech32 import address_to_one

            addr = _parse_addr(q["id"])
            page_index = int(q.get("pageIndex", 0))
            page_size = min(int(q.get("pageSize", 100)), _MAX_PAGE)
            if page_index < 0 or page_size <= 0:
                raise ValueError("bad page parameters")
            history = [
                {"hash": "0x" + h.hex(), "blockNumber": num,
                 "type": direction}
                for num, h, direction in self.index.address_page(
                    addr, page_index, page_size
                )
            ]
            return {
                "id": "0x" + addr.hex(),
                "one": address_to_one(addr),
                "balance": self.chain.state().balance(addr),
                "txCount": self.index.address_count(addr),
                "pageIndex": page_index,
                "pageSize": page_size,
                "txs": history,
            }
        return None
