"""JSON-RPC 2.0 server over HTTP.

The role of the reference's RPC stack (reference: rpc/harmony/rpc.go:
71-275 — HTTP/WS servers registering hmy/hmyv2/eth namespace APIs with
a method filter and rate limiting; eth/rpc is the forked server
internals).  Stdlib-only: a threading HTTP server dispatching
namespace_method to the hmy facade; hmyv2 returns decimal integers
where hmy/eth return 0x-hex (the reference's v1/v2 distinction).

Method names follow the reference surface: hmy_blockNumber,
hmy_getBalance, hmy_getBlockByNumber, hmy_sendRawTransaction,
hmy_getValidatorInformation, eth_* aliases, net_version, web3_*.

The port's copy of the JAX package's ``rpc/server.py``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..core.tx_pool import PoolError

JSONRPC_INTERNAL = -32603
JSONRPC_METHOD_NOT_FOUND = -32601
JSONRPC_INVALID_PARAMS = -32602
JSONRPC_PARSE_ERROR = -32700


def _hex(v: int) -> str:
    return hex(v)


def _addr(param: str) -> bytes:
    h = param[2:] if param.startswith("0x") else param
    b = bytes.fromhex(h)
    if len(b) != 20:
        raise ValueError("address must be 20 bytes")
    return b


def _block_num(param, head: int) -> int:
    if isinstance(param, str):
        if param in ("latest", "pending", "finalized", "safe"):
            return head
        if param == "earliest":
            return 0
        return int(param, 16) if param.startswith("0x") else int(param)
    return int(param)


from ..ratelimit import RateLimiter  # noqa: E402 — shared bucket impl


class _Filters:
    """Installed eth filters (reference: eth/filters — polling model:
    newFilter / getFilterChanges / uninstallFilter)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._next = 1
        self._filters: dict = {}  # id -> {"kind", "last_block", criteria}

    def install(self, kind: str, criteria: dict | None = None,
                head: int = 0) -> int:
        with self._lock:
            fid = self._next
            self._next += 1
            self._filters[fid] = {
                "kind": kind, "last_block": head,
                "criteria": criteria or {},
            }
            return fid

    def get(self, fid: int):
        with self._lock:
            return self._filters.get(fid)

    def take_range(self, fid: int, head: int):
        """Atomically advance the filter's cursor to ``head`` and
        return (kind, criteria, since) — concurrent polls under the
        ThreadingHTTPServer must not double- or under-report."""
        with self._lock:
            f = self._filters.get(fid)
            if f is None:
                return None
            since = f["last_block"]
            f["last_block"] = head
            return f["kind"], dict(f["criteria"]), since

    def uninstall(self, fid: int) -> bool:
        with self._lock:
            return self._filters.pop(fid, None) is not None


class RPCServer:
    def __init__(self, hmy, port: int = 0, method_allowlist=None,
                 rate_limiter: RateLimiter | None = None):
        self.hmy = hmy
        self.allow = set(method_allowlist) if method_allowlist else None
        self.limiter = rate_limiter or RateLimiter()
        self.filters = _Filters()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                ip = self.client_address[0]
                if not outer.limiter.allow(ip):
                    self.send_response(429)
                    self.end_headers()
                    return
                # resource-governor admission: PRESSURED
                # rate-limits per client, CRITICAL refuses outright —
                # a node past rated capacity serves 429s, not OOM kills
                from .. import governor as GV

                if not GV.admit_ingress(ip, surface="rpc"):
                    self.send_response(429)
                    self.send_header("Retry-After", "1")
                    self.end_headers()
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length))
                except (ValueError, KeyError):
                    body = outer._error(None, JSONRPC_PARSE_ERROR,
                                        "parse error")
                    self._reply(body)
                    return
                if isinstance(req, list):  # batch (bounded)
                    body = [outer.dispatch(r) for r in req[:100]]
                else:
                    body = outer.dispatch(req)
                self._reply(body)

            def _reply(self, body):
                data = json.dumps(body).encode()
                self.send_response(200)
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
        # shutdown() BLOCKS FOREVER if serve_forever never ran — guard
        # so stopping a constructed-but-never-started server is a no-op
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()

    # -- dispatch -----------------------------------------------------------

    @staticmethod
    def _error(req_id, code, message):
        return {
            "jsonrpc": "2.0", "id": req_id,
            "error": {"code": code, "message": message},
        }

    def dispatch(self, req) -> dict:
        if not isinstance(req, dict):
            return self._error(None, -32600, "invalid request object")
        req_id = req.get("id")
        method = req.get("method", "")
        params = req.get("params", [])
        if self.allow is not None and method not in self.allow:
            return self._error(req_id, JSONRPC_METHOD_NOT_FOUND,
                               f"method {method} not allowed")
        if "_" not in method:
            return self._error(req_id, JSONRPC_METHOD_NOT_FOUND,
                               f"malformed method {method}")
        namespace, name = method.split("_", 1)
        fn = getattr(self, f"_{name}", None)
        if fn is None or namespace not in (
            "hmy", "hmyv2", "eth", "net", "web3", "debug"
        ):
            return self._error(req_id, JSONRPC_METHOD_NOT_FOUND,
                               f"method {method} not found")
        v2 = namespace == "hmyv2"
        try:
            result = fn(params, v2)
        except (ValueError, KeyError, IndexError, TypeError) as e:
            return self._error(req_id, JSONRPC_INVALID_PARAMS, str(e))
        except PoolError as e:
            return self._error(req_id, JSONRPC_INTERNAL, str(e))
        return {"jsonrpc": "2.0", "id": req_id, "result": result}

    # -- methods (shared across namespaces; v2 = decimal ints) --------------

    def _int(self, v: int, v2: bool):
        return v if v2 else _hex(v)

    def _blockNumber(self, params, v2):
        return self._int(self.hmy.block_number(), v2)

    def _chainId(self, params, v2):
        return self._int(self.hmy.chain_id(), v2)

    def _version(self, params, v2):  # net_version
        return str(self.hmy.chain_id())

    def _clientVersion(self, params, v2):  # web3_clientVersion
        return "harmony-tpu/0.1"

    def _shardID(self, params, v2):
        return self.hmy.shard_id()

    def _getEpoch(self, params, v2):
        return self._int(self.hmy.current_epoch(), v2)

    def _getBalance(self, params, v2):
        addr = _addr(params[0])
        num = None
        if len(params) > 1:
            num = _block_num(params[1], self.hmy.block_number())
        return self._int(self.hmy.get_balance(addr, num), v2)

    def _getTransactionCount(self, params, v2):
        return self._int(self.hmy.get_nonce(_addr(params[0])), v2)

    def _header_dict(self, h, v2):
        return {
            "number": self._int(h.block_num, v2),
            "epoch": self._int(h.epoch, v2),
            "shardID": h.shard_id,
            "viewID": self._int(h.view_id, v2),
            "hash": "0x" + h.hash().hex(),
            "parentHash": "0x" + h.parent_hash.hex(),
            "stateRoot": "0x" + h.root.hex(),
            "transactionsRoot": "0x" + h.tx_root.hex(),
            "timestamp": self._int(h.timestamp, v2),
            "lastCommitSig": "0x" + h.last_commit_sig.hex(),
            "lastCommitBitmap": "0x" + h.last_commit_bitmap.hex(),
        }

    def _tx_dict(self, tx, block_num, idx, v2):
        chain_id = self.hmy.chain_id()
        return {
            "hash": "0x" + tx.hash(chain_id).hex(),
            "nonce": self._int(tx.nonce, v2),
            "from": "0x" + tx.sender(chain_id).hex(),
            "to": ("0x" + tx.to.hex()) if tx.to else None,
            "value": self._int(tx.value, v2),
            "gas": self._int(tx.gas_limit, v2),
            "gasPrice": self._int(tx.gas_price, v2),
            "shardID": tx.shard_id,
            "toShardID": tx.to_shard,
            "blockNumber": self._int(block_num, v2),
            "transactionIndex": self._int(idx, v2),
            "input": "0x" + tx.data.hex(),
        }

    def _getBlockByNumber(self, params, v2):
        num = _block_num(params[0], self.hmy.block_number())
        full = bool(params[1]) if len(params) > 1 else False
        block = self.hmy.block_by_number(num)
        if block is None:
            return None
        out = self._header_dict(block.header, v2)
        chain_id = self.hmy.chain_id()
        if full:
            out["transactions"] = [
                self._tx_dict(tx, num, i, v2)
                for i, tx in enumerate(block.transactions)
            ]
        else:
            out["transactions"] = [
                "0x" + tx.hash(chain_id).hex()
                for tx in block.transactions
            ]
        out["stakingTransactions"] = [
            "0x" + stx.hash(chain_id).hex()
            for stx in block.staking_transactions
        ]
        return out

    def _getBlockByHash(self, params, v2):
        block = self.hmy.block_by_hash(bytes.fromhex(params[0][2:]))
        if block is None:
            return None
        return self._getBlockByNumber([block.block_num, *params[1:]], v2)

    def _getTransactionByHash(self, params, v2):
        found = self.hmy.get_transaction(bytes.fromhex(params[0][2:]))
        if found is None:
            return None
        num, idx, tx = found
        return self._tx_dict(tx, num, idx, v2)

    def _sendRawTransaction(self, params, v2):
        blob = bytes.fromhex(params[0][2:] if params[0].startswith("0x")
                             else params[0])
        return "0x" + self.hmy.send_raw_transaction(blob).hex()

    def _sendRawStakingTransaction(self, params, v2):
        blob = bytes.fromhex(params[0][2:] if params[0].startswith("0x")
                             else params[0])
        return "0x" + self.hmy.send_raw_staking_transaction(blob).hex()

    def _getAllValidatorAddresses(self, params, v2):
        return ["0x" + a.hex() for a in self.hmy.validator_addresses()]

    def _getValidatorInformation(self, params, v2):
        return self.hmy.validator_information(_addr(params[0]))

    def _getTotalStaking(self, params, v2):
        return self._int(self.hmy.total_staking(), v2)

    def _getCommittee(self, params, v2):
        epoch = int(params[0]) if params else None
        return ["0x" + k.hex() for k in self.hmy.committee(epoch)]

    def _getBlockSigners(self, params, v2):
        """Keys that signed block N (from the stored commit bitmap)."""
        from ..staking.availability import block_signers

        num = _block_num(params[0], self.hmy.block_number())
        proof = self.hmy.read_commit_sig(num)
        if proof is None:
            return []
        epoch = self.hmy.chain.epoch_of(num)
        committee = self.hmy.committee(epoch)
        signed, _ = block_signers(proof[96:], committee)
        return ["0x" + k.hex() for k in signed]

    # -- receipts / logs / filters (reference: rpc transaction.go
    # GetTransactionReceipt + eth/filters polling API) -----------------

    def _log_dict(self, num, tx_hash, idx, addr, topics, data, v2):
        return {
            "address": "0x" + addr.hex(),
            "topics": ["0x" + t.hex() for t in topics],
            "data": "0x" + data.hex(),
            "blockNumber": self._int(num, v2),
            "transactionHash": "0x" + tx_hash.hex(),
            "logIndex": self._int(idx, v2),
        }

    def _getTransactionReceipt(self, params, v2):
        found = self.hmy.get_receipt(bytes.fromhex(params[0][2:]))
        if found is None:
            return None
        num, idx, rc = found
        out = {
            "transactionHash": "0x" + rc.tx_hash.hex(),
            "blockNumber": self._int(num, v2),
            "transactionIndex": self._int(idx, v2),
            "status": self._int(rc.status, v2),
            "gasUsed": self._int(rc.gas_used, v2),
            "cumulativeGasUsed": self._int(rc.cumulative_gas, v2),
            "logs": [
                self._log_dict(num, rc.tx_hash, i, a, t, d, v2)
                for i, (a, t, d) in enumerate(rc.logs)
            ],
            "contractAddress": (
                "0x" + rc.contract_address.hex()
                if rc.contract_address else None
            ),
        }
        return out

    def _parse_log_criteria(self, crit):
        head = self.hmy.block_number()
        frm = _block_num(crit.get("fromBlock", "latest"), head)
        to = _block_num(crit.get("toBlock", "latest"), head)
        address = _addr(crit["address"]) if crit.get("address") else None
        topics = None
        if crit.get("topics"):
            topics = [
                bytes.fromhex(t[2:]) if isinstance(t, str) else None
                for t in crit["topics"]
            ]
        return frm, to, address, topics

    def _getLogs(self, params, v2):
        frm, to, address, topics = self._parse_log_criteria(
            params[0] if params else {}
        )
        return [
            self._log_dict(*entry, v2)
            for entry in self.hmy.get_logs(frm, to, address, topics)
        ]

    def _newFilter(self, params, v2):
        fid = self.filters.install(
            "logs", params[0] if params else {}, self.hmy.block_number()
        )
        return self._int(fid, v2)

    def _newBlockFilter(self, params, v2):
        return self._int(
            self.filters.install("blocks", head=self.hmy.block_number()), v2
        )

    def _newPendingTransactionFilter(self, params, v2):
        return self._int(
            self.filters.install("pending", head=self.hmy.block_number()),
            v2,
        )

    def _getFilterChanges(self, params, v2):
        fid = int(params[0], 16) if isinstance(params[0], str) else params[0]
        head = self.hmy.block_number()
        taken = self.filters.take_range(fid, head)
        if taken is None:
            raise ValueError("filter not found")
        kind, criteria, since = taken
        f = {"kind": kind, "criteria": criteria}
        if f["kind"] == "blocks":
            out = []
            for n in range(since + 1, head + 1):
                h = self.hmy.header_by_number(n)
                if h is not None:
                    out.append("0x" + h.hash().hex())
            return out
        if f["kind"] == "pending":
            return []  # pending pool surface: poll blocks instead
        crit = dict(f["criteria"])
        crit.setdefault("fromBlock", since + 1)
        crit.setdefault("toBlock", head)
        frm, to, address, topics = self._parse_log_criteria(crit)
        return [
            self._log_dict(*e, v2)
            for e in self.hmy.get_logs(max(frm, since + 1), to,
                                       address, topics)
        ]

    def _getFilterLogs(self, params, v2):
        fid = int(params[0], 16) if isinstance(params[0], str) else params[0]
        f = self.filters.get(fid)
        if f is None or f["kind"] != "logs":
            raise ValueError("filter not found")
        frm, to, address, topics = self._parse_log_criteria(f["criteria"])
        return [
            self._log_dict(*e, v2)
            for e in self.hmy.get_logs(frm, to, address, topics)
        ]

    def _uninstallFilter(self, params, v2):
        fid = int(params[0], 16) if isinstance(params[0], str) else params[0]
        return self.filters.uninstall(fid)

    # -- EVM reads (reference: rpc contract.go Call/EstimateGas/GetCode) ---

    def _call_args(self, obj):
        frm = _addr(obj["from"]) if obj.get("from") else b"\x00" * 20
        to = _addr(obj["to"]) if obj.get("to") else None
        value = int(obj.get("value", "0x0"), 16) if isinstance(
            obj.get("value", 0), str) else int(obj.get("value", 0))
        data_hex = obj.get("data", obj.get("input", "0x")) or "0x"
        data = bytes.fromhex(data_hex[2:])
        gas = int(obj.get("gas", "0x989680"), 16) if isinstance(
            obj.get("gas", 0), str) else int(obj.get("gas") or 10_000_000)
        return frm, to, value, data, gas

    def _call(self, params, v2):
        frm, to, value, data, gas = self._call_args(params[0])
        ok, _gas_left, out, _ = self.hmy.call(frm, to, value, data, gas)
        if not ok:
            raise ValueError("execution reverted: 0x" + out.hex())
        return "0x" + out.hex()

    def _estimateGas(self, params, v2):
        frm, to, value, data, _ = self._call_args(params[0])
        return self._int(self.hmy.estimate_gas(frm, to, value, data), v2)

    def _getCode(self, params, v2):
        return "0x" + self.hmy.get_code(_addr(params[0])).hex()

    def _getStorageAt(self, params, v2):
        slot_param = params[1]
        slot_int = int(slot_param, 16) if isinstance(slot_param, str) \
            else int(slot_param)
        v = self.hmy.get_storage_at(
            _addr(params[0]), slot_int.to_bytes(32, "big")
        )
        return "0x" + v.to_bytes(32, "big").hex()

    def _gasPrice(self, params, v2):
        return self._int(1_000_000_000, v2)  # min gas price placeholder

    def _pendingTransactions(self, params, v2):
        """hmy_pendingTransactions (reference: rpc/transaction.go
        PendingTransactions): the pool's executable plain txs."""
        pool = getattr(self.hmy, "tx_pool", None)
        if pool is None:
            return []
        out = []
        for tx, is_staking in pool.pending():
            if is_staking:
                continue
            d = self._tx_dict(tx, 0, 0, v2)
            # unmined: null placement, per the reference/eth semantics
            d["blockNumber"] = None
            d["transactionIndex"] = None
            out.append(d)
        return out

    def _pendingStakingTransactions(self, params, v2):
        """hmy_pendingStakingTransactions (reference: the staking
        lane of PendingTransactions)."""
        pool = getattr(self.hmy, "tx_pool", None)
        if pool is None:
            return []
        chain_id = self.hmy.chain_id()
        return [
            {
                "hash": "0x" + tx.hash(chain_id).hex(),
                "nonce": self._int(tx.nonce, v2),
                "from": "0x" + tx.sender(chain_id).hex(),
                "type": tx.directive.name,
                "gas": self._int(tx.gas_limit, v2),
                "gasPrice": self._int(tx.gas_price, v2),
            }
            for tx, is_staking in pool.pending()
            if is_staking
        ]

    def _traceBlockByNumber(self, params, v2):
        """debug_traceBlockByNumber: every tx of a block under the
        selected tracer (reference: eth/tracers API)."""
        num = _block_num(params[0], self.hmy.block_number())
        block = self.hmy.block_by_number(num)
        if block is None:
            return None
        opts = params[1] if len(params) > 1 and params[1] else {}
        chain_id = self.hmy.chain_id()
        # ONE parent state, evolved tx by tx: intra-block dependencies
        # (a tx reading its predecessor's writes) trace as executed
        state = self.hmy.chain.state_at(num - 1).copy()
        out = []
        for tx in block.transactions:
            out.append({
                "txHash": "0x" + tx.hash(chain_id).hex(),
                "result": self._trace_core(tx, num, state, opts),
            })
        return out

    def _getCXReceiptByHash(self, params, v2):
        """hmyv2_getCXReceiptByHash (reference: rpc/transaction.go):
        the cross-shard receipt minted by a source-shard tx."""
        cx = self.hmy.get_cx_receipt_by_hash(
            bytes.fromhex(params[0][2:])
        )
        if cx is None:
            return None
        header = self.hmy.header_by_number(cx.block_num)
        # keys per the reference's rpc CxReceipt json tags
        # (rpc/harmony/v2/types.go:253-262)
        return {
            "blockHash": "0x" + (
                header.hash().hex() if header else "00" * 32
            ),
            "blockNumber": self._int(cx.block_num, v2),
            "hash": "0x" + cx.tx_hash.hex(),
            "from": "0x" + cx.sender.hex(),
            "to": "0x" + cx.to.hex(),
            "shardID": cx.from_shard,
            "toShardID": cx.to_shard,
            "value": self._int(cx.amount, v2),
        }

    def _getProof(self, params, v2):
        """eth_getProof (reference: the go-ethereum GetProof RPC the
        fork carries): Merkle account + storage proofs against the
        MPT state commitment (StateDB.mpt_root) — verifiable with
        core/trie.verify_proof.  Note the account leaf is this chain's
        5-field RLP (nonce, balance, storageRoot, codeHash,
        validatorHash); the extra field carries staking state."""
        from .. import rlp as _rlp

        addr = _addr(params[0])
        slots = [
            (int(s, 16) if isinstance(s, str) else int(s)).to_bytes(
                32, "big"
            )
            for s in (params[1] or [])
        ]
        num = None
        if len(params) > 2 and params[2] is not None:
            num = _block_num(params[2], self.hmy.block_number())
        root, leaf, acct_proof, storage = self.hmy.get_proof(
            addr, slots, num
        )
        from ..core.trie import EMPTY_ROOT
        from ..ref.keccak import keccak256 as _keccak

        nonce, balance = 0, 0
        storage_root, code_hash = EMPTY_ROOT, _keccak(b"")
        if leaf:
            fields = _rlp.decode(leaf)
            nonce = _rlp.decode_int(fields[0])
            balance = _rlp.decode_int(fields[1])
            storage_root, code_hash = fields[2], fields[3]
        return {
            "address": "0x" + addr.hex(),
            "stateRoot": "0x" + root.hex(),
            "balance": self._int(balance, v2),
            "nonce": self._int(nonce, v2),
            "codeHash": "0x" + code_hash.hex(),
            "storageHash": "0x" + storage_root.hex(),
            "accountProof": ["0x" + n.hex() for n in acct_proof],
            "storageProof": [
                {
                    "key": "0x" + slot.hex(),
                    "value": self._int(val, v2),
                    "proof": ["0x" + n.hex() for n in nodes],
                }
                for slot, val, nodes in storage
            ],
        }

    # -- debug namespace (reference: eth/tracers callTracer) ---------------

    def _traceTransaction(self, params, v2):
        """Re-execute a mined transaction under a tracer against its
        parent state (reference: debug_traceTransaction + eth/tracers).
        The tracer option selects callTracer / prestateTracer; with no
        option the geth-default opcode structLogs come back."""
        tx_hash = bytes.fromhex(params[0][2:])
        found = self.hmy.get_transaction(tx_hash)
        if found is None:
            return None
        num, _idx, tx = found
        opts = params[1] if len(params) > 1 and params[1] else {}
        state = self.hmy.chain.state_at(num - 1).copy()
        return self._trace_core(tx, num, state, opts)

    def _trace_core(self, tx, num: int, state, opts: dict):
        """One tx replayed under a tracer ON the given state — the
        state EVOLVES (value moves, storage writes, nonce bump, fee
        debit), so a block-level caller chains txs cumulatively."""
        from ..core.vm import (
            EVM, CallTracer, Env, FourByteTracer, NgramTracer,
            NoopTracer, OpcountTracer, PrestateTracer, StructLogTracer,
        )

        which = opts.get("tracer", "")
        chain_id = self.hmy.chain_id()
        sender = tx.sender(chain_id)
        env = Env(block_num=num, chain_id=chain_id,
                  shard_id=self.hmy.shard_id())
        # the reference serves these by NAME via its JS tracer engine
        # (hmy/tracers); here they are native implementations with the
        # same output shapes.  Arbitrary inline-JS tracers are a
        # deliberate non-goal (PARITY.md): RPC-supplied code execution.
        named = {
            "callTracer": lambda: CallTracer(),
            "prestateTracer": lambda: PrestateTracer(state),
            "noopTracer": NoopTracer,
            "opcountTracer": OpcountTracer,
            "4byteTracer": FourByteTracer,
            "unigramTracer": lambda: NgramTracer(1),
            "bigramTracer": lambda: NgramTracer(2),
            "trigramTracer": lambda: NgramTracer(3),
        }
        if which in named:
            tracer = named[which]()
        elif not which:
            tracer = StructLogTracer(
                with_stack=not (
                    opts.get("disableStack") or opts.get("disable_stack")
                ),
            )
        else:
            raise ValueError(f"unknown tracer {which!r}")
        evm = EVM(state, env, origin=sender, gas_price=tx.gas_price,
                  tracer=tracer)
        # mirror the processor's EIP-2929/2930 warm-up (without it
        # traces charge cold 2600/2100 where the canonical run paid
        # warm 100, and near-limit txs trace as out-of-gas)
        if tx.to is not None:
            evm.warm_addrs.add(tx.to)
        for al_addr, al_slots in tx.access_list:
            evm.warm_addrs.add(al_addr)
            for slot in al_slots:
                evm.warm_slots.add((al_addr, slot))
        if which == "prestateTracer":
            # capture the sender BEFORE the replay's nonce bump —
            # enter() only fires inside the call
            tracer.touch(sender)
        state.set_nonce(sender, tx.nonce + 1)
        # replay with the same budget the processor gave the VM:
        # intrinsic gas is charged up front (state_processor.py)
        from ..core.state_processor import intrinsic_gas

        intrinsic = intrinsic_gas(tx)
        budget = max(tx.gas_limit - intrinsic, 0)
        if tx.to is None:
            ok, gas_left, created = evm.create(
                sender, tx.value, tx.data, budget
            )[:3]
            # geth's returnValue for creation is the DEPLOYED code
            out = state.code(created) if ok and created else b""
        else:
            ok, gas_left, out = evm.call(
                sender, tx.to, tx.value, tx.data, budget
            )[:3]
        # fee debit, so a later tx in a cumulative block replay sees
        # the sender's true post-tx balance (the processor does this
        # on the real path)
        state.sub_balance(
            sender, (intrinsic + budget - gas_left) * tx.gas_price
        )
        if which == "callTracer":
            return tracer.root
        if which == "prestateTracer":
            return tracer.accounts
        if which:  # named profiling tracers expose .result
            return tracer.result
        result = {
            "gas": intrinsic + (budget - gas_left),
            "failed": not ok,
            "returnValue": out.hex(),
            "structLogs": tracer.logs,
        }
        if tracer.truncated:
            result["truncated"] = True
        return result

    # -- staking reads (reference: rpc staking.go) --------------------------

    def _getDelegationsByDelegator(self, params, v2):
        return self.hmy.delegations_by_delegator(_addr(params[0]))

    def _getDelegationsByValidator(self, params, v2):
        return self.hmy.delegations_by_validator(_addr(params[0]))

    def _getElectedValidatorAddresses(self, params, v2):
        return [
            "0x" + a.hex()
            for a in self.hmy.elected_validator_addresses()
        ]

    def _getMedianRawStakeSnapshot(self, params, v2):
        return self.hmy.median_raw_stake_snapshot()
