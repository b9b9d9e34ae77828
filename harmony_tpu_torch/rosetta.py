"""Rosetta Data API: the Coinbase-spec chain-access surface.

The role of the reference's rosetta/ package (reference:
rosetta/rosetta.go + rosetta/services — NetworkAPI/BlockAPI/AccountAPI
controllers over the hmy facade).  This serves the Data API subset a
Rosetta integrator reads first, as POST JSON endpoints:

    /network/list     -> the one (shard) network identifier
    /network/status   -> genesis + current block identifiers
    /network/options  -> version + operation vocabulary
    /block            -> block + transfer operations
    /account/balance  -> balance at the head block

plus the Construction API (reference: rosetta/services/construction.go
+ construction_create.go + construction_submit.go), the offline/online
split of the signing flow:

    /construction/derive      -> secp256k1 pubkey to address   (offline)
    /construction/preprocess  -> operations to options         (offline)
    /construction/metadata    -> nonce + suggested fee         (online)
    /construction/payloads    -> unsigned tx + signing payload (offline)
    /construction/parse       -> tx back to operations         (offline)
    /construction/combine     -> unsigned tx + sig = signed tx (offline)
    /construction/hash        -> signed tx hash                (offline)
    /construction/submit      -> broadcast to the pool         (online)

Operation vocabulary mirrors the reference's rosetta operation types
(NativeTransfer / Gas — rosetta/common/operations.go).  Signatures are
Rosetta ``ecdsa_recovery`` (65-byte R||S||V), exactly the wire format
core/types.Transaction carries.

The port's copy of the JAX package's ``rosetta.py``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

ROSETTA_VERSION = "1.4.10"
BLOCKCHAIN = "Harmony"


class RosettaServer:
    def __init__(self, hmy, port: int = 0):
        self.hmy = hmy
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_POST(self):
                try:
                    ln = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(ln) or b"{}")
                except ValueError:
                    self._reply(500, {"code": 1, "message": "parse error"})
                    return
                fn = {
                    "/network/list": outer._network_list,
                    "/network/status": outer._network_status,
                    "/network/options": outer._network_options,
                    "/block": outer._block,
                    "/account/balance": outer._account_balance,
                    "/construction/derive": outer._cons_derive,
                    "/construction/preprocess": outer._cons_preprocess,
                    "/construction/metadata": outer._cons_metadata,
                    "/construction/payloads": outer._cons_payloads,
                    "/construction/parse": outer._cons_parse,
                    "/construction/combine": outer._cons_combine,
                    "/construction/hash": outer._cons_hash,
                    "/construction/submit": outer._cons_submit,
                }.get(self.path)
                if fn is None:
                    self._reply(404, {"code": 2, "message": "no route"})
                    return
                try:
                    self._reply(200, fn(req))
                except (ValueError, KeyError, TypeError, IndexError) as e:
                    self._reply(
                        500, {"code": 3, "message": str(e),
                              "retriable": False},
                    )

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

    # -- identifiers --------------------------------------------------------

    def _net_id(self):
        return {
            "blockchain": BLOCKCHAIN,
            "network": f"shard-{self.hmy.shard_id()}",
        }

    def _block_id(self, num: int):
        h = self.hmy.header_by_number(num)
        return {
            "index": num,
            "hash": "0x" + (h.hash().hex() if h else "00" * 32),
        }

    # -- endpoints ----------------------------------------------------------

    def _network_list(self, req):
        return {"network_identifiers": [self._net_id()]}

    def _network_status(self, req):
        head = self.hmy.block_number()
        return {
            "current_block_identifier": self._block_id(head),
            "genesis_block_identifier": self._block_id(0),
            "current_block_timestamp": (
                (self.hmy.header_by_number(head).timestamp or 1) * 1000
            ),
            "peers": [],
        }

    def _network_options(self, req):
        return {
            "version": {
                "rosetta_version": ROSETTA_VERSION,
                "node_version": "harmony-tpu/0.1",
            },
            "allow": {
                "operation_statuses": [
                    {"status": "success", "successful": True},
                    {"status": "failure", "successful": False},
                ],
                "operation_types": [
                    "NativeTransfer", "Gas",
                    "Delegate", "Undelegate", "CollectRewards",
                ],
                "errors": [
                    {"code": 1, "message": "parse error"},
                    {"code": 2, "message": "no route"},
                    {"code": 3, "message": "internal"},
                ],
            },
        }

    def _currency(self):
        return {"symbol": "ONE", "decimals": 18}

    def _block(self, req):
        ident = req.get("block_identifier", {})
        num = ident.get("index")
        if num is None and ident.get("hash"):
            blk = self.hmy.block_by_hash(bytes.fromhex(ident["hash"][2:]))
            num = blk.block_num if blk else self.hmy.block_number()
        if num is None:
            num = self.hmy.block_number()
        block = self.hmy.block_by_number(num)
        if block is None:
            raise ValueError(f"no block {num}")
        chain_id = self.hmy.chain_id()
        txs = []
        for tx in block.transactions:
            sender = tx.sender(chain_id)
            ops = [
                {
                    "operation_identifier": {"index": 0},
                    "type": "NativeTransfer",
                    "status": "success",
                    "account": {"address": "0x" + sender.hex()},
                    "amount": {
                        "value": str(-tx.value),
                        "currency": self._currency(),
                    },
                },
            ]
            if tx.to is not None:
                ops.append({
                    "operation_identifier": {"index": 1},
                    "related_operations": [{"index": 0}],
                    "type": "NativeTransfer",
                    "status": "success",
                    "account": {"address": "0x" + tx.to.hex()},
                    "amount": {
                        "value": str(tx.value),
                        "currency": self._currency(),
                    },
                })
            txs.append({
                "transaction_identifier": {
                    "hash": "0x" + tx.hash(chain_id).hex()
                },
                "operations": ops,
            })
        for stx in block.staking_transactions:
            # mined staking directives surface as their construction
            # operation types (a reconciler must see the delegator's
            # debit somewhere in the block)
            txs.append({
                "transaction_identifier": {
                    "hash": "0x" + stx.hash(chain_id).hex()
                },
                "operations": self._tx_ops(
                    1, stx, stx.sender(chain_id)
                ),
            })
        h = block.header
        return {
            "block": {
                "block_identifier": self._block_id(num),
                "parent_block_identifier": self._block_id(
                    max(num - 1, 0)
                ),
                "timestamp": (h.timestamp or 1) * 1000,
                "transactions": txs,
            }
        }

    def _account_balance(self, req):
        addr_hex = req["account_identifier"]["address"]
        addr = bytes.fromhex(
            addr_hex[2:] if addr_hex.startswith("0x") else addr_hex
        )
        head = self.hmy.block_number()
        return {
            "block_identifier": self._block_id(head),
            "balances": [{
                "value": str(self.hmy.get_balance(addr)),
                "currency": self._currency(),
            }],
        }

    # -- construction API ---------------------------------------------------
    # reference: rosetta/services/construction*.go — the offline half
    # never touches the chain; metadata/submit are the online half.

    @staticmethod
    def _addr(hexstr: str) -> bytes:
        return bytes.fromhex(
            hexstr[2:] if hexstr.startswith("0x") else hexstr
        )

    def _ops_to_transfer(self, ops: list):
        """The canonical 2-op NativeTransfer pair -> (frm, to, value)."""
        frm = to = None
        value = 0
        for op in ops:
            if op.get("type") != "NativeTransfer":
                continue
            amt = int(op["amount"]["value"])
            addr = self._addr(op["account"]["address"])
            if amt < 0:
                frm, value = addr, -amt
            else:
                to = addr
        if frm is None or to is None:
            raise ValueError(
                "want a debit and a credit NativeTransfer operation"
            )
        return frm, to, value

    # staking intents (reference: rosetta/common/operations.go
    # Delegate/Undelegate/CollectRewards + their OperationMetadata)
    _STAKING_OPS = {"Delegate", "Undelegate", "CollectRewards"}

    def _ops_to_intent(self, ops: list):
        """Either ("transfer", frm, to, value) or a one-op staking
        intent ("delegate"|"undelegate", delegator, validator, amount)
        / ("collect", delegator, None, 0)."""
        staking = [op for op in ops if op.get("type") in self._STAKING_OPS]
        if not staking:
            frm, to, value = self._ops_to_transfer(ops)
            return ("transfer", frm, to, value)
        if len(ops) != 1:
            raise ValueError("a staking intent is exactly one operation")
        op = staking[0]
        delegator = self._addr(op["account"]["address"])
        if op["type"] == "CollectRewards":
            return ("collect", delegator, None, 0)
        meta = op.get("metadata") or {}
        if "validatorAddress" not in meta:
            raise ValueError(
                f"{op['type']} needs metadata.validatorAddress"
            )
        validator = self._addr(meta["validatorAddress"])
        amount = int(op["amount"]["value"])
        if op["type"] == "Delegate":
            if amount >= 0:
                raise ValueError(
                    "Delegate debits the delegator: amount must be "
                    "negative"
                )
            return ("delegate", delegator, validator, -amount)
        if amount <= 0:
            raise ValueError(
                "Undelegate returns funds: amount must be positive"
            )
        return ("undelegate", delegator, validator, amount)

    def _cons_derive(self, req):
        from .crypto_ecdsa import decompress_pubkey, pub_to_address

        raw = bytes.fromhex(req["public_key"]["hex_bytes"])
        if len(raw) == 33:  # SEC1 compressed — the standard wire form
            pub = decompress_pubkey(raw)
        else:
            if len(raw) == 65 and raw[0] == 0x04:
                raw = raw[1:]  # uncompressed SEC1 envelope
            if len(raw) != 64:
                raise ValueError(
                    "want a 33-byte compressed or 64/65-byte "
                    "uncompressed secp256k1 key"
                )
            pub = (int.from_bytes(raw[:32], "big"),
                   int.from_bytes(raw[32:], "big"))
        return {
            "account_identifier": {
                "address": "0x" + pub_to_address(pub).hex()
            }
        }

    def _cons_preprocess(self, req):
        intent = self._ops_to_intent(req["operations"])
        frm = intent[1]
        return {
            "options": {"from": "0x" + frm.hex(), "kind": intent[0]},
            "required_public_keys": [
                {"address": "0x" + frm.hex()}
            ],
        }

    def _cons_metadata(self, req):
        opts = req.get("options") or {}
        frm = self._addr(opts["from"])
        gas_limit = (
            21_000 if opts.get("kind", "transfer") == "transfer"
            else 50_000  # staking directives: intrinsic + validation
        )
        gas_price = max(int(opts.get("gas_price", 0)), 1)
        return {
            "metadata": {
                "nonce": self.hmy.get_nonce(frm),
                "gas_price": gas_price,
                "gas_limit": gas_limit,
            },
            "suggested_fee": [{
                "value": str(gas_limit * gas_price),
                "currency": self._currency(),
            }],
        }

    # wire forms (rosetta-internal, like the reference's
    # WrappedTransaction envelope carrying IsStaking):
    #   unsigned_transaction = 0x || kind(1B) || sender(20B) || blob
    #   signed_transaction   = 0x || kind(1B) || blob
    # kind 0 = plain transfer, 1 = staking directive.  A sig-less tx
    # cannot name its sender, so the unsigned form carries it for
    # /construction/parse's intent round-trip.

    def _build_unsigned(self, ops: list, metadata: dict):
        from .core.types import Directive, StakingTransaction, Transaction

        intent = self._ops_to_intent(ops)
        kind, frm = intent[0], intent[1]
        shard = self.hmy.shard_id()
        if kind == "transfer":
            _, _, to, value = intent
            return 0, frm, Transaction(
                nonce=int(metadata["nonce"]),
                gas_price=int(metadata["gas_price"]),
                gas_limit=int(metadata["gas_limit"]),
                shard_id=shard, to_shard=shard,
                to=to, value=value,
            )
        directive, fields = {
            "delegate": (Directive.DELEGATE,
                         lambda v, a: {"validator": v, "amount": a}),
            "undelegate": (Directive.UNDELEGATE,
                           lambda v, a: {"validator": v, "amount": a}),
            "collect": (Directive.COLLECT_REWARDS, lambda v, a: {}),
        }[kind]
        return 1, frm, StakingTransaction(
            nonce=int(metadata["nonce"]),
            gas_price=int(metadata["gas_price"]),
            gas_limit=int(metadata["gas_limit"]),
            directive=directive,
            fields=fields(intent[2], intent[3]),
            shard_id=shard,
        )

    def _encode_kind(self, kind: int, tx) -> bytes:
        from .core import rawdb

        enc = (rawdb.encode_staking_tx if kind else rawdb.encode_tx)
        return bytes([kind]) + enc(tx, self.hmy.chain_id())

    def _decode_kind(self, raw: bytes):
        from .core import rawdb

        kind = raw[0]
        if kind not in (0, 1):
            raise ValueError("unknown transaction kind")
        dec = rawdb.decode_staking_tx if kind else rawdb.decode_tx
        return kind, dec(raw[1:])

    def _tx_ops(self, kind: int, tx, sender: bytes) -> list:
        """A decoded tx back to its Rosetta operations."""
        if kind == 0:
            return [
                {
                    "operation_identifier": {"index": 0},
                    "type": "NativeTransfer",
                    "account": {"address": "0x" + sender.hex()},
                    "amount": {"value": str(-tx.value),
                               "currency": self._currency()},
                },
                {
                    "operation_identifier": {"index": 1},
                    "related_operations": [{"index": 0}],
                    "type": "NativeTransfer",
                    "account": {"address": "0x" + (tx.to or b"").hex()},
                    "amount": {"value": str(tx.value),
                               "currency": self._currency()},
                },
            ]
        from .core.types import Directive

        typ = {
            Directive.DELEGATE: "Delegate",
            Directive.UNDELEGATE: "Undelegate",
            Directive.COLLECT_REWARDS: "CollectRewards",
        }.get(tx.directive, tx.directive.name)
        op = {
            "operation_identifier": {"index": 0},
            "type": typ,
            "account": {"address": "0x" + sender.hex()},
        }
        if "amount" in tx.fields:
            sign = "-" if tx.directive == Directive.DELEGATE else ""
            op["amount"] = {"value": f"{sign}{tx.fields['amount']}",
                            "currency": self._currency()}
        if "validator" in tx.fields:
            op["metadata"] = {
                "validatorAddress": "0x" + tx.fields["validator"].hex()
            }
        return [op]

    def _cons_payloads(self, req):
        kind, frm, tx = self._build_unsigned(
            req["operations"], req["metadata"]
        )
        ek = self._encode_kind(kind, tx)
        unsigned = "0x" + (ek[:1] + frm + ek[1:]).hex()
        return {
            "unsigned_transaction": unsigned,
            "payloads": [{
                "account_identifier": {"address": "0x" + frm.hex()},
                "hex_bytes": tx.signing_hash(self.hmy.chain_id()).hex(),
                "signature_type": "ecdsa_recovery",
            }],
        }

    def _cons_parse(self, req):
        raw = self._addr(req["transaction"])
        if req.get("signed"):
            kind, tx = self._decode_kind(raw)
            sender = tx.sender(self.hmy.chain_id())
            signers = [{"address": "0x" + sender.hex()}]
        else:
            sender = bytes(raw[1:21])
            kind, tx = self._decode_kind(raw[:1] + raw[21:])
            signers = []
        return {"operations": self._tx_ops(kind, tx, sender),
                "account_identifier_signers": signers}

    def _cons_combine(self, req):
        raw = self._addr(req["unsigned_transaction"])
        kind, tx = self._decode_kind(raw[:1] + raw[21:])  # drop sender
        sig = bytes.fromhex(req["signatures"][0]["hex_bytes"])
        if len(sig) != 65:
            raise ValueError("ecdsa_recovery signature must be 65 bytes")
        tx.sig = sig
        # reject garbage before it can reach /submit: recovery must
        # yield SOME address (full sender checks happen at the pool)
        tx.sender(self.hmy.chain_id())
        return {
            "signed_transaction": "0x" + self._encode_kind(kind, tx).hex()
        }

    def _cons_hash(self, req):
        _, tx = self._decode_kind(self._addr(req["signed_transaction"]))
        return {
            "transaction_identifier": {
                "hash": "0x" + tx.hash(self.hmy.chain_id()).hex()
            }
        }

    def _cons_submit(self, req):
        raw = self._addr(req["signed_transaction"])
        if raw[0] not in (0, 1):
            raise ValueError("unknown transaction kind")
        if raw[0] == 1:
            tx_hash = self.hmy.send_raw_staking_transaction(raw[1:])
        else:
            tx_hash = self.hmy.send_raw_transaction(raw[1:])
        return {
            "transaction_identifier": {"hash": "0x" + tx_hash.hex()}
        }
