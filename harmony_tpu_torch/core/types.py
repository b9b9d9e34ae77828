"""Chain value types: transactions, receipts, blocks.

The signable subset of the reference's core/types + staking/types
(reference: core/types tx model, staking/types/transaction.go,
core/types/cx_receipt.go — SURVEY.md §2.4).  Serialization is the
framework's canonical fixed-width layout (length-prefixed fields,
little-endian ints — the same documented deviation from RLP that
chain/header.py makes); hashes are keccak-256 of that layout.

Transactions are ECDSA-signed (crypto_ecdsa) with the sender recovered
from the signature — there is no "from" field on the wire, exactly as
in the reference's tx model.

The port's copy of the JAX package's ``core/types.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

from ..crypto_ecdsa import ECDSAKey, pub_to_address, recover
from ..ref.keccak import keccak256


def _enc_bytes(b: bytes) -> bytes:
    return len(b).to_bytes(4, "little") + b


def _enc_int(v: int, width: int = 8) -> bytes:
    return v.to_bytes(width, "little")


def _enc_big(v: int) -> bytes:
    """Variable-length big int (for balances beyond 2^64)."""
    b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "little")
    return _enc_bytes(b)


class Reader:
    """Cursor over the canonical length-prefixed little-endian layout
    (the single decode counterpart of the _enc_* helpers)."""

    def __init__(self, data: bytes):
        self.view = memoryview(data)
        self.off = 0

    def bytes_(self) -> bytes:
        ln = int.from_bytes(self.view[self.off:self.off + 4], "little")
        self.off += 4
        out = bytes(self.view[self.off:self.off + ln])
        self.off += ln
        return out

    def int_(self, width: int = 8) -> int:
        v = int.from_bytes(self.view[self.off:self.off + width], "little")
        self.off += width
        return v

    def big_(self) -> int:
        return int.from_bytes(self.bytes_(), "little")

    def raw(self, n: int) -> bytes:
        out = bytes(self.view[self.off:self.off + n])
        self.off += n
        return out

    def checked_count(self, width: int = 4) -> int:
        """A length-prefixed element count, REJECTED when it cannot
        fit in the remaining bytes (each element consumes >= 1 byte).
        The Reader slices silently past EOF, so a forged count in a
        wire/crash-fed blob would otherwise spin a garbage-object loop
        bounded only by the prefix width — hostile inputs must cost
        their own size, never 4 G iterations."""
        n = self.int_(width)
        if n > len(self.view) - self.off:
            raise ValueError(
                f"implausible element count {n} with "
                f"{len(self.view) - self.off} bytes left"
            )
        return n

    def eof(self) -> bool:
        return self.off >= len(self.view)


@dataclass
class Transaction:
    """A value-transfer / payload transaction, optionally cross-shard
    (to_shard != shard — the CXReceipt source, reference:
    core/state_processor.go cx handling)."""

    nonce: int
    gas_price: int
    gas_limit: int
    shard_id: int
    to_shard: int
    to: bytes | None  # 20-byte address; None = contract-creation style
    value: int
    data: bytes = b""
    sig: bytes = b""  # 65-byte [R||S||V]
    # EIP-2930 typed transaction (reference: core/types AccessListTx):
    # tx_type 0 = legacy (wire format unchanged), 1 = access-list tx
    # carrying [(address20, [slot32...])]; listed entries are pre-warmed
    # for EIP-2929 and paid for in intrinsic gas (2400/addr, 1900/slot)
    tx_type: int = 0
    access_list: list = field(default_factory=list)

    def signing_bytes(self, chain_id: int) -> bytes:
        out = bytearray()
        out += _enc_int(chain_id)
        out += _enc_int(self.nonce)
        out += _enc_big(self.gas_price)
        out += _enc_int(self.gas_limit)
        out += _enc_int(self.shard_id, 4) + _enc_int(self.to_shard, 4)
        out += _enc_bytes(self.to if self.to is not None else b"")
        out += _enc_big(self.value)
        out += _enc_bytes(self.data)
        if self.tx_type == 1:
            # typed envelope rides BEHIND the legacy fields so type-0
            # signing bytes (and hashes) are byte-stable
            out += _enc_int(1, 1)
            out += _enc_int(len(self.access_list), 2)
            for addr, slots in self.access_list:
                out += _enc_bytes(addr)
                out += _enc_int(len(slots), 2)
                for slot in slots:
                    out += _enc_bytes(slot)
        return bytes(out)

    def signing_hash(self, chain_id: int) -> bytes:
        return keccak256(self.signing_bytes(chain_id))

    def hash(self, chain_id: int = 0) -> bytes:
        return keccak256(self.signing_bytes(chain_id) + _enc_bytes(self.sig))

    def sign(self, key: ECDSAKey, chain_id: int) -> "Transaction":
        self.sig = key.sign(self.signing_hash(chain_id))
        return self

    def sender(self, chain_id: int) -> bytes:
        """Recover the 20-byte sender address (raises on a bad sig)."""
        return pub_to_address(recover(self.signing_hash(chain_id), self.sig))

    def is_cross_shard(self) -> bool:
        return self.to_shard != self.shard_id


class Directive(IntEnum):
    """Staking directive kinds (reference: staking/types/messages.go)."""

    CREATE_VALIDATOR = 0
    EDIT_VALIDATOR = 1
    DELEGATE = 2
    UNDELEGATE = 3
    COLLECT_REWARDS = 4


@dataclass
class StakingTransaction:
    """A staking-directive transaction (reference:
    staking/types/transaction.go): same envelope as Transaction, the
    payload is the directive + its fields."""

    nonce: int
    gas_price: int
    gas_limit: int
    directive: Directive
    fields: dict  # directive-specific; bytes/int/str values
    # the shard this directive executes on, BOUND INTO THE SIGNATURE:
    # without it one signed staking tx would replay on every shard at
    # the same nonce (the reference reaches the same safety by routing
    # all staking txs to shard 0 — staking/types/transaction.go)
    shard_id: int = 0
    sig: bytes = b""

    def _enc_fields(self) -> bytes:
        out = bytearray()
        for k in sorted(self.fields):
            v = self.fields[k]
            out += _enc_bytes(k.encode())
            if isinstance(v, bytes):
                out += b"\x00" + _enc_bytes(v)
            elif isinstance(v, int):
                out += b"\x01" + _enc_big(v)
            elif isinstance(v, str):
                out += b"\x02" + _enc_bytes(v.encode())
            else:
                raise TypeError(f"unsupported staking field type {type(v)}")
        return bytes(out)

    def signing_bytes(self, chain_id: int) -> bytes:
        return (
            _enc_int(chain_id)
            + _enc_int(self.nonce)
            + _enc_big(self.gas_price)
            + _enc_int(self.gas_limit)
            + _enc_int(self.shard_id, 4)
            + _enc_int(int(self.directive), 1)
            + self._enc_fields()
        )

    def signing_hash(self, chain_id: int) -> bytes:
        return keccak256(self.signing_bytes(chain_id))

    def hash(self, chain_id: int = 0) -> bytes:
        return keccak256(self.signing_bytes(chain_id) + _enc_bytes(self.sig))

    def sign(self, key: ECDSAKey, chain_id: int) -> "StakingTransaction":
        self.sig = key.sign(self.signing_hash(chain_id))
        return self

    def sender(self, chain_id: int) -> bytes:
        return pub_to_address(recover(self.signing_hash(chain_id), self.sig))


@dataclass
class Receipt:
    """Execution receipt (reference: core/types receipts)."""

    tx_hash: bytes
    status: int  # 1 ok, 0 failed
    gas_used: int
    cumulative_gas: int
    # EVM event logs: [(address20, [topic32...], data)] — consumed by
    # eth_getLogs / filters (reference: core/types/log.go)
    logs: list = field(default_factory=list)
    contract_address: bytes = b""  # set for successful deployments

    def encode(self) -> bytes:
        out = bytearray()
        out += _enc_bytes(self.tx_hash)
        out += _enc_int(self.status, 1)
        out += _enc_int(self.gas_used) + _enc_int(self.cumulative_gas)
        out += _enc_bytes(self.contract_address)
        out += _enc_int(len(self.logs), 4)
        for addr, topics, data in self.logs:
            out += _enc_bytes(addr)
            out += _enc_int(len(topics), 2)
            for t in topics:
                out += _enc_bytes(t)
            out += _enc_bytes(data)
        return bytes(out)

    @classmethod
    def decode(cls, r: "Reader") -> "Receipt":
        tx_hash = r.bytes_()
        status = r.int_(1)
        gas_used = r.int_()
        cumulative = r.int_()
        contract = r.bytes_()
        logs = []
        for _ in range(r.checked_count(4)):
            addr = r.bytes_()
            topics = [r.bytes_() for _ in range(r.checked_count(2))]
            logs.append((addr, topics, r.bytes_()))
        return cls(tx_hash, status, gas_used, cumulative,
                   logs=logs, contract_address=contract)


@dataclass
class CXReceipt:
    """A cross-shard transfer in flight: debited on the source shard,
    credited on the destination when the proof arrives (reference:
    core/types/cx_receipt.go, node/harmony/node_cross_shard.go)."""

    tx_hash: bytes
    sender: bytes
    to: bytes
    amount: int
    from_shard: int
    to_shard: int
    block_num: int = 0

    def encode(self) -> bytes:
        return (
            _enc_bytes(self.tx_hash)
            + _enc_bytes(self.sender)
            + _enc_bytes(self.to)
            + _enc_big(self.amount)
            + _enc_int(self.from_shard, 4)
            + _enc_int(self.to_shard, 4)
            + _enc_int(self.block_num)
        )

    def hash(self) -> bytes:
        return keccak256(self.encode())


def cx_group_root(cxs: list) -> bytes:
    """Commitment over one destination shard's receipt group: keccak of
    the concatenated receipt hashes (the framework's items_root shape;
    the reference uses DeriveSha — core/types/cx_receipt.go)."""
    out = bytearray()
    for cx in cxs:
        out += cx.hash()
    return keccak256(bytes(out)) if out else bytes(32)


def receipts_root(receipts: list) -> bytes:
    """Commitment over a block's execution receipts in persisted order
    (plain then staking): keccak of the concatenated receipt-encoding
    hashes — the framework's ReceiptSha analog (reference: block header
    ReceiptHash via core/types/receipt.go DeriveSha).  Fast sync
    verifies downloaded receipt lists against the sealed header's value
    before persisting them (unverified receipts let a sync
    peer forge statuses/logs served later by eth_getTransactionReceipt)."""
    out = bytearray()
    for r in receipts:
        out += keccak256(r.encode())
    return keccak256(bytes(out)) if out else bytes(32)


def group_cx_by_shard(cxs: list) -> dict:
    """Group outgoing receipts by destination shard — THE grouping that
    feeds the consensus-critical out_cx_root commitment (proposer,
    replay, and export must all use this one)."""
    by_shard: dict = {}
    for cx in cxs:
        by_shard.setdefault(cx.to_shard, []).append(cx)
    return by_shard


def out_cx_root(groups: dict) -> bytes:
    """The header's outgoing-receipt commitment: keccak over sorted
    (LE4(to_shard) || group_root) pairs of the NON-EMPTY groups
    (reference: block/header OutgoingReceiptHash built in
    core/blockchain_impl.go CXMerkleProof; empty -> zero hash)."""
    out = bytearray()
    for sid in sorted(groups):
        if not groups[sid]:
            continue
        out += sid.to_bytes(4, "little")
        out += cx_group_root(groups[sid])
    return keccak256(bytes(out)) if out else bytes(32)


@dataclass
class CXReceiptsProof:
    """A destination shard's authenticated receipt batch (reference:
    core/types/cx_receipt.go CXReceiptsProof + CXMerkleProof): the
    receipts, the source-shard header they executed in, that header's
    commit signature + bitmap (its seal), and the sibling group roots
    proving the receipts against the header's out_cx_root."""

    receipts: list  # CXReceipts, all with one to_shard
    header_bytes: bytes  # encoded source header (rawdb.encode_header)
    commit_sig: bytes  # 96-byte aggregate seal over the source header
    commit_bitmap: bytes
    shard_ids: list = field(default_factory=list)  # sorted dest shards
    shard_hashes: list = field(default_factory=list)  # group roots

    def encode(self) -> bytes:
        out = bytearray()
        out += _enc_int(len(self.receipts), 4)
        for cx in self.receipts:
            out += _enc_bytes(cx.encode())
        out += _enc_bytes(self.header_bytes)
        out += _enc_bytes(self.commit_sig)
        out += _enc_bytes(self.commit_bitmap)
        out += _enc_int(len(self.shard_ids), 4)
        for sid, h in zip(self.shard_ids, self.shard_hashes):
            out += _enc_int(sid, 4) + _enc_bytes(h)
        return bytes(out)

    def hash(self) -> bytes:
        return keccak256(self.encode())


@dataclass
class Block:
    """Header + body.  The header's ``root`` is the post-state root and
    its ``tx_root`` commits to the body: keccak over the EXECUTION-
    ordered tx hashes plus the incoming receipts — a sealed block's
    body cannot be swapped in transit.

    ``execution_order`` is the interleaving the proposer executed
    (0 = next plain tx, 1 = next staking tx); empty means all plain
    then all staking.  Replay must follow it so a sender mixing tx
    kinds keeps a consistent nonce sequence.
    """

    header: object  # chain.header.Header
    transactions: list = field(default_factory=list)
    staking_transactions: list = field(default_factory=list)
    incoming_receipts: list = field(default_factory=list)  # CXReceiptsProofs
    execution_order: list = field(default_factory=list)  # 0/1 flags

    def hash(self) -> bytes:
        return self.header.hash()

    @property
    def block_num(self) -> int:
        return self.header.block_num

    def ordered_txs(self):
        """(tx, is_staking) in execution order."""
        order = self.execution_order or (
            [0] * len(self.transactions)
            + [1] * len(self.staking_transactions)
        )
        if order.count(0) != len(self.transactions) or order.count(1) != len(
            self.staking_transactions
        ):
            raise ValueError("execution_order does not match body")
        its = [iter(self.transactions), iter(self.staking_transactions)]
        return [(next(its[flag]), bool(flag)) for flag in order]

    @staticmethod
    def items_root(hashes: list) -> bytes:
        out = bytearray()
        for h in hashes:
            out += h
        return keccak256(bytes(out)) if out else bytes(32)

    def tx_root(self, chain_id: int = 0) -> bytes:
        return self.items_root(
            [t.hash(chain_id) for t, _ in self.ordered_txs()]
            + [p.hash() for p in self.incoming_receipts]
        )
