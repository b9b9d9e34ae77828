"""rawdb: the key/value schema and block/state codecs.

The role of the reference's core/rawdb (LevelDB schema: canonical
hashes, headers, bodies, head pointers, and the per-block commit
sig+bitmap consumed at consensus/validator.go:367-377 — SURVEY.md
§2.4).  All keys are prefix-tagged; all values use the framework's
canonical little-endian layout.

The port's copy of the JAX package's ``core/rawdb.py``.
"""

from __future__ import annotations

from ..chain.header import Header
from .types import (
    Block,
    CXReceipt,
    Reader as _Reader,
    StakingTransaction,
    Transaction,
    _enc_big,
    _enc_bytes,
    _enc_int,
)

# key prefixes
_HEADER = b"h"          # h || num(8) -> header blob
_BODY = b"b"            # b || num(8) -> body blob
_CANON = b"n"           # n || num(8) -> 32-byte hash
_NUM_BY_HASH = b"H"     # H || hash -> num(8)
_COMMIT_SIG = b"s"      # s || num(8) -> [96B sig || bitmap]
_HEAD = b"LastBlock"    # -> num(8)
_STATE = b"S"           # S || root -> serialized StateDB
_RECEIPTS = b"r"        # r || num(8) -> encoded receipt list
_RECEIPT_IDX = b"R"     # R || tx_hash -> num(8) (lookup index)
_CX = b"x"              # x || to_shard(4) || num(8) -> outgoing cx blob
_CX_SPENT = b"X"        # X || from_shard(4) || num(8) -> spent marker
_LAST_SIGNED = b"V"     # V || bls_pubkey -> last-signed vote record
_VC_WATERMARK = b"W"    # W || bls_pubkey -> highest view-change signed


# -- codecs -----------------------------------------------------------------

def _checked_count(r: _Reader, width: int = 4) -> int:
    """Bounded count for the gossip-fed blobs (ANNOUNCE block bytes,
    CX proofs, sync pages, epoch states) — Reader.checked_count."""
    return r.checked_count(width)

_HEADER_FIELDS = (
    # (name, kind) in storage order — every dataclass field, version
    # included, so the store round-trips any header version losslessly
    ("version", "str"), ("shard_id", "int"), ("block_num", "int"),
    ("epoch", "int"), ("view_id", "int"), ("timestamp", "int"),
    ("parent_hash", "bytes"), ("root", "bytes"), ("tx_root", "bytes"),
    ("receipt_root", "bytes"),
    ("out_cx_root", "bytes"), ("last_commit_sig", "bytes"),
    ("last_commit_bitmap", "bytes"), ("extra", "bytes"),
    ("vrf", "bytes"), ("vdf", "bytes"), ("shard_state", "bytes"),
    ("cross_links", "bytes"), ("slashes", "bytes"),
)


def encode_header(h: Header) -> bytes:
    out = bytearray()
    for name, kind in _HEADER_FIELDS:
        v = getattr(h, name)
        if kind == "int":
            out += v.to_bytes(8, "little")
        elif kind == "str":
            out += _enc_bytes(v.encode())
        else:
            out += _enc_bytes(v)
    return bytes(out)


def decode_header(blob: bytes) -> Header:
    r = _Reader(blob)
    kw = {}
    for name, kind in _HEADER_FIELDS:
        if kind == "int":
            kw[name] = r.int_()
        elif kind == "str":
            kw[name] = r.bytes_().decode()
        else:
            kw[name] = r.bytes_()
    return Header(**kw)


def encode_tx(tx: Transaction, chain_id: int) -> bytes:
    return _enc_bytes(tx.signing_bytes(chain_id)) + _enc_bytes(tx.sig)


def decode_tx(blob: bytes) -> Transaction:
    r = _Reader(blob)
    f = _Reader(r.bytes_())
    f.int_()  # chain id (re-derived from config at use sites)
    nonce = f.int_()
    gas_price = f.big_()
    gas_limit = f.int_()
    shard_id = f.int_(4)
    to_shard = f.int_(4)
    to = f.bytes_()
    value = f.big_()
    data = f.bytes_()
    tx_type, access_list = 0, []
    if not f.eof():  # EIP-2930-shaped typed tail (types.py)
        tx_type = f.int_(1)
        if tx_type == 1:
            for _ in range(_checked_count(f, 2)):
                addr = f.bytes_()
                slots = [f.bytes_() for _ in range(_checked_count(f, 2))]
                access_list.append((addr, slots))
    return Transaction(
        nonce=nonce, gas_price=gas_price, gas_limit=gas_limit,
        shard_id=shard_id, to_shard=to_shard,
        to=(to if to else None), value=value, data=data, sig=r.bytes_(),
        tx_type=tx_type, access_list=access_list,
    )


def encode_staking_tx(tx: StakingTransaction, chain_id: int) -> bytes:
    return _enc_bytes(tx.signing_bytes(chain_id)) + _enc_bytes(tx.sig)


def decode_staking_tx(blob: bytes) -> StakingTransaction:
    from .types import Directive

    r = _Reader(blob)
    f = _Reader(r.bytes_())
    f.int_()  # chain id
    nonce = f.int_()
    gas_price = f.big_()
    gas_limit = f.int_()
    shard_id = f.int_(4)
    directive = Directive(f.int_(1))
    fields = {}
    while f.off < len(f.view):
        key = f.bytes_().decode()
        tag = f.int_(1)
        if tag == 0:
            fields[key] = f.bytes_()
        elif tag == 1:
            fields[key] = f.big_()
        else:
            fields[key] = f.bytes_().decode()
    return StakingTransaction(
        nonce=nonce, gas_price=gas_price, gas_limit=gas_limit,
        directive=directive, fields=fields, shard_id=shard_id,
        sig=r.bytes_(),
    )


def encode_cx(cx: CXReceipt) -> bytes:
    return cx.encode()


def encode_cx_proof(p) -> bytes:
    return p.encode()


def decode_cx_proof(blob: bytes):
    from .types import CXReceiptsProof

    r = _Reader(blob)
    receipts = [decode_cx(r.bytes_()) for _ in range(_checked_count(r))]
    header_bytes = r.bytes_()
    commit_sig = r.bytes_()
    commit_bitmap = r.bytes_()
    shard_ids, shard_hashes = [], []
    for _ in range(_checked_count(r)):
        shard_ids.append(r.int_(4))
        shard_hashes.append(r.bytes_())
    return CXReceiptsProof(
        receipts=receipts, header_bytes=header_bytes,
        commit_sig=commit_sig, commit_bitmap=commit_bitmap,
        shard_ids=shard_ids, shard_hashes=shard_hashes,
    )


def decode_cx(blob: bytes) -> CXReceipt:
    r = _Reader(blob)
    return CXReceipt(
        tx_hash=r.bytes_(), sender=r.bytes_(), to=r.bytes_(),
        amount=r.big_(), from_shard=r.int_(4), to_shard=r.int_(4),
        block_num=r.int_(),
    )


def encode_body(block: Block, chain_id: int) -> bytes:
    out = bytearray()
    out += _enc_int(len(block.transactions), 4)
    for tx in block.transactions:
        out += _enc_bytes(encode_tx(tx, chain_id))
    out += _enc_int(len(block.staking_transactions), 4)
    for stx in block.staking_transactions:
        out += _enc_bytes(encode_staking_tx(stx, chain_id))
    out += _enc_int(len(block.incoming_receipts), 4)
    for p in block.incoming_receipts:
        out += _enc_bytes(encode_cx_proof(p))
    out += _enc_int(len(block.execution_order), 4)
    out += bytes(block.execution_order)
    return bytes(out)


def decode_body(blob: bytes):
    r = _Reader(blob)
    txs = [decode_tx(r.bytes_()) for _ in range(_checked_count(r))]
    stxs = [decode_staking_tx(r.bytes_())
            for _ in range(_checked_count(r))]
    cxps = [decode_cx_proof(r.bytes_()) for _ in range(_checked_count(r))]
    order = list(r.raw(_checked_count(r)))
    return txs, stxs, cxps, order


# -- schema accessors -------------------------------------------------------

def _num_key(prefix: bytes, num: int) -> bytes:
    return prefix + num.to_bytes(8, "little")


def write_block(db, block: Block, chain_id: int):
    num = block.block_num
    db.put(_num_key(_HEADER, num), encode_header(block.header))
    db.put(_num_key(_BODY, num), encode_body(block, chain_id))
    db.put(_num_key(_CANON, num), block.hash())
    db.put(_NUM_BY_HASH + block.hash(), num.to_bytes(8, "little"))


def read_block(db, num: int) -> Block | None:
    hdr_blob = db.get(_num_key(_HEADER, num))
    if hdr_blob is None:
        return None
    header = decode_header(hdr_blob)
    body = db.get(_num_key(_BODY, num))
    txs, stxs, cxs, order = (
        decode_body(body) if body else ([], [], [], [])
    )
    return Block(header, txs, stxs, cxs, order)


def read_header(db, num: int) -> Header | None:
    blob = db.get(_num_key(_HEADER, num))
    return decode_header(blob) if blob else None


def read_canonical_hash(db, num: int) -> bytes | None:
    return db.get(_num_key(_CANON, num))


def delete_canonical(db, num: int, w=None):
    """Drop block ``num`` from the canonical chain (revert tooling);
    the hash->number index entry goes with it.  ``w`` is the write
    target (a WriteBatch staging an atomic revert); reads always come
    from ``db``."""
    w = db if w is None else w
    h = db.get(_num_key(_CANON, num))
    if h is not None:
        w.delete(_NUM_BY_HASH + h)
    w.delete(_num_key(_CANON, num))
    w.delete(_num_key(_HEADER, num))
    w.delete(_num_key(_BODY, num))
    w.delete(_num_key(_COMMIT_SIG, num))
    w.delete(_RECEIPTS + _enc_int(num))


def read_block_number(db, block_hash: bytes) -> int | None:
    blob = db.get(_NUM_BY_HASH + block_hash)
    return int.from_bytes(blob, "little") if blob else None


def write_commit_sig(db, num: int, sig_and_bitmap: bytes):
    """reference: BlockChain.WriteCommitSig (consensus/validator.go:
    367-377 reads it back for the last-mile path)."""
    db.put(_num_key(_COMMIT_SIG, num), sig_and_bitmap)


def read_commit_sig(db, num: int) -> bytes | None:
    return db.get(_num_key(_COMMIT_SIG, num))


def write_head_number(db, num: int):
    db.put(_HEAD, num.to_bytes(8, "little"))


def read_head_number(db) -> int | None:
    blob = db.get(_HEAD)
    return int.from_bytes(blob, "little") if blob else None


def write_state(db, root: bytes, state_blob: bytes):
    db.put(_STATE + root, state_blob)


def read_state(db, root: bytes) -> bytes | None:
    return db.get(_STATE + root)


def delete_state(db, root: bytes) -> None:
    """Drop a historical state blob (core/snapshot.py pruning)."""
    db.delete(_STATE + root)


def write_receipts(db, num: int, receipts: list):
    from .types import Receipt  # noqa: F401 — encoded via Receipt.encode

    out = bytearray(_enc_int(len(receipts), 4))
    for rc in receipts:
        out += rc.encode()
        db.put(_RECEIPT_IDX + rc.tx_hash, _enc_int(num))
    db.put(_RECEIPTS + _enc_int(num), bytes(out))


def read_receipt_block_num(db, tx_hash: bytes) -> int | None:
    blob = db.get(_RECEIPT_IDX + tx_hash)
    return int.from_bytes(blob, "little") if blob is not None else None


def read_receipts(db, num: int) -> list:
    from .types import Receipt

    blob = db.get(_RECEIPTS + _enc_int(num))
    if blob is None:
        return []
    r = _Reader(blob)
    return [Receipt.decode(r) for _ in range(_checked_count(r))]


def write_outgoing_cx(db, to_shard: int, num: int, cxs: list):
    out = bytearray(_enc_int(len(cxs), 4))
    for cx in cxs:
        out += _enc_bytes(encode_cx(cx))
    db.put(_CX + to_shard.to_bytes(4, "little") + num.to_bytes(8, "little"),
           bytes(out))


def read_outgoing_cx(db, to_shard: int, num: int) -> list:
    blob = db.get(
        _CX + to_shard.to_bytes(4, "little") + num.to_bytes(8, "little")
    )
    if blob is None:
        return []
    r = _Reader(blob)
    return [decode_cx(r.bytes_()) for _ in range(_checked_count(r))]


def write_cx_spent(db, from_shard: int, num: int, spender: int = 0):
    """Mark a source block's receipt batch consumed on this shard
    (reference: WriteCXReceiptsProofSpent — replaying the same proof in
    a later block must fail as a double spend).  ``spender`` records
    WHICH local block consumed it, so re-inserting that exact block
    (a replay sync over a fast-synced range) stays idempotent."""
    db.put(_CX_SPENT + from_shard.to_bytes(4, "little")
           + num.to_bytes(8, "little"), spender.to_bytes(8, "little"))


def delete_cx_spent(db, from_shard: int, num: int):
    """Un-mark a receipt batch (revert tooling: a reverted block's
    proofs must be acceptable again when the block re-syncs)."""
    db.delete(
        _CX_SPENT + from_shard.to_bytes(4, "little")
        + num.to_bytes(8, "little")
    )


def is_cx_spent(db, from_shard: int, num: int) -> bool:
    return db.get(
        _CX_SPENT + from_shard.to_bytes(4, "little")
        + num.to_bytes(8, "little")
    ) is not None


def cx_spender(db, from_shard: int, num: int) -> int | None:
    """The local block that consumed the batch, or None if unspent
    (legacy b'\\x01' marks read as spender 1 — the localnet DBs that
    predate the field only ever consumed at block 1... treat any
    short value as 'unknown spender', which fails closed)."""
    blob = db.get(
        _CX_SPENT + from_shard.to_bytes(4, "little")
        + num.to_bytes(8, "little")
    )
    if blob is None:
        return None
    if len(blob) != 8:
        return -1  # unknown: never matches a real block num
    return int.from_bytes(blob, "little")


def encode_block(block: Block, chain_id: int) -> bytes:
    """Standalone block blob (gossip ANNOUNCE carries this)."""
    return (
        _enc_bytes(encode_header(block.header))
        + _enc_bytes(encode_body(block, chain_id))
    )


def decode_block(blob: bytes) -> Block:
    r = _Reader(blob)
    header = decode_header(r.bytes_())
    txs, stxs, cxs, order = decode_body(r.bytes_())
    return Block(header, txs, stxs, cxs, order)


# -- shard state (per-epoch committees) -------------------------------------

_SHARD_STATE = b"E"  # E || epoch(8) -> shard state blob


def encode_shard_state(state) -> bytes:
    """shard.committee.State codec (effective stakes carried as raw
    Dec ints; None marks Harmony-operated slots)."""
    out = bytearray()
    out += _enc_int(state.epoch)
    out += _enc_int(len(state.shards), 4)
    for com in state.shards:
        out += _enc_int(com.shard_id, 4)
        out += _enc_int(len(com.slots), 4)
        for s in com.slots:
            out += _enc_bytes(s.ecdsa_address)
            out += _enc_bytes(s.bls_pubkey)
            if s.effective_stake is None:
                out += b"\x00"
            else:
                out += b"\x01" + _enc_big(s.effective_stake.raw)
    return bytes(out)


def decode_shard_state(blob: bytes):
    from ..numeric import Dec
    from ..shard.committee import Committee, Slot, State

    r = _Reader(blob)
    state = State(epoch=r.int_())
    for _ in range(_checked_count(r)):
        com = Committee(shard_id=r.int_(4))
        for _ in range(_checked_count(r)):
            addr = r.bytes_()
            key = r.bytes_()
            has_stake = r.int_(1)
            stake = None
            if has_stake:
                stake = Dec(r.big_())
            com.slots.append(Slot(addr, key, stake))
        state.shards.append(com)
    return state


def write_shard_state(db, epoch: int, state):
    db.put(_num_key(_SHARD_STATE, epoch), encode_shard_state(state))


def read_shard_state(db, epoch: int):
    blob = db.get(_num_key(_SHARD_STATE, epoch))
    return decode_shard_state(blob) if blob else None


# -- durable consensus safety state -----------------------------------------
#
# The last vote each local BLS key signed, written BEFORE the vote
# leaves the node (consensus/safety.py): a restarted validator reloads
# it and can neither double-sign the same (height, view) with a
# different hash nor re-enter a view it already signed past.  The
# reference stores the equivalent in consensus' FBFT log; we keep it in
# the shard DB so kill -9 + reopen recovers it with the chain.

def write_last_signed(db, pubkey: bytes, block_num: int, view_id: int,
                      phase: int, block_hash: bytes):
    db.put(
        _LAST_SIGNED + pubkey,
        block_num.to_bytes(8, "little") + view_id.to_bytes(8, "little")
        + phase.to_bytes(1, "little") + block_hash,
    )


def read_last_signed(db, pubkey: bytes):
    """-> (block_num, view_id, phase, block_hash) or None."""
    blob = db.get(_LAST_SIGNED + pubkey)
    if blob is None or len(blob) < 17:
        return None
    return (
        int.from_bytes(blob[0:8], "little"),
        int.from_bytes(blob[8:16], "little"),
        blob[16],
        blob[17:],
    )


def write_vc_watermark(db, pubkey: bytes, block_num: int, view_id: int):
    """Highest view this key has signed a VIEWCHANGE for (kept apart
    from the vote record: a VC signature must never overwrite the
    memory of WHAT was voted at a view)."""
    db.put(
        _VC_WATERMARK + pubkey,
        block_num.to_bytes(8, "little") + view_id.to_bytes(8, "little"),
    )


def read_vc_watermark(db, pubkey: bytes):
    """-> (block_num, view_id) or None."""
    blob = db.get(_VC_WATERMARK + pubkey)
    if blob is None or len(blob) < 16:
        return None
    return (
        int.from_bytes(blob[0:8], "little"),
        int.from_bytes(blob[8:16], "little"),
    )
