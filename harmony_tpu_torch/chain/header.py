"""Block headers: the signable chain objects, versioned v0-v3.

Behavioral parity with the reference's header model (reference:
block/header.go:161-173 HeaderRegistry + block/v0..v3/header.go): one
``Header`` facade over per-version field sets, hashed as
keccak-256 OF THE RLP ENCODING (reference: crypto/hash/rlp.go FromRLP)
wrapped in a taggedrlp-style envelope — the legacy version (v0)
encodes bare for back-compat, later versions carry their tag
(reference: harmony-one/taggedrlp via block/header.go:100-117).

Version field sets (each mirrors the reference version's field ORDER,
restricted to the consensus fields this framework models):

* v0 (LegacyTag): parent, root, tx_root, number, time, extra, view,
  epoch, shard, last commit sig+bitmap, shard_state
  (block/v0/header.go:45-64)
* v1: + out_cx_root, vrf, vdf (block/v1/header.go)
* v2: + cross_links (block/v2/header.go)
* v3: + slashes (block/v3/header.go:48-74)

NOTE headers INCLUDE the carried parent commit proof in their hash
(the reference's LastCommitSignature/Bitmap are ordinary header
fields): the proposal fixes them before ANNOUNCE, so the signed hash
commits to the parent's quorum proof.

Every header also carries its parent's aggregate commit signature +
bitmap (``last_commit_sig``), so verifying header N's seal checks the
committee's signature carried in header N+1 (reference:
internal/chain/engine.go:237-262 VerifySeal,
api/service/stagedstreamsync/sig_verify.go:37-48).
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import rlp
from ..ref.keccak import keccak256

VERSIONS = ("v0", "v1", "v2", "v3")
_TAG_PREFIX = b"HmnyTgd"  # taggedrlp-style envelope marker


@dataclass
class Header:
    shard_id: int
    block_num: int = 0
    epoch: int = 0
    view_id: int = 0
    parent_hash: bytes = bytes(32)
    root: bytes = bytes(32)  # state root
    tx_root: bytes = bytes(32)  # body commitment (ordered tx hashes)
    # execution receipts commitment (reference: header ReceiptHash) —
    # what the fast-sync receipts stage verifies downloads against
    receipt_root: bytes = bytes(32)
    # outgoing cross-shard receipt commitment: keccak over the sorted
    # (destination shard, group root) pairs (reference:
    # block/header OutgoingReceiptHash, core/types/cx_receipt.go
    # CXMerkleProof) — what destination shards verify CX proofs against
    out_cx_root: bytes = bytes(32)
    timestamp: int = 0
    # parent's quorum proof: [96B agg sig || bitmap]
    last_commit_sig: bytes = b""
    last_commit_bitmap: bytes = b""
    extra: bytes = b""
    # epoch-boundary payloads (reference v1+/v3 extras)
    vrf: bytes = b""
    vdf: bytes = b""
    shard_state: bytes = b""
    cross_links: bytes = b""
    slashes: bytes = b""
    version: str = "v3"

    def _field_list(self) -> list:
        """RLP item list for this header's version (reference field
        order, ints as minimal big-endian per the canonical codec)."""
        if self.version not in VERSIONS:
            raise ValueError(f"unknown header version {self.version!r}")
        items = [
            self.parent_hash,
            self.root,
            self.tx_root,
            self.receipt_root,
        ]
        if self.version != "v0":
            items.append(self.out_cx_root)
        items += [
            rlp.int_to_bytes(self.block_num),
            rlp.int_to_bytes(self.timestamp),
            self.extra,
            rlp.int_to_bytes(self.view_id),
            rlp.int_to_bytes(self.epoch),
            rlp.int_to_bytes(self.shard_id),
            self.last_commit_sig,
            self.last_commit_bitmap,
            self.shard_state,
        ]
        if self.version != "v0":
            items += [self.vrf, self.vdf]
        if self.version in ("v2", "v3"):
            items.append(self.cross_links)
        if self.version == "v3":
            items.append(self.slashes)
        return items

    def signing_fields(self) -> bytes:
        """The tagged RLP encoding whose keccak is the block hash.

        v0 encodes as a bare field list (taggedrlp LegacyTag); v1+ wrap
        in [marker, tag, fields] (taggedrlp envelope shape)."""
        fields = self._field_list()
        if self.version == "v0":
            return rlp.encode(fields)
        return rlp.encode([_TAG_PREFIX, self.version.encode(), fields])

    def hash(self) -> bytes:
        return keccak256(self.signing_fields())
