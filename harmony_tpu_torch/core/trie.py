"""Hexary Merkle-Patricia trie (reference: the go-ethereum trie package
under core/state — SURVEY.md §2.4; node encoding per the Ethereum
yellow paper appendix D).

Purpose here: REFERENCE-SHAPED state commitments.  The execution layer
keeps the flat account map (O(1) access, trivially parallel root); this
trie turns the same data into an Ethereum-style root (and can serve
inclusion proofs).  Nodes are RLP; references are keccak256(rlp) when
the encoding is >= 32 bytes, else the encoding inlined — exactly the
yellow-paper rule, so roots match any correct MPT over the same
key/value set.

Built in memory, with an optional node sink (``store``) for persistence.

The port's copy of the JAX package's ``core/trie.py``.
"""

from __future__ import annotations

from ..ref.keccak import keccak256
from .. import rlp

EMPTY_ROOT = keccak256(rlp.encode(b""))  # the canonical empty-trie root


def _to_nibbles(key: bytes) -> list:
    out = []
    for b in key:
        out.append(b >> 4)
        out.append(b & 0x0F)
    return out


def _hp_encode(nibbles: list, leaf: bool) -> bytes:
    """Hex-prefix encoding (yellow paper appendix C)."""
    flag = 2 if leaf else 0
    if len(nibbles) % 2:
        head = [(flag + 1) << 4 | nibbles[0]]
        rest = nibbles[1:]
    else:
        head = [flag << 4]
        rest = nibbles
    out = bytearray(head)
    for i in range(0, len(rest), 2):
        out.append(rest[i] << 4 | rest[i + 1])
    return bytes(out)


def _common_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class Trie:
    """Build from scratch each commit (the state layer hands it the
    full live account set; incremental update is a planned upgrade).

    ``store``: optional callable (hash, encoded_node) for persisting
    nodes (inclusion-proof serving / cold-start from a root).
    """

    def __init__(self, store=None):
        self._items: dict[bytes, bytes] = {}
        self._store = store

    def update(self, key: bytes, value: bytes):
        if value:
            self._items[key] = value
        else:
            self._items.pop(key, None)

    def root(self) -> bytes:
        if not self._items:
            return EMPTY_ROOT
        pairs = sorted(
            (_to_nibbles(k), v) for k, v in self._items.items()
        )
        node = self._build(pairs, 0)
        enc = rlp.encode(node)
        return keccak256(self._emit(enc))

    def _emit(self, enc: bytes) -> bytes:
        if self._store is not None:
            self._store(keccak256(enc), enc)
        return enc

    def _ref(self, node):
        """Yellow-paper node reference: inline if < 32 bytes."""
        enc = rlp.encode(node)
        if len(enc) < 32:
            return node
        self._emit(enc)
        return keccak256(enc)

    def _build(self, pairs: list, depth: int):
        """pairs: sorted (nibble_list, value), all sharing a prefix of
        length ``depth``; returns the structural node (not yet RLP)."""
        if len(pairs) == 1:
            nibs, value = pairs[0]
            return [_hp_encode(nibs[depth:], True), value]
        # longest common prefix below depth
        first = pairs[0][0]
        last = pairs[-1][0]
        common = _common_prefix(first[depth:], last[depth:])
        if common > 0:
            child = self._build(pairs, depth + common)
            return [
                _hp_encode(first[depth:depth + common], False),
                self._ref(child),
            ]
        # branch on nibble at depth
        children = [b""] * 16
        value = b""
        i = 0
        while i < len(pairs):
            nibs, val = pairs[i]
            if len(nibs) == depth:
                value = val  # key terminates exactly here
                i += 1
                continue
            nib = nibs[depth]
            j = i
            while j < len(pairs) and len(pairs[j][0]) > depth and (
                pairs[j][0][depth] == nib
            ):
                j += 1
            children[nib] = self._ref(self._build(pairs[i:j], depth + 1))
            i = j
        return children + [value]


def _hp_decode(data: bytes):
    """Inverse of _hp_encode -> (nibbles, is_leaf)."""
    flag = data[0] >> 4
    nibs = []
    if flag & 1:
        nibs.append(data[0] & 0x0F)
    for b in data[1:]:
        nibs.append(b >> 4)
        nibs.append(b & 0x0F)
    return nibs, bool(flag & 2)


def build_proof_db(items: dict):
    """(root, {hash: encoded node}) for a key/value set — build the
    trie ONCE, then prove_from() walks it per key (an eth_getProof
    request proves several keys against the same trie)."""
    nodes: dict[bytes, bytes] = {}
    t = Trie(store=lambda h, enc: nodes.__setitem__(h, enc))
    for k, v in items.items():
        t.update(k, v)
    return t.root(), nodes


def prove(items: dict, key: bytes) -> list:
    """One-shot convenience over build_proof_db + prove_from."""
    root, nodes = build_proof_db(items)
    return prove_from(root, nodes, key)


def prove_from(root: bytes, nodes: dict, key: bytes) -> list:
    """Merkle inclusion/exclusion proof: the RLP encodings of every
    HASHED node on ``key``'s path, root first (go-ethereum
    Trie.Prove's format — what eth_getProof carries).  Inline (<32 B)
    nodes ride inside their parents, per the yellow-paper reference
    rule, so the list is exactly the resolvable path."""
    if root == EMPTY_ROOT:
        return []
    proof = [nodes[root]]
    node = rlp.decode(nodes[root])
    nibs = _to_nibbles(key)
    while True:
        if len(node) == 2:
            prefix, is_leaf = _hp_decode(node[0])
            if is_leaf or prefix != nibs[:len(prefix)]:
                return proof  # arrived (or proved absent)
            nibs = nibs[len(prefix):]
            ref = node[1]
        elif len(node) == 17:
            if not nibs:
                return proof  # value sits in this branch
            ref, nibs = node[nibs[0]], nibs[1:]
        else:
            raise ValueError("malformed trie node")
        if isinstance(ref, list):
            node = ref  # inline child: part of the parent's encoding
        elif len(ref) == 32 and ref in nodes:
            proof.append(nodes[ref])
            node = rlp.decode(nodes[ref])
        else:
            return proof  # absent key diverged


def verify_proof(root: bytes, key: bytes, proof: list):
    """Walk a Trie.prove-style proof; returns the value at ``key`` (b""
    for a proven absence) or raises ValueError on a broken proof."""
    if not proof:
        if root == EMPTY_ROOT:
            return b""
        raise ValueError("empty proof for non-empty root")
    by_hash = {keccak256(enc): enc for enc in proof}
    if root not in by_hash:
        raise ValueError("proof does not start at the root")
    node = rlp.decode(by_hash[root])
    nibs = _to_nibbles(key)
    while True:
        if len(node) == 2:
            prefix, is_leaf = _hp_decode(node[0])
            if prefix != nibs[:len(prefix)]:
                return b""  # path diverges: proven absent
            nibs = nibs[len(prefix):]
            if is_leaf:
                if nibs:
                    return b""
                return node[1]
            ref = node[1]
        elif len(node) == 17:
            if not nibs:
                return node[16]
            ref, nibs = node[nibs[0]], nibs[1:]
        else:
            raise ValueError("malformed trie node")
        if isinstance(ref, list):
            node = ref
        elif ref == b"":
            return b""  # no child on the path: proven absent
        elif len(ref) == 32:
            enc = by_hash.get(ref)
            if enc is None:
                raise ValueError("proof is missing a path node")
            node = rlp.decode(enc)
        else:
            raise ValueError("malformed node reference")


def trie_root(items: dict) -> bytes:
    """Root of a key->value map (empty values are absent keys)."""
    t = Trie()
    for k, v in items.items():
        t.update(k, v)
    return t.root()


def secure_trie_root(items: dict) -> bytes:
    """go-ethereum SecureTrie: keys are keccak256-hashed first (the
    state trie's account addressing)."""
    return trie_root({keccak256(k): v for k, v in items.items()})
