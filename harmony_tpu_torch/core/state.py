"""Account-model state DB with a deterministic root.

The role of the reference's core/state (go-ethereum-style StateDB with
an MPT + snapshot tree, plus ValidatorWrapper storage — SURVEY.md
§2.4), redesigned: a flat account map with copy-on-write block copies
and a root that is SHA3-256 over the sorted canonical serialization of
all accounts.  The flat layout trades MPT inclusion proofs (not
consumed anywhere in the reference's consensus path) for O(1) access
and a root that is linear in the number of TOUCHED accounts:

* ``copy()`` is a shallow map copy; an account is cloned only when a
  mutating accessor reaches for it (copy-on-write), so a block that
  touches k accounts costs O(k), not O(N) — the difference between a
  64-account devnet and a 10^5-account rehearsal genesis.
* Every account caches its encoded (address || blob) fragment; the
  root/serialize paths reuse untouched fragments, so sealing a block
  re-encodes only what the block changed.
* The flat root hashes with ``hashlib.sha3_256`` (native): the
  pure-python keccak-256 kept for reference header vectors costs
  ~7 ms/KB, which turns an O(state-bytes) root into minutes at 10^5
  accounts.  The flat root is an internal commitment with no reference
  vector to match (the reference's committed root is the MPT root,
  which keeps real keccak in ``mpt_root()``).

ValidatorWrapper (reference: staking ValidatorWrapper in state) is a
first-class part of the account record here: description, delegations
(ordered), and signing counters serialize into the root so staking
state is consensus-committed exactly as in the reference.

The port's copy of the JAX package's ``core/state.py``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from .. import prof
from .types import Reader, _enc_big, _enc_bytes, _enc_int


@dataclass
class Delegation:
    delegator: bytes  # 20-byte address
    amount: int
    undelegations: list = field(default_factory=list)  # (amount, epoch)
    reward: int = 0

    def encode(self) -> bytes:
        out = bytearray()
        out += _enc_bytes(self.delegator) + _enc_big(self.amount)
        out += _enc_big(self.reward)
        out += _enc_int(len(self.undelegations), 4)
        for amount, epoch in self.undelegations:
            out += _enc_big(amount) + _enc_int(epoch)
        return bytes(out)


@dataclass
class ValidatorWrapper:
    """On-chain validator record (reference: staking/types validator +
    wrapper: keys, commission, delegations, signing counters)."""

    address: bytes
    bls_keys: list = field(default_factory=list)  # 48-byte serialized
    commission_rate: int = 0  # scaled 1e18
    max_commission_rate: int = 10**18
    max_change_rate: int = 10**18
    min_self_delegation: int = 0
    max_total_delegation: int = 0
    delegations: list = field(default_factory=list)  # [Delegation]
    blocks_signed: int = 0
    blocks_to_sign: int = 0
    status: int = 0  # 0 active, 1 inactive, 2 banned
    last_epoch_in_committee: int = 0

    def total_delegation(self) -> int:
        return sum(d.amount for d in self.delegations)

    def self_delegation(self) -> int:
        for d in self.delegations:
            if d.delegator == self.address:
                return d.amount
        return 0

    def encode(self) -> bytes:
        out = bytearray()
        out += _enc_bytes(self.address)
        out += _enc_int(len(self.bls_keys), 4)
        for k in self.bls_keys:
            out += _enc_bytes(k)
        for v in (self.commission_rate, self.max_commission_rate,
                  self.max_change_rate, self.min_self_delegation,
                  self.max_total_delegation):
            out += _enc_big(v)
        out += _enc_int(len(self.delegations), 4)
        for d in self.delegations:
            out += d.encode()
        out += _enc_int(self.blocks_signed) + _enc_int(self.blocks_to_sign)
        out += _enc_int(self.status, 1)
        out += _enc_int(self.last_epoch_in_committee)
        return bytes(out)


@dataclass
class Account:
    balance: int = 0
    nonce: int = 0
    validator: ValidatorWrapper | None = None
    code: bytes = b""  # EVM bytecode (contract accounts)
    storage: dict = field(default_factory=dict)  # 32B slot -> int
    # cached (address, encoded-fragment) pair — owned by the StateDB
    # machinery below; cleared whenever a mutable accessor hands the
    # account out.  The address rides along so a fragment can never be
    # replayed under a different key.
    _frag: tuple | None = field(default=None, repr=False, compare=False)

    def encode(self) -> bytes:
        out = _enc_big(self.balance) + _enc_int(self.nonce)
        if self.validator is not None:
            out += b"\x01" + self.validator.encode()
        else:
            out += b"\x00"
        if self.code or self.storage:
            out += b"\x01" + _enc_bytes(self.code)
            live = sorted(
                (k, v) for k, v in self.storage.items() if v
            )
            out += _enc_int(len(live), 4)
            for k, v in live:
                out += _enc_bytes(k) + _enc_big(v)
        else:
            out += b"\x00"
        return out


def _clone_wrapper(v: ValidatorWrapper) -> ValidatorWrapper:
    return ValidatorWrapper(
        v.address, list(v.bls_keys), v.commission_rate,
        v.max_commission_rate, v.max_change_rate,
        v.min_self_delegation, v.max_total_delegation,
        [Delegation(d.delegator, d.amount, list(d.undelegations),
                    d.reward)
         for d in v.delegations],
        v.blocks_signed, v.blocks_to_sign, v.status,
        v.last_epoch_in_committee,
    )


def _clone_account(acct: Account) -> Account:
    v = acct.validator
    return Account(
        acct.balance, acct.nonce,
        _clone_wrapper(v) if v is not None else None,
        acct.code, dict(acct.storage),
    )


class StateDB:
    """Mutable state with snapshot/revert and a deterministic root."""

    def __init__(self, accounts: dict | None = None):
        self._accounts: dict[bytes, Account] = (
            accounts if accounts is not None else {}
        )
        # copy-on-write bookkeeping: an address is in _owned iff its
        # Account object is referenced by THIS StateDB alone and may be
        # mutated in place.  A constructor-passed map is owned outright
        # (this is its sole StateDB); copy() disowns BOTH sides.
        self._owned: set = set(self._accounts)
        self._sorted: list | None = None  # cached sorted address list
        # EVM frame journaling (go-ethereum StateDB journal shape):
        # None = off (zero overhead for non-EVM users); a list = every
        # mutation appends an undo record, revert_to() rolls back.
        self._jrnl: list | None = None

    # -- access ------------------------------------------------------------

    def _own(self, addr: bytes) -> Account:
        """Get-or-create ``addr``'s account as a MUTABLE object: clones
        a shared account before handing it out (copy-on-write) and
        drops its cached fragment, since the caller may mutate it in
        place (finalize's reward credit and the slashing paths do)."""
        acct = self._accounts.get(addr)
        if acct is None:
            acct = Account()
            self._accounts[addr] = acct
            self._owned.add(addr)
            self._sorted = None
            if self._jrnl is not None:
                self._jrnl.append(("new", addr))
        elif addr not in self._owned:
            acct = _clone_account(acct)
            self._accounts[addr] = acct
            self._owned.add(addr)
        acct._frag = None
        return acct

    def account(self, addr: bytes) -> Account:
        return self._own(addr)

    def balance(self, addr: bytes) -> int:
        a = self._accounts.get(addr)
        return a.balance if a else 0

    def nonce(self, addr: bytes) -> int:
        a = self._accounts.get(addr)
        return a.nonce if a else 0

    def add_balance(self, addr: bytes, amount: int):
        acct = self._own(addr)
        if self._jrnl is not None:
            self._jrnl.append(("bal", addr, acct.balance))
        acct.balance += amount

    def sub_balance(self, addr: bytes, amount: int):
        acct = self._own(addr)
        if acct.balance < amount:
            raise ValueError("insufficient balance")
        if self._jrnl is not None:
            self._jrnl.append(("bal", addr, acct.balance))
        acct.balance -= amount

    def set_nonce(self, addr: bytes, nonce: int):
        acct = self._own(addr)
        if self._jrnl is not None:
            self._jrnl.append(("nonce", addr, acct.nonce))
        acct.nonce = nonce

    def validator(self, addr: bytes) -> ValidatorWrapper | None:
        a = self._accounts.get(addr)
        if a is None or a.validator is None:
            return None
        # callers mutate the wrapper in place (signing counters, status,
        # delegation rewards) — hand out an owned clone, never a shared
        # object another StateDB still roots over
        return self._own(addr).validator

    # -- EVM surface (code + storage) --------------------------------------

    def code(self, addr: bytes) -> bytes:
        a = self._accounts.get(addr)
        return a.code if a else b""

    def set_code(self, addr: bytes, code: bytes):
        acct = self._own(addr)
        if self._jrnl is not None:
            self._jrnl.append(("code", addr, acct.code))
        acct.code = code

    def storage_get(self, addr: bytes, slot: bytes) -> int:
        a = self._accounts.get(addr)
        return a.storage.get(slot, 0) if a else 0

    def storage_set(self, addr: bytes, slot: bytes, value: int):
        acct = self._own(addr)
        if self._jrnl is not None:
            self._jrnl.append(("slot", addr, slot, acct.storage.get(slot, 0)))
        if value:
            acct.storage[slot] = value
        else:
            acct.storage.pop(slot, None)

    def set_validator(self, wrapper: ValidatorWrapper):
        acct = self._own(wrapper.address)
        if self._jrnl is not None:
            self._jrnl.append(("val", wrapper.address, acct.validator))
        acct.validator = wrapper

    def validator_addresses(self) -> list:
        return sorted(
            addr for addr, a in self._accounts.items() if a.validator
        )

    # -- snapshots ---------------------------------------------------------

    def copy(self) -> "StateDB":
        """O(map) shallow fork: both sides keep the same Account
        objects and BOTH lose in-place mutation rights — the first
        mutating access on either side clones just that account."""
        new = StateDB.__new__(StateDB)
        new._accounts = dict(self._accounts)
        new._owned = set()
        new._sorted = self._sorted
        new._jrnl = None
        self._owned = set()
        return new

    def absorb(self, work: "StateDB"):
        """Adopt a mutated ``copy()`` of self (the atomic-apply
        pattern: mutate a copy, absorb on success, drop on failure).
        ``work`` MUST be discarded after this call — ownership of its
        cloned accounts transfers back here."""
        self._accounts = work._accounts
        self._owned |= work._owned
        self._sorted = work._sorted

    # -- EVM frame journal -------------------------------------------------
    # Per-call-frame rollback without copying the account map: the EVM
    # takes snapshot() at frame entry and revert_to() on failure; the
    # code that runs the tx calls end_tx() once the outermost frame
    # settles.  Only mutations made through the StateDB methods above
    # are journaled —
    # in-place edits of a ValidatorWrapper obtained via validator() are
    # invisible to it (the staking paths use whole-state copies instead;
    # any EVM-reachable staking mutation must go through set_validator
    # with a fresh wrapper).

    def snapshot(self) -> int:
        if self._jrnl is None:
            self._jrnl = []
        return len(self._jrnl)

    def revert_to(self, mark: int):
        j = self._jrnl
        while j is not None and len(j) > mark:
            e = j.pop()
            kind, addr = e[0], e[1]
            if kind == "new":
                self._accounts.pop(addr, None)
                self._owned.discard(addr)
                self._sorted = None
                continue
            acct = self._accounts.get(addr)
            if acct is None:  # account journal entry preceded by "new"
                continue
            acct._frag = None
            if kind == "bal":
                acct.balance = e[2]
            elif kind == "nonce":
                acct.nonce = e[2]
            elif kind == "code":
                acct.code = e[2]
            elif kind == "slot":
                if e[3]:
                    acct.storage[e[2]] = e[3]
                else:
                    acct.storage.pop(e[2], None)
            elif kind == "val":
                acct.validator = e[2]

    def end_tx(self):
        """Drop the journal once a transaction's outermost frame has
        settled (its effects are final either way)."""
        self._jrnl = None

    # -- root --------------------------------------------------------------

    def _sorted_addrs(self) -> list:
        if self._sorted is None:
            self._sorted = sorted(self._accounts)
        return self._sorted

    def _fragment(self, addr: bytes, acct: Account) -> bytes | None:
        """``enc(addr) || enc(acct.encode())`` — the unit both root()
        and serialize() consume — or None for an empty account (empty
        accounts don't affect the root).  Cached per account; any
        mutable access drops the cache."""
        c = acct._frag
        if c is not None and c[0] == addr:
            return c[1]
        if acct.validator is None and not acct.code and not acct.storage:
            if acct.balance == 0 and acct.nonce == 0:
                return None  # empty accounts don't affect the root
            # inlined encode() for the dominant plain-account shape
            # (balance + nonce, no flags) — at 10^5 accounts the
            # generic path's call overhead is the first root's hot spot
            b = acct.balance
            bb = b.to_bytes((b.bit_length() + 7) // 8 or 1, "little")
            blob = (len(bb).to_bytes(4, "little") + bb
                    + acct.nonce.to_bytes(8, "little") + b"\x00\x00")
        else:
            blob = acct.encode()
        f = (len(addr).to_bytes(4, "little") + addr
             + len(blob).to_bytes(4, "little") + blob)
        acct._frag = (addr, f)
        return f

    def _live_accounts(self):
        for addr in self._sorted_addrs():
            acct = self._accounts[addr]
            if (acct.balance == 0 and acct.nonce == 0
                    and not acct.validator and not acct.code
                    and not acct.storage):
                continue  # empty accounts don't affect the root
            yield addr, acct

    def root(self) -> bytes:
        """SHA3-256 over sorted (address, account) serializations — the
        flat fast path (one pass, cached fragments, no trie
        construction; see the module docstring for why this is sha3 and
        not the pure-python keccak)."""
        with prof.stage("state.root"):
            h = hashlib.sha3_256()
            for addr in self._sorted_addrs():
                f = self._fragment(addr, self._accounts[addr])
                if f is not None:
                    h.update(f)
            return h.digest()

    def mpt_root(self) -> bytes:
        """Ethereum-SHAPED commitment over the same data: a secure MPT
        whose leaves are RLP([nonce, balance, storage_root, code_hash,
        validator_hash]) keyed by keccak(address) — per-account storage
        committed through its own trie (reference: core/state +
        go-ethereum trie; the extra validator_hash field carries the
        staking state the reference keeps in ValidatorWrapper storage).
        Execution stays flat; this root exists for reference-shaped
        interop and inclusion proofs."""
        from .trie import trie_root

        return trie_root(self._mpt_account_items())

    def _mpt_account_items(self) -> dict:
        """keccak(address) -> RLP account leaf: the exact key/value
        set mpt_root commits and account_proof proves against."""
        from ..ref.keccak import keccak256
        from .. import rlp
        from .trie import EMPTY_ROOT, secure_trie_root

        items = {}
        for addr, acct in self._live_accounts():
            if acct.storage:
                storage_root = secure_trie_root({
                    k: rlp.encode(rlp.int_to_bytes(v))
                    for k, v in acct.storage.items() if v
                })
            else:
                storage_root = EMPTY_ROOT
            items[keccak256(addr)] = rlp.encode([
                acct.nonce, acct.balance, storage_root,
                keccak256(acct.code),
                keccak256(
                    acct.validator.encode() if acct.validator else b""
                ),
            ])
        return items

    def account_proof(self, addr: bytes, slots: list | None = None):
        """eth_getProof-shaped Merkle proofs against mpt_root():
        (mpt_root, account_leaf_rlp_or_b'', account_proof_nodes,
        [(slot, value, proof_nodes)...]).  Each trie is built once and
        walked per key.  reference: the go-ethereum GetProof RPC over
        core/state."""
        from ..ref.keccak import keccak256
        from .. import rlp
        from .trie import build_proof_db, prove_from

        items = self._mpt_account_items()
        key = keccak256(addr)
        root, nodes = build_proof_db(items)
        acct_proof = prove_from(root, nodes, key)
        leaf = items.get(key, b"")
        storage_proofs = []
        acct = self._accounts.get(addr)
        if slots:
            storage_items = {
                keccak256(k): rlp.encode(rlp.int_to_bytes(v))
                for k, v in (acct.storage if acct else {}).items() if v
            }
            sroot, snodes = build_proof_db(storage_items)
            for slot in slots:
                val = acct.storage.get(slot, 0) if acct else 0
                storage_proofs.append(
                    (slot, val, prove_from(sroot, snodes, keccak256(slot)))
                )
        return root, leaf, acct_proof, storage_proofs

    # -- persistence -------------------------------------------------------

    def serialize(self) -> bytes:
        with prof.stage("state.serialize"):
            frags = []
            for addr in self._sorted_addrs():
                f = self._fragment(addr, self._accounts[addr])
                if f is not None:
                    frags.append(f)
            return _enc_int(len(frags), 4) + b"".join(frags)

    @classmethod
    def deserialize(cls, data: bytes) -> "StateDB":
        with prof.stage("state.deserialize"):
            buf = data if isinstance(data, bytes) else bytes(data)
            total = len(buf)
            n = int.from_bytes(buf[:4], "little")
            if n > total - 4:
                raise ValueError(
                    f"implausible element count {n} with "
                    f"{total - 4} bytes left"
                )
            off = 4
            accounts = {}
            for _ in range(n):
                ln = int.from_bytes(buf[off:off + 4], "little")
                a0 = off + 4
                addr = buf[a0:a0 + ln]
                off = a0 + ln
                ln = int.from_bytes(buf[off:off + 4], "little")
                b0 = off + 4
                blob = buf[b0:b0 + ln]
                off = b0 + ln
                if off > total:
                    raise ValueError("truncated state blob")
                acct = _decode_account(blob)
                # pre-seed the fragment cache with the exact wire
                # bytes: the import binding check (root vs sealed
                # header root) then hashes what arrived, with no O(N)
                # re-encode — a non-canonical encoding yields a
                # different root and is rejected by that same check
                acct._frag = (addr, buf[a0 - 4:off])
                accounts[addr] = acct
            return cls(accounts)


def _checked_count(r: Reader, width: int) -> int:
    """Bounded count for crash-damaged blobs (recovery-on-open feeds
    them straight into this decoder and must get a ValueError, never a
    billion-iteration wedge) — Reader.checked_count."""
    return r.checked_count(width)


def _decode_account(blob: bytes) -> Account:
    # fast path for the dominant plain shape — [4B LE len][balance LE]
    # [8B LE nonce][\x00 validator flag][\x00 code flag] — exact-length
    # match required, so every other (or damaged) shape falls through
    # to the checked Reader path below
    k = int.from_bytes(blob[:4], "little")
    if len(blob) == k + 14 and not blob[k + 12] and not blob[k + 13]:
        return Account(
            int.from_bytes(blob[4:4 + k], "little"),
            int.from_bytes(blob[4 + k:12 + k], "little"),
        )
    r = Reader(blob)
    balance = r.big_()
    nonce = r.int_()
    has_val = r.int_(1)
    validator = None
    if has_val:
        address = r.bytes_()
        keys = [r.bytes_() for _ in range(_checked_count(r, 4))]
        rates = [r.big_() for _ in range(5)]
        delegations = []
        for _ in range(_checked_count(r, 4)):
            delegator = r.bytes_()
            amount = r.big_()
            reward = r.big_()
            undel = [(r.big_(), r.int_())
                     for _ in range(_checked_count(r, 4))]
            delegations.append(
                Delegation(delegator, amount, undel, reward)
            )
        signed = r.int_()
        to_sign = r.int_()
        status = r.int_(1)
        last_epoch = r.int_()
        validator = ValidatorWrapper(
            address, keys, rates[0], rates[1], rates[2], rates[3],
            rates[4], delegations, signed, to_sign, status, last_epoch,
        )
    code, storage = b"", {}
    if not r.eof() and r.int_(1):
        code = r.bytes_()
        for _ in range(_checked_count(r, 4)):
            slot = r.bytes_()
            storage[slot] = r.big_()
    return Account(balance, nonce, validator, code, storage)
