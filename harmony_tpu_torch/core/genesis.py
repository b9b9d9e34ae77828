"""Genesis: the spec that deterministically produces block 0.

The role of the reference's core/genesis.go + genesis_initializer.go +
internal/genesis (hard-coded foundational accounts and BLS keys —
SURVEY.md §2.6): an account allocation, the initial committee, and the
chain config, hashed into a reproducible genesis header.

The port's copy of the JAX package's ``core/genesis.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import prof
from ..chain.header import Header
from ..config.chain import ChainConfig
from .state import Account, StateDB
from .types import Block


@dataclass
class Genesis:
    config: ChainConfig
    shard_id: int
    alloc: dict = field(default_factory=dict)  # address -> balance
    committee: list = field(default_factory=list)  # 48B BLS pubkeys
    timestamp: int = 0
    extra: bytes = b"harmony-tpu-genesis"

    def build_state(self) -> StateDB:
        # bulk-seeded: the per-mutation accessor machinery (journal
        # check, copy-on-write bookkeeping) costs ~10x a direct
        # construction, which at a 10^5-account rehearsal alloc is the
        # difference between a fixture and a coffee break
        with prof.stage("genesis.build_state"):
            return StateDB({
                addr: Account(balance)
                for addr, balance in sorted(self.alloc.items())
            })

    def build_block(self) -> Block:
        state = self.build_state()
        with prof.stage("genesis.seal"):
            root = self.config.state_root(state, 0)
        header = Header(
            shard_id=self.shard_id,
            block_num=0,
            epoch=0,
            view_id=0,
            parent_hash=bytes(32),
            root=root,
            timestamp=self.timestamp,
            extra=self.extra + b"".join(self.committee),
            version=self.config.header_version(0),
        )
        return Block(header)


def mainnet_genesis(shard_id: int = 0) -> Genesis:
    """The mainnet-shaped genesis: the real epoch-gate table
    (config.chain.mainnet_config), the real era-0 committee assembled
    from the reference's foundational account tables with the
    round-robin shard distribution (reference: internal/genesis/
    foundational.go + harmony.go via shard/committee/assignment.go
    preStakingEnabledCommittee), and the herumi-wire BLS pubkeys.

    The account ALLOCATION is left empty: the reference's initial
    token distribution lives in a one-off genesis contract deploy
    (core/genesis.go GenesisSpec) that predates open-sourcing; nodes
    joining mainnet acquire balances through sync, never genesis
    replay.
    """
    from ..config.chain import mainnet_config
    from ..config.genesis_accounts import committee_slots
    from ..config.sharding import MAINNET

    inst = MAINNET.instance_for_epoch(0)
    slots = committee_slots(inst, shard_id)
    return Genesis(
        config=mainnet_config(),
        shard_id=shard_id,
        alloc={},
        committee=[bls for _, bls, _ in slots],
        extra=b"harmony-mainnet-genesis",
    )


_MAX_DEV_KEYS = 64  # real keypairs per dev genesis; the rest of the
# alloc is hash-derived (keygen is ~13 ms/key — a 10^5-account fixture
# cannot afford 10^5 of them, and only tx-senders need a private key)


def dev_genesis(n_accounts: int = 4, n_keys: int = 4,
                shard_id: int = 0,
                flat_root: bool = False) -> tuple[Genesis, list, list]:
    """A deterministic localnet genesis: funded ECDSA accounts + a BLS
    committee (the test/deploy.sh localnet role — SURVEY.md §4).
    Returns (genesis, ecdsa_keys, bls_secret_keys).

    Beyond ``_MAX_DEV_KEYS`` accounts, the extra allocation entries get
    deterministic hash-derived addresses with no private key — large
    fixtures pay for state size, not keygen.  ``flat_root=True`` gates
    the MPT root off (``mpt_root_epoch=None``) so headers commit the
    O(touched)-fast flat root: the only viable shape for a 10^5-account
    chain, where a pure-python secure-trie seal would take minutes per
    block.
    """
    from .. import bls as B
    from ..crypto_ecdsa import ECDSAKey

    ecdsa_keys = [
        ECDSAKey.from_seed(b"harmony-tpu-dev-%d" % i)
        for i in range(min(n_accounts, _MAX_DEV_KEYS))
    ]
    bls_keys = [B.PrivateKey.generate(b"harmony-tpu-dev-bls-%d" % i)
                for i in range(n_keys)]
    committee = [k.pub.bytes for k in bls_keys]
    alloc = {k.address(): 10**24 for k in ecdsa_keys}
    if n_accounts > len(ecdsa_keys):
        import hashlib

        for i in range(len(ecdsa_keys), n_accounts):
            addr = hashlib.sha3_256(
                b"harmony-tpu-dev-acct-%d" % i
            ).digest()[:20]
            alloc[addr] = 10**24
    config = ChainConfig(chain_id=2)
    if flat_root:
        config.mpt_root_epoch = None
    genesis = Genesis(
        config=config,
        shard_id=shard_id,
        alloc=alloc,
        committee=committee,
    )
    return genesis, ecdsa_keys, bls_keys
