"""Chain core: storage, state, execution, mempool, and the blockchain.

The framework's equivalent of the reference's core/ cluster (reference:
core/blockchain.go:47, core/rawdb, core/state, core/state_processor.go,
core/tx_pool.go — SURVEY.md §2.4), redesigned for this codebase: a
pluggable key/value store (kv), an explicit rawdb schema (rawdb),
fixed-layout signable types (types), an account-model state DB with a
deterministic root (state), a transfer+staking state processor
(state_processor), a nonce/price-ordered mempool (tx_pool), and the
Blockchain that ties them to the consensus engine (blockchain).

The port's copy of the JAX package's ``core/__init__.py``.
"""

from .blockchain import Blockchain
from .genesis import Genesis
from .kv import FileKV, MemKV
from .state import StateDB
from .tx_pool import TxPool
from .types import Block, CXReceipt, Receipt, StakingTransaction, Transaction

__all__ = [
    "Block",
    "Blockchain",
    "CXReceipt",
    "FileKV",
    "Genesis",
    "MemKV",
    "Receipt",
    "StakingTransaction",
    "StateDB",
    "Transaction",
    "TxPool",
]
