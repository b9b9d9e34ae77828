"""Accounts layer: HD wallets, ABI codec, keystores.

The role of the reference's accounts/ package family (a go-ethereum
fork: keystore, HD derivation, ABI — reference: accounts/abi,
internal/cli + the hmy CLI's BIP-44 flows).  BLS keystores live in
the keystore module; this package adds the ECDSA-side account
tooling.

The port's copy of the JAX package's ``accounts/__init__.py``.
"""

from .abi import (  # noqa: F401
    abi_decode,
    abi_encode,
    encode_call,
    function_selector,
)
from .hd import HDKey, derive_account, mnemonic_to_seed  # noqa: F401
