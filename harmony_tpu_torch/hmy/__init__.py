"""The hmy facade: the read/write surface RPC serves.

The role of the reference's hmy.Harmony struct (reference:
hmy/hmy.go:48-85 — one object bundling chain, txpool, and cached
staking reads for every RPC namespace).

The port's copy of the JAX package's ``hmy/__init__.py``.
"""

from .facade import Harmony

__all__ = ["Harmony"]
