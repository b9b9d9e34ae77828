"""JSON-RPC: the external API server.

The port's copy of the JAX package's ``rpc/__init__.py``."""

from .server import RPCServer

__all__ = ["RPCServer"]
