"""Chain synchronization over sync streams.

The port's copy of the JAX package's ``sync/__init__.py``.
"""

from .staged import Downloader, SyncResult

__all__ = ["Downloader", "SyncResult"]
