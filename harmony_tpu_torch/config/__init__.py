"""Configuration subsystem: epoch-gated chain features and sharding
schedules (reference: internal/params/config.go + internal/configs/
sharding/ — SURVEY.md §2.6).

The port's copy of the JAX package's ``config/__init__.py``.
"""

from .chain import ChainConfig  # noqa: F401
from .sharding import Instance, Schedule  # noqa: F401
