"""Dependency registry: one container for the node's shared singletons.

The role of the reference's internal/registry (reference:
internal/registry/registry.go:20-33 — mutex-guarded holder for
blockchain, beaconchain, txpool, engine, worker, webhooks), so wiring
code passes ONE handle instead of seven.

The port's copy of the JAX package's ``node/registry.py``.
"""

from __future__ import annotations

import threading


class Registry:
    _SLOTS = (
        "blockchain", "beaconchain", "txpool", "engine", "worker",
        "host", "sync_client_factory", "webhooks", "metrics",
        "downloader", "discovery", "explorer", "rosetta",
        "shard_count", "aggregation",
    )

    def __init__(self, **initial):
        self._lock = threading.Lock()
        self._d: dict = {}
        for k, v in initial.items():
            self.set(k, v)

    def set(self, name: str, value):
        if name not in self._SLOTS:
            raise KeyError(f"unknown registry slot {name!r}")
        with self._lock:
            self._d[name] = value
        return self

    def get(self, name: str):
        if name not in self._SLOTS:
            raise KeyError(f"unknown registry slot {name!r}")
        with self._lock:
            return self._d.get(name)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)
