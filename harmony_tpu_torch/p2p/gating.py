"""Connection gating: who may connect, and how many.

The role of the reference's p2p/gating + p2p/security (reference:
p2p/gating/gater.go connection gater, p2p/security/security.go
max-conn-per-IP and peer blocking — SURVEY.md §2.5).

The port's copy of the JAX package's ``p2p/gating.py``.
"""

from __future__ import annotations

import threading
import time


class Gater:
    def __init__(self, max_peers: int = 64, max_per_ip: int = 8,
                 ban_seconds: float = 600.0):
        self.max_peers = max_peers
        self.max_per_ip = max_per_ip
        self.ban_seconds = ban_seconds
        self._lock = threading.Lock()
        self._per_ip: dict[str, int] = {}
        self._total = 0
        self._banned: dict[str, float] = {}  # ip -> ban expiry

    def ban(self, ip: str):
        with self._lock:
            self._banned[ip] = time.monotonic() + self.ban_seconds

    def unban(self, ip: str):
        with self._lock:
            self._banned.pop(ip, None)

    def allow(self, ip: str) -> bool:
        """Called before accepting; reserves a slot when True."""
        with self._lock:
            expiry = self._banned.get(ip)
            if expiry is not None:
                if time.monotonic() < expiry:
                    return False
                del self._banned[ip]
            if self._total >= self.max_peers:
                return False
            if self._per_ip.get(ip, 0) >= self.max_per_ip:
                return False
            self._per_ip[ip] = self._per_ip.get(ip, 0) + 1
            self._total += 1
            return True

    def release(self, ip: str):
        with self._lock:
            n = self._per_ip.get(ip, 0)
            if n <= 1:
                self._per_ip.pop(ip, None)
            else:
                self._per_ip[ip] = n - 1
            if self._total > 0:
                self._total -= 1
