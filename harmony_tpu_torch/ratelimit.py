"""Token-bucket rate limiting, shared by the RPC and sync-stream
servers (reference: rpc rate limiting, rpc.go:158-216 + the p2p/stream
rate-limiter tiers).

The port's copy of the JAX package's ``ratelimit.py``; the resource
governor's PRESSURED tier admits ingress through it."""

from __future__ import annotations

import threading
import time


class RateLimiter:
    """Token bucket per key (client ip, connection id, ...).

    ``max_keys`` bounds the per-key state: past it, the stalest bucket
    (oldest refill stamp) is evicted to admit a new key.  An attacker
    cycling source addresses — exactly the traffic shape a limiter
    meets — must not grow the LIMITER's own memory without bound; an
    evicted key simply starts over with a full burst.  Eviction is
    O(1): ``_state`` is kept in touch order (every ``allow`` re-stamps
    and re-inserts its key, so dict order IS refill-stamp order) and
    the front entry is the stalest — a full table must not buy every
    new-key admission a ``max_keys`` scan under the lock precisely
    when the node is already pressured."""

    def __init__(self, per_second: float = 100.0, burst: int = 200,
                 max_keys: int = 4096):
        self.rate = per_second
        self.burst = burst
        self.max_keys = max_keys
        self._state: dict = {}
        self._lock = threading.Lock()

    def allow(self, key: str) -> bool:
        now = time.monotonic()
        with self._lock:
            entry = self._state.pop(key, None)
            if entry is None and len(self._state) >= self.max_keys:
                del self._state[next(iter(self._state))]
            tokens, last = entry if entry is not None else (self.burst, now)
            tokens = min(self.burst, tokens + (now - last) * self.rate)
            if tokens < 1.0:
                self._state[key] = (tokens, now)
                return False
            self._state[key] = (tokens - 1.0, now)
            return True

    def drop(self, key: str):
        """Forget a key's bucket (a disconnected peer's state must
        not accumulate across churn)."""
        with self._lock:
            self._state.pop(key, None)

    def wait(self, key: str):
        """Block until a token is available, then consume it — the
        back-pressure shape (serve slowly, never drop)."""
        while not self.allow(key):
            time.sleep(1.0 / self.rate)
