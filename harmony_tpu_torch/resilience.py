"""Resilience primitives: deadlines, retry with backoff, circuit breaker.

The north-star node runs its BLS hot path on a TPU backend behind
remote/device boundaries (device dispatch, sidecar socket, p2p sync
streams, webhook POSTs).  Production BFT assumes the crypto layer fails
*fast and loud* so consensus can route around it (the FBFT view-change
literature in PAPERS.md presumes exactly this contract) — a hung socket
or wedged accelerator must degrade the node, never stall it.  This
module is the one vocabulary every boundary shares:

- ``Deadline``  — a monotonic budget passed DOWN a call tree, so one
  user-facing operation never waits longer than its total allowance no
  matter how many retries/hops happen underneath;
- ``RetryPolicy`` — bounded attempts, exponential backoff, and
  *deterministic* jitter (hash of key+attempt, never ``random``), so
  chaos tests replay bit-for-bit;
- ``CircuitBreaker`` — closed/open/half-open over a failing dependency,
  with every transition counted in ``TRANSITIONS`` (a
  ``metrics.LockedCounters``) so a localnet run can ASSERT over
  /metrics that the node noticed a flapping backend.

Stdlib-only, no JAX: importing this module must stay safe from every
layer including the linter's own fixtures.

The port's copy of the JAX package's ``resilience.py``, stdlib only.
"""

from __future__ import annotations

import hashlib
import threading
import time

from . import trace
from .log import get_logger
from .metrics import LockedCounters

_log = get_logger("resilience")


class DeadlineExceeded(TimeoutError):
    """The operation's total time budget ran out (subclass of
    TimeoutError, hence OSError — callers catching socket-style errors
    handle this for free)."""


class Deadline:
    """A fixed point in monotonic time shared down a call tree.

    ``None`` budget means unbounded — every method degrades to the
    no-deadline behavior, so call sites need no branching.
    """

    __slots__ = ("_expires_at",)

    def __init__(self, expires_at: float | None):
        self._expires_at = expires_at

    @classmethod
    def after(cls, budget_s: float | None) -> "Deadline":
        if budget_s is None:
            return cls(None)
        return cls(time.monotonic() + budget_s)

    @classmethod
    def none(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> float | None:
        """Seconds left (clamped at 0.0), or None when unbounded."""
        if self._expires_at is None:
            return None
        return max(0.0, self._expires_at - time.monotonic())

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0.0

    def check(self, what: str = "operation") -> None:
        if self.expired():
            raise DeadlineExceeded(f"{what} exceeded its deadline")

    def bound(self, timeout_s: float | None) -> float | None:
        """The tighter of a per-step timeout and this deadline — what a
        socket/settimeout/event-wait at a leaf should be given."""
        rem = self.remaining()
        if rem is None:
            return timeout_s
        if timeout_s is None:
            return rem
        return min(timeout_s, rem)


class RetryPolicy:
    """Bounded retry with exponential backoff and deterministic jitter.

    Jitter is derived from sha256(seed, key, attempt) — NOT ``random``
    — so a fault-injection run replays the exact same schedule every
    time.  ``run`` is budget-aware: it never sleeps past a
    ``Deadline`` and raises the last error the moment the budget
    cannot cover another backoff.
    """

    def __init__(self, attempts: int = 3, base_delay_s: float = 0.05,
                 multiplier: float = 2.0, max_delay_s: float = 2.0,
                 jitter: float = 0.5, seed: int = 0):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = attempts
        self.base_delay_s = base_delay_s
        self.multiplier = multiplier
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.seed = seed

    def delay(self, attempt: int, key: str = "") -> float:
        """Backoff before retry number ``attempt`` (1-based), jittered
        deterministically per (seed, key, attempt)."""
        raw = self.base_delay_s * (self.multiplier ** (attempt - 1))
        capped = min(self.max_delay_s, raw)
        digest = hashlib.sha256(
            f"{self.seed}:{key}:{attempt}".encode()
        ).digest()
        frac = int.from_bytes(digest[:4], "big") / 2**32
        # spread over [1 - jitter, 1]: never longer than the cap
        return capped * (1.0 - self.jitter * frac)

    def run(self, fn, *, retry_on: tuple = (Exception,),
            deadline: Deadline | None = None, key: str = "",
            on_retry=None, sleep=time.sleep):
        """Call ``fn`` until it returns, retries exhaust, or the
        deadline can no longer cover the next backoff.  Raises the last
        error (or DeadlineExceeded if the budget died before the first
        attempt)."""
        last: BaseException | None = None
        for attempt in range(1, self.attempts + 1):
            if deadline is not None and deadline.expired():
                break
            try:
                return fn()
            except retry_on as e:  # noqa: B030 — caller-chosen tuple
                last = e
                if attempt == self.attempts:
                    break
                pause = self.delay(attempt, key)
                if deadline is not None:
                    rem = deadline.remaining()
                    if rem is not None and rem <= pause:
                        break  # budget can't cover the backoff: fail now
                if on_retry is not None:
                    on_retry(attempt, e)
                sleep(pause)
        if last is None:
            raise DeadlineExceeded(f"{key or 'operation'} had no budget "
                                   "left before the first attempt")
        raise last


# Breaker lifecycle events, exported through metrics.Registry.expose()
# (harmony_resilience_events_total{breaker=...,event=...}).  Keys are
# "<breaker name>:<event>" — ':' so names with underscores parse.
TRANSITIONS = LockedCounters()

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Closed/open/half-open breaker over one dependency.

    - CLOSED: calls flow; ``failure_threshold`` consecutive failures
      trip it OPEN.
    - OPEN: ``allow()`` returns False (callers take their fallback)
      until ``reset_timeout_s`` elapses, then HALF_OPEN.
    - HALF_OPEN: ``half_open_probes`` calls are admitted; one success
      closes the breaker, one failure re-opens it (fresh timeout).

    Thread-safe; transitions are counted in ``TRANSITIONS`` under the
    breaker's name.  ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, name: str, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, half_open_probes: int = 1,
                 clock=time.monotonic):
        self.name = name
        self.failure_threshold = failure_threshold
        self.reset_timeout_s = reset_timeout_s
        self.half_open_probes = half_open_probes
        self._clock = clock
        self._lock = threading.Lock()
        self._state = _CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._probes_in_flight = 0

    def _note(self, events: list) -> None:
        """Count + log transitions AFTER self._lock is released: the
        breaker sits on verification hot paths whose callers may hold
        their own locks — nothing blocking (not even the log sink's
        lock) runs inside the breaker's critical section."""
        for event in events:
            TRANSITIONS.inc(f"{self.name}:{event}")
            if event == "open":
                _log.warn("breaker opened", breaker=self.name)
                # flight recorder: one correlated dump of the spans +
                # log lines of the round that tripped the breaker
                # (no-op while tracing is disarmed; runs OUTSIDE
                # self._lock like everything in _note)
                trace.anomaly("breaker_open", breaker=self.name)
            elif event in ("half_open", "close"):
                _log.info(f"breaker {event}", breaker=self.name)

    @property
    def state(self) -> str:
        events: list = []
        with self._lock:
            self._maybe_half_open(events)
            st = self._state
        self._note(events)
        return st

    def _maybe_half_open(self, events: list) -> None:
        # caller holds self._lock
        if (self._state == _OPEN
                and self._clock() - self._opened_at
                >= self.reset_timeout_s):
            self._state = _HALF_OPEN
            self._probes_in_flight = 0
            events.append("half_open")

    def allow(self) -> bool:
        """May a call go through right now?  HALF_OPEN admits at most
        ``half_open_probes`` concurrent probes."""
        events: list = []
        with self._lock:
            self._maybe_half_open(events)
            if self._state == _CLOSED:
                ok = True
            elif self._state == _HALF_OPEN \
                    and self._probes_in_flight < self.half_open_probes:
                self._probes_in_flight += 1
                ok = True
            else:
                events.append("rejected")
                ok = False
        self._note(events)
        return ok

    def record_success(self) -> None:
        events: list = []
        with self._lock:
            if self._state == _HALF_OPEN:
                self._state = _CLOSED
                events.append("close")
            self._failures = 0
            self._probes_in_flight = 0
        self._note(events)

    def record_failure(self) -> None:
        events: list = []
        with self._lock:
            if self._state == _HALF_OPEN:
                self._state = _OPEN
                self._opened_at = self._clock()
                self._probes_in_flight = 0
                events.append("open")
            else:
                self._failures += 1
                if self._state == _CLOSED \
                        and self._failures >= self.failure_threshold:
                    self._state = _OPEN
                    self._opened_at = self._clock()
                    events.append("open")
        self._note(events)
