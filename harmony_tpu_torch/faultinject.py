"""Deterministic fault injection for the remote/device boundaries.

Production code calls ``fire(point)`` (and ``garble(point, data)`` for
byte streams) at named injection points; with nothing armed both are a
single flag check — zero cost on the hot path.  Tests arm faults
against a point and the next matching hits raise, stall, or corrupt
deterministically: matching is pure counting (``after``/``every``/
``times``) plus an optional ``key`` (e.g. one peer's address), and
``garble`` mutates bytes via sha256 of the registry seed — no clocks,
no ``random`` — so a chaos run replays bit-for-bit.

Scenario scripts (chaostest) additionally arm *phased* rules: a rule
with ``t0``/``t1`` is only live inside that wall-clock window
(seconds relative to the ``arm()`` call), and a rule with ``when=``
is only live while the predicate returns True — e.g.
``when=lambda: 3 <= chain.head_number < 6`` scripts "fault between
round 3 and round 6" instead of counting hits.  Hits outside a rule's
live window do not consume its ``after``/``every``/``times`` budget,
so "black-hole the backend from t=5s for 10s" composes with counting
rules on the same point.  ``when`` runs under the registry lock on
the injected hot path: keep it to a cheap read (an int attribute, an
event flag) and never call back into this module from it.

Wired injection points:

    device.dispatch  — device.py, before each verify/agg/batch program
    sidecar.call     — sidecar/client.py, entry of every RPC
    sidecar.frame    — sidecar/client.py reader, per received frame
    p2p.stream       — p2p/stream.py SyncClient, entry of every request
                       (key = "host:port" of the peer)
    webhook.post     — webhooks.py, each HTTP POST attempt
    kv.commit        — core/kv.py FileKV.write_batch (key = the store's
                       path): before the BEGIN marker, before every
                       record, before the COMMIT marker — the storage
                       crash-point matrix that ``python -m
                       harmony_tpu_torch.tools.crash_sweep`` walks

Always ``reset()`` in test teardown: the registry is process-global.

The port's copy of the JAX package's ``faultinject.py``, stdlib only.
"""

from __future__ import annotations

import hashlib
import threading
import time


class FaultInjected(ConnectionError):
    """Default exception for armed faults with no explicit ``exc``."""


class _Rule:
    __slots__ = ("exc", "delay_s", "garble", "key", "every", "times",
                 "after", "seen", "fired", "t0", "t1", "when")

    def __init__(self, exc, delay_s, garble, key, every, times, after,
                 t0=None, t1=None, when=None):
        self.exc = exc
        self.delay_s = delay_s
        self.garble = garble
        self.key = key
        self.every = max(1, every)
        self.times = times
        self.after = max(0, after)
        self.seen = 0  # matching hits observed (while live)
        self.fired = 0  # faults actually delivered
        self.t0 = t0  # absolute monotonic window start (None = open)
        self.t1 = t1  # absolute monotonic window end (None = open)
        self.when = when  # predicate gating liveness (None = always)

    def matches(self, key) -> bool:
        return self.key is None or self.key == key

    def live(self, now: float) -> bool:
        """Is this rule's phase window open?  Outside it the rule is
        invisible: no counting, no firing."""
        if self.t0 is not None and now < self.t0:
            return False
        if self.t1 is not None and now >= self.t1:
            return False
        if self.when is not None:
            try:
                if not self.when():
                    return False
            except Exception:  # noqa: BLE001 — a broken predicate must
                # never fault the production call site it gates
                return False
        return True

    def take(self) -> bool:
        """Count one matching hit; True if this hit should fault."""
        self.seen += 1
        n = self.seen - self.after
        if n <= 0:
            return False
        if self.times is not None and self.fired >= self.times:
            return False
        if (n - 1) % self.every != 0:
            return False
        self.fired += 1
        return True


_lock = threading.Lock()
_rules: dict[str, list[_Rule]] = {}
_hits: dict[str, int] = {}
_seed = 0
_armed = False  # fast-path flag: False => fire()/garble() are no-ops


def reset() -> None:
    """Disarm everything and zero all counters (test teardown)."""
    global _armed, _seed
    with _lock:
        _rules.clear()
        _hits.clear()
        _seed = 0
        _armed = False


def set_seed(seed: int) -> None:
    global _seed
    with _lock:
        _seed = int(seed)


def arm(point: str, *, exc=None, delay_s: float | None = None,
        garble: bool = False, key=None, every: int = 1,
        times: int | None = None, after: int = 0,
        t0: float | None = None, t1: float | None = None,
        when=None) -> None:
    """Arm a fault at ``point``.

    exc      exception class/instance/factory to raise (default
             FaultInjected when neither delay nor garble is given)
    delay_s  sleep before returning (or before raising, if exc too) —
             a slow backend, not a dead one
    garble   corrupt bytes passed through ``garble()`` at this point
    key      only hits with this key match (None = every hit)
    every    fault every Nth matching hit (1 = all)
    times    stop after this many delivered faults (None = forever)
    after    skip the first N matching hits
    t0/t1    phased mode: the rule is live only between t0 and t1
             seconds AFTER this arm() call (None = unbounded on that
             side); hits outside the window are not counted
    when     phased mode: the rule is live only while this zero-arg
             predicate returns True (e.g. a round-window closure over
             ``chain.head_number``); must be cheap and must not call
             back into faultinject — it runs under the registry lock
    """
    global _armed
    if exc is None and delay_s is None and not garble:
        exc = FaultInjected
    now = time.monotonic()
    with _lock:
        _rules.setdefault(point, []).append(
            _Rule(exc, delay_s, garble, key, every, times, after,
                  t0=None if t0 is None else now + t0,
                  t1=None if t1 is None else now + t1,
                  when=when)
        )
        _armed = True


def hits(point: str) -> int:
    """How many times ``fire()`` reached this point (armed or not —
    counted only while the registry is armed)."""
    with _lock:
        return _hits.get(point, 0)


def fired(point: str, key=None) -> int:
    """Faults actually DELIVERED at ``point`` (summed over armed rules;
    ``key`` narrows to rules bound to that key).  Lets a scenario
    script wait for 'the crash point has fired on THIS node' instead
    of guessing with sleeps."""
    with _lock:
        return sum(
            r.fired for r in _rules.get(point, ())
            if key is None or r.key == key
        )


def _raise(exc, point: str):
    if isinstance(exc, BaseException):
        raise exc
    err = exc(f"fault injected at {point}")
    raise err


def fire(point: str, key=None) -> None:
    """Evaluate armed faults for one hit of ``point``.  Raises or
    sleeps per the first matching armed rule; no-op when disarmed."""
    if not _armed:
        return
    delay_s, exc = None, None
    now = time.monotonic()
    with _lock:
        _hits[point] = _hits.get(point, 0) + 1
        for rule in _rules.get(point, ()):
            if rule.garble or not rule.matches(key):
                continue  # garble rules spend their budget in garble()
            if not rule.live(now):
                continue  # outside its phase window: invisible
            if rule.take():
                delay_s, exc = rule.delay_s, rule.exc
                break
    if delay_s is not None:
        time.sleep(delay_s)
    if exc is not None:
        _raise(exc, point)


def garble(point: str, data: bytes, key=None) -> bytes:
    """Pass ``data`` through the point: armed garble rules corrupt it
    deterministically (seeded byte flips), otherwise it returns
    unchanged."""
    if not _armed or not data:
        return data
    hit = False
    now = time.monotonic()
    with _lock:
        _hits[point] = _hits.get(point, 0) + 1
        for rule in _rules.get(point, ()):
            if not rule.garble or not rule.matches(key):
                continue  # fire-style rules spend their budget in fire()
            if not rule.live(now):
                continue  # outside its phase window: invisible
            if rule.take():
                hit = True
                break
        seed = _seed
    if not hit:
        return data
    digest = hashlib.sha256(f"{seed}:{point}:{len(data)}".encode()).digest()
    out = bytearray(data)
    for i in range(min(4, len(out))):
        pos = digest[i] % len(out)
        out[pos] ^= digest[4 + i] | 0x01  # guaranteed bit flip
    return bytes(out)
