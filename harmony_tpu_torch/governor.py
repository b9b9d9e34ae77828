"""Tiered resource governor: NORMAL -> PRESSURED -> CRITICAL degradation
driven by live process resources, with hysteresis.

The overload model (arXiv:2302.00418's latency-under-load framing: a
consensus node's failure mode past rated capacity is QUEUE growth, not
CPU saturation — and arXiv:2112.02229's batched verification engine
assumes bounded queues in front of it): a sampling loop reads RSS, open
fds, thread count (``metrics.process_sample``, /proc — no psutil), the
scheduler's per-lane queue depths and the attached tx-pools' fill
ratios, classifies each signal against enter thresholds, and drives the
node's EXISTING degradation knobs tier by tier:

    tier       | tx-pool floor | ingress admission      | sched sheds | sync window
    NORMAL     | x1            | open                   | none        | x1
    PRESSURED  | x4            | rate-limited           | INGRESS     | x1/2
               |               | (ratelimit.RateLimiter)|             |
    CRITICAL   | x16           | rejected (429)         | INGRESS+SYNC| x1/4

CONSENSUS work is NEVER shed by the governor, at any tier: overload
must degrade ingestion and catch-up, not safety or liveness.

Hysteresis both ways: escalation is immediate (a melting node must not
wait out a dwell), de-escalation needs the signals below
``threshold * hysteresis`` AND ``dwell_s`` in the current tier, one
tier per dwell — a node hovering at a threshold must not flap its
knobs at the sampling rate.

One process owns at most one governor (``install()`` /
``current()``); the consult helpers (``should_shed``,
``admit_ingress``, ``sync_window_scale``) are module-level with a
None-check fast path so un-governed processes pay one global read.
Entering CRITICAL fires a flight-recorder dump — the moment an
operator will want the correlated evidence for.

The port's copy of the JAX package's ``governor.py``: it reads the
port's ``sched.scheduler.max_queue_depth`` and ``metrics.process_sample``,
and the port's scheduler consults ``should_shed`` (a shed check bound for
CUDA fails with ``device.DeviceError`` there, never runs on the host).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from enum import IntEnum

from .log import get_logger
from .metrics import Counter, Gauge
from .ratelimit import RateLimiter

_log = get_logger("governor")


class Tier(IntEnum):
    NORMAL = 0
    PRESSURED = 1
    CRITICAL = 2


TIER_NAMES = {Tier.NORMAL: "normal", Tier.PRESSURED: "pressured",
              Tier.CRITICAL: "critical"}

# knob maps, per tier
FLOOR_MULTIPLIER = {Tier.NORMAL: 1, Tier.PRESSURED: 4, Tier.CRITICAL: 16}
SYNC_WINDOW_SCALE = {Tier.NORMAL: 1.0, Tier.PRESSURED: 0.5,
                     Tier.CRITICAL: 0.25}

# -- metrics singletons (hooked into metrics.Registry.expose) ----------------

STATE = Gauge(
    "harmony_governor_state",
    "current degradation tier (0 normal, 1 pressured, 2 critical)",
)
TRANSITIONS = Counter(
    "harmony_governor_transitions_total",
    "tier transitions, labeled from/to",
)
REJECTIONS = Counter(
    "harmony_governor_rejections_total",
    "ingress work refused by the governor, per surface "
    "(rpc 429s, tx-pool overload-floor rejections, ...)",
)
SIGNALS = Gauge(
    "harmony_governor_signal",
    "last sampled value per governor input signal",
)


@dataclass(frozen=True)
class Limits:
    """Enter thresholds per signal (exit = enter * hysteresis).

    The defaults suit a production node (multi-GiB RSS budget); tests
    and chaos scenarios pass tightened copies to make the tiers
    reachable inside a CI window."""

    rss_pressured_bytes: int = 6 << 30
    rss_critical_bytes: int = 10 << 30
    fds_pressured: int = 3000
    fds_critical: int = 8000
    threads_pressured: int = 600
    threads_critical: int = 1500
    queue_pressured: int = 512     # deepest scheduler lane
    queue_critical: int = 900
    pool_pressured: float = 0.75   # tx-pool fill ratio
    pool_critical: float = 0.95
    hysteresis: float = 0.8        # exit below enter * this
    dwell_s: float = 2.0           # min time in tier before stepping down


class ResourceGovernor:
    """The sampling loop + tier state machine + the knobs it drives."""

    def __init__(self, limits: Limits | None = None,
                 interval_s: float = 1.0,
                 pressured_ingress_rate: float = 100.0,
                 sample_fn=None, clock=time.monotonic):
        """``sample_fn``: () -> dict overriding the live sources (test
        hook); keys rss_bytes / open_fds / threads / queue_depth /
        pool_fill, missing or None keys are simply not judged."""
        self.limits = limits or Limits()
        self.interval_s = interval_s
        self._sample_fn = sample_fn
        self._clock = clock
        # PRESSURED-tier admission: a reduced token bucket instead of a
        # hard gate — the 429 tier proper is CRITICAL
        self._limiter = RateLimiter(
            pressured_ingress_rate,
            burst=max(1, int(2 * pressured_ingress_rate)),
        )
        self._pools: list = []
        self._state = Tier.NORMAL
        self._since = clock()
        self.peak = Tier.NORMAL
        self.last_sample: dict = {}
        self._lock = threading.Lock()  # transitions only; queries are
        #                                bare reads of _state
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._hb = None

    # -- wiring --------------------------------------------------------------

    def attach_pool(self, pool) -> None:
        """Watch this tx-pool's fill ratio and drive its dynamic
        gas-price floor on tier transitions."""
        self._pools.append(pool)
        pool.set_floor_multiplier(FLOOR_MULTIPLIER[self._state])

    # -- sampling ------------------------------------------------------------

    def sample(self) -> dict:
        if self._sample_fn is not None:
            return dict(self._sample_fn())
        from .metrics import process_sample
        from .sched.scheduler import max_queue_depth

        s = process_sample()
        s["queue_depth"] = max_queue_depth()
        fills = [p.fill_ratio() for p in self._pools]
        s["pool_fill"] = max(fills) if fills else None
        return s

    def _signal_tier(self, value, pressured, critical) -> Tier:
        """Classify one signal with exit-hysteresis relative to the
        CURRENT tier: thresholds at or below the held tier shrink, so
        leaving needs clear headroom, entering does not."""
        if value is None:
            return Tier.NORMAL
        h = self.limits.hysteresis
        c = critical * (h if self._state >= Tier.CRITICAL else 1.0)
        p = pressured * (h if self._state >= Tier.PRESSURED else 1.0)
        if value >= c:
            return Tier.CRITICAL
        if value >= p:
            return Tier.PRESSURED
        return Tier.NORMAL

    def evaluate(self, s: dict) -> Tier:
        """Worst signal wins."""
        lm = self.limits
        return max(
            self._signal_tier(s.get("rss_bytes"),
                              lm.rss_pressured_bytes,
                              lm.rss_critical_bytes),
            self._signal_tier(s.get("open_fds"),
                              lm.fds_pressured, lm.fds_critical),
            self._signal_tier(s.get("threads"),
                              lm.threads_pressured, lm.threads_critical),
            self._signal_tier(s.get("queue_depth"),
                              lm.queue_pressured, lm.queue_critical),
            self._signal_tier(s.get("pool_fill"),
                              lm.pool_pressured, lm.pool_critical),
        )

    def sample_once(self) -> Tier:
        """One sampling pass (also the deterministic test hook)."""
        s = self.sample()
        self.last_sample = s
        for key, v in s.items():
            if v is not None:
                SIGNALS.set(float(v), signal=key)
        target = self.evaluate(s)
        now = self._clock()
        transition = None
        with self._lock:
            cur = self._state
            if target > cur:
                transition = (cur, target)  # escalate immediately
            elif target < cur and now - self._since >= self.limits.dwell_s:
                transition = (cur, Tier(cur - 1))  # step down one tier
            if transition is not None:
                self._state = transition[1]
                self._since = now
                self.peak = max(self.peak, self._state)
        if transition is not None:
            self._apply(transition, s)
        return self._state

    def _apply(self, transition, sample: dict) -> None:
        """Drive the knobs on a tier change (outside ``_lock``: pool
        floors take the pool locks, anomaly dumps hit disk)."""
        frm, to = transition
        TRANSITIONS.inc(**{"from": TIER_NAMES[frm], "to": TIER_NAMES[to]})
        STATE.set(int(to))
        for pool in self._pools:
            pool.set_floor_multiplier(FLOOR_MULTIPLIER[to])
        level = _log.warn if to > Tier.NORMAL else _log.info
        level(
            "governor tier change",
            **{"from": TIER_NAMES[frm], "to": TIER_NAMES[to],
               **{k: v for k, v in sample.items() if v is not None}},
        )
        if to is Tier.CRITICAL:
            from . import trace

            trace.anomaly(
                "governor.critical",
                **{k: str(v) for k, v in sample.items()},
            )

    # -- queries (cross-thread; bare reads of the GIL-atomic _state) ---------

    def state(self) -> Tier:
        return self._state

    def should_shed(self, lane) -> bool:
        """Governor-driven scheduler shedding: INGRESS from PRESSURED,
        SYNC from CRITICAL, CONSENSUS never."""
        from .sched.scheduler import Lane

        st = self._state
        if lane == Lane.INGRESS:
            return st >= Tier.PRESSURED
        if lane == Lane.SYNC:
            return st >= Tier.CRITICAL
        return False

    def admit_ingress(self, key: str = "", surface: str = "rpc") -> bool:
        """Admission verdict for one ingress unit (an RPC request, a
        submission): open at NORMAL, token-bucket limited per key at
        PRESSURED, refused at CRITICAL.  Refusals are counted."""
        st = self._state
        if st is Tier.NORMAL:
            return True
        if st is Tier.CRITICAL:
            REJECTIONS.inc(surface=surface)
            return False
        if self._limiter.allow(key or surface):
            return True
        REJECTIONS.inc(surface=surface)
        return False

    def sync_window_scale(self) -> float:
        return SYNC_WINDOW_SCALE[self._state]

    def floor_multiplier(self) -> int:
        return FLOOR_MULTIPLIER[self._state]

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ResourceGovernor":
        from . import health

        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="governor-sampler", daemon=True,
        )
        self._thread.start()
        self._hb = health.register(
            "governor.sampler", thread=self._thread,
            max_age_s=max(10.0, 5 * self.interval_s),
        )
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._hb is not None:
            self._hb.close()
            self._hb = None
        # restore the attached pools' admission floor: a stopped
        # governor has no sampler left to ever lower a raised floor,
        # and a frozen x16 multiplier would refuse well-priced traffic
        # forever (the other knobs revert via the uninstall() None
        # fast path; the pool floor is the one knob that lives ON the
        # driven object)
        for pool in self._pools:
            pool.set_floor_multiplier(FLOOR_MULTIPLIER[Tier.NORMAL])

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # noqa: BLE001 — a broken sampler
                # must degrade to an unmoving tier, never kill the
                # governor thread (the watchdog would page on it)
                _log.error("governor sample failed", error=repr(e))
            if self._hb is not None:
                self._hb.beat()


# -- process-wide install (the consult surface for the knob sites) -----------

_ACTIVE: ResourceGovernor | None = None


def install(gov: ResourceGovernor) -> ResourceGovernor:
    global _ACTIVE
    _ACTIVE = gov
    STATE.set(int(gov.state()))
    return gov


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None
    STATE.set(0)


def current() -> ResourceGovernor | None:
    return _ACTIVE


def should_shed(lane) -> bool:
    g = _ACTIVE
    return g is not None and g.should_shed(lane)


def admit_ingress(key: str = "", surface: str = "rpc") -> bool:
    g = _ACTIVE
    return g is None or g.admit_ingress(key, surface=surface)


def sync_window_scale() -> float:
    g = _ACTIVE
    return 1.0 if g is None else g.sync_window_scale()


def count_rejection(surface: str) -> None:
    """Shared refusal counter for knob sites that reject on their own
    lock-held fast path (the tx-pool's overload floor)."""
    REJECTIONS.inc(surface=surface)


def rejections_total() -> float:
    """Sum of governed refusals across all surfaces (scenario
    invariants diff this around a run)."""
    return REJECTIONS.total()


def expose() -> str:
    """Prometheus families (metrics.Registry hook)."""
    return "\n".join([
        STATE.expose(), TRANSITIONS.expose(), REJECTIONS.expose(),
        SIGNALS.expose(),
    ])
