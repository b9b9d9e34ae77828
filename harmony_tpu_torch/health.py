"""Liveness watchdog: heartbeats for every long-lived thread, wedge /
death detection, flight-recorder evidence, and supervised restarts.

Every subsystem that owns a long-lived thread — the FBFT pump
(node/node.py run_forever), the scheduler flush thread
(sched/scheduler.py), the sidecar reader (sidecar/client.py), the
background sync downloader (node/node.py _spin_up_sync), the p2p
validate workers + mesh heartbeat (p2p/host.py), the webhook sender
(webhooks.py) — registers a :class:`Heartbeat` and beats it from its
loop.  A participant about to park in a *healthy* unbounded wait (a
condition variable with no work, a socket recv with no traffic) marks
itself ``idle()`` first: idle is not wedged, and the watchdog must not
confuse a quiet subsystem with a dead one.

The watchdog thread classifies each participant:

    ok      beaten within its ``max_age_s`` while busy
    idle    parked in a declared-healthy wait
    stale   BUSY and silent past ``max_age_s`` — a wedged thread
    dead    its bound thread object is no longer alive

On the transition INTO stale/dead it fires exactly one flight-recorder
dump (``trace.anomaly("watchdog.<name>")`` — the per-(kind, trace)
dedup and per-kind cooldown make repeats free), counts the event, and
— where the participant registered a ``restart`` callback — supervises
a restart.  Restarts run only for DEAD participants: a wedged (alive
but stuck) Python thread cannot be killed, so spawning a replacement
would double-run its loop; the restart-safety matrix lives in
docs/ANALYSIS.md ("Overload & degradation model").

``verdicts()`` / ``readiness()`` are the JSON bodies behind the
MetricsServer's ``/healthz`` and ``/readyz`` endpoints;  ``expose()``
is the ``harmony_health_*`` Prometheus family hooked into
``metrics.Registry``.  The port's copy of the JAX package's
``health.py``.

Everything is process-global (like sched/trace/faultinject):
``reset()`` in test teardown.
"""

from __future__ import annotations

import threading
import time

from .log import get_logger
from .metrics import LockedCounters

_log = get_logger("health")

# watchdog lifecycle events, exposed as
# harmony_health_watchdog_total{event=...}
EVENTS = LockedCounters(
    "stale", "dead", "restart", "restart_failed", "recovered",
)

_LOCK = threading.Lock()
_PARTICIPANTS: dict[str, "Heartbeat"] = {}
_MAX_PARTICIPANTS = 256  # cardinality bound (names are label values)
# names of participants seen recovering (watchdog-observed or
# close-while-flagged), bounded — scenario invariants attribute a
# recovery to a SPECIFIC participant with this, not the global count
_RECOVERED_NAMES: set = set()
_CHECK_INTERVAL_S = 0.5
_DEFAULT_MAX_AGE_S = 30.0
_enabled = True
_watchdog: threading.Thread | None = None
_stop = threading.Event()


class Heartbeat:
    """One monitored participant.  ``beat()``/``idle()`` are single
    attribute stores (GIL-atomic, lock-free — the discipline trace.py
    uses): a heartbeat on a hot loop must cost nanoseconds."""

    __slots__ = ("name", "max_age_s", "critical", "restart", "_thread",
                 "_last", "_idle", "beats", "restarts", "closed",
                 "_flagged")

    def __init__(self, name: str, max_age_s: float, critical: bool,
                 restart, thread):
        self.name = name
        self.max_age_s = max_age_s
        self.critical = critical
        self.restart = restart  # zero-arg callable; DEAD-state only
        self._thread = thread
        self._last = time.monotonic()
        self._idle = False
        self.beats = 0
        self.restarts = 0
        self.closed: str | None = None  # close reason once closed
        self._flagged: str | None = None  # state the watchdog reported

    def beat(self) -> None:
        """I am alive and busy."""
        self._last = time.monotonic()
        self._idle = False
        self.beats += 1

    def idle(self) -> None:
        """I am about to park in a healthy unbounded wait."""
        self._last = time.monotonic()
        self._idle = True

    def bind(self, thread) -> None:
        """(Re)bind the monitored thread object (restart paths)."""
        self._thread = thread

    def close(self, reason: str = "stopped") -> None:
        """Controlled exit: deregister.  Identity-guarded — a moribund
        reader closing late must not evict a successor that took the
        same name.  A participant closing while flagged STALE counts
        as a recovery: its subsystem exited the wedge through its own
        fail-closed path (e.g. a stalled sidecar reader dropping the
        connection so the client redials).  Closing while flagged
        DEAD is just cleanup — a permanent thread death deregistered
        at teardown must not be reported as a recovery."""
        self.closed = reason
        if self._flagged == "stale":
            EVENTS.inc("recovered")
            _note_recovered(self.name)
        self._flagged = None
        with _LOCK:
            if _PARTICIPANTS.get(self.name) is self:
                del _PARTICIPANTS[self.name]

    def age_s(self, now: float | None = None) -> float:
        return (now if now is not None else time.monotonic()) - self._last

    def state(self, now: float | None = None) -> str:
        if self.closed is not None:
            return "closed"
        t = self._thread
        if t is not None and not t.is_alive():
            return "dead"
        if self._idle:
            return "idle"
        if self.age_s(now) > self.max_age_s:
            return "stale"
        return "ok"


def configure(enabled: bool | None = None,
              check_interval_s: float | None = None,
              default_max_age_s: float | None = None) -> None:
    global _enabled, _CHECK_INTERVAL_S, _DEFAULT_MAX_AGE_S
    if enabled is not None:
        _enabled = enabled
    if check_interval_s is not None:
        _CHECK_INTERVAL_S = float(check_interval_s)
    if default_max_age_s is not None:
        _DEFAULT_MAX_AGE_S = float(default_max_age_s)


def reset() -> None:
    """Stop the watchdog, drop every participant, restore defaults,
    zero the counters (test / scenario teardown)."""
    global _watchdog, _stop, _enabled, _CHECK_INTERVAL_S
    global _DEFAULT_MAX_AGE_S
    with _LOCK:
        watchdog, _watchdog = _watchdog, None
        stop, _stop = _stop, threading.Event()
        _PARTICIPANTS.clear()
        _RECOVERED_NAMES.clear()
        _enabled = True
        _CHECK_INTERVAL_S = 0.5
        _DEFAULT_MAX_AGE_S = 30.0
    stop.set()
    if watchdog is not None:
        watchdog.join(timeout=5.0)
    for name in EVENTS.keys():
        EVENTS[name] = 0


def register(name: str, *, max_age_s: float | None = None,
             critical: bool = False, restart=None,
             thread=None) -> Heartbeat:
    """Register (or replace) a participant and lazily start the
    watchdog.  Returns the handle the owning loop beats."""
    hb = Heartbeat(
        name,
        _DEFAULT_MAX_AGE_S if max_age_s is None else float(max_age_s),
        critical, restart, thread,
    )
    with _LOCK:
        if (name not in _PARTICIPANTS
                and len(_PARTICIPANTS) >= _MAX_PARTICIPANTS):
            # cardinality bound: evict a NON-critical entry before ever
            # refusing a fresh registration — preferring (1) entries
            # whose thread is dead (leaked transients that never
            # closed), then (2) busy-but-silent ones, and only as a
            # last resort (3) healthy IDLE long-lived participants: a
            # reader parked in recv for minutes has the oldest beat
            # stamp of all, and raw-age eviction would silently
            # deregister exactly the participants the watchdog exists
            # to watch.  Oldest beat breaks ties within a class.
            def _evict_rank(p):
                t = p._thread
                if t is not None and not t.is_alive():
                    cls = 0
                elif not p._idle:
                    cls = 1
                else:
                    cls = 2
                return (cls, p._last)

            victims = [
                p for p in _PARTICIPANTS.values() if not p.critical
            ] or list(_PARTICIPANTS.values())
            del _PARTICIPANTS[min(victims, key=_evict_rank).name]
        _PARTICIPANTS[name] = hb
        _ensure_watchdog_locked()
    return hb


def participants() -> list:
    with _LOCK:
        return list(_PARTICIPANTS.values())


def _ensure_watchdog_locked() -> None:
    global _watchdog
    if not _enabled:
        return
    if _watchdog is not None and _watchdog.is_alive():
        return
    _watchdog = threading.Thread(
        # graftlint: thread-role=watchdog
        target=_watch_loop, args=(_stop,), name="health-watchdog",
        daemon=True,
    )
    _watchdog.start()


def _watch_loop(stop: threading.Event) -> None:
    while not stop.wait(_CHECK_INTERVAL_S):
        check_once()


def check_once() -> dict:
    """One watchdog sweep (also the deterministic test hook): classify
    every participant, report transitions, supervise restarts.
    Returns {name: state}.  All detection work runs OUTSIDE the
    registry lock — restart callbacks and anomaly dumps may block."""
    from . import trace

    now = time.monotonic()
    snapshot = participants()
    states: dict = {}
    for hb in snapshot:
        st = hb.state(now)
        states[hb.name] = st
        if st in ("stale", "dead"):
            if hb._flagged != st:
                hb._flagged = st
                EVENTS.inc(st)
                _log.error(
                    "watchdog: participant " + st,
                    participant=hb.name, age_s=round(hb.age_s(now), 3),
                    max_age_s=hb.max_age_s, critical=hb.critical,
                )
                trace.anomaly(
                    f"watchdog.{hb.name}", participant=hb.name,
                    state=st, age_s=round(hb.age_s(now), 3),
                    critical=hb.critical,
                )
            # restarts ONLY for dead threads: a wedged-but-alive thread
            # cannot be killed, and a second copy of its loop would
            # race the first (the restart-safety matrix in ANALYSIS.md)
            if st == "dead" and hb.restart is not None:
                try:
                    # a supervisor may DECLINE (return False) when
                    # there is nothing to respawn — racing a stop(),
                    # or the thread came back on its own; declined is
                    # not a restart: no count, flag stays, age stays
                    if hb.restart() is False:
                        continue
                    hb.restarts += 1
                    hb._flagged = None
                    hb.beat()
                    EVENTS.inc("restart")
                    _log.warn("watchdog: participant restarted",
                              participant=hb.name,
                              restarts=hb.restarts)
                except Exception as e:  # noqa: BLE001 — a failing
                    # supervisor must keep watching, not die with its
                    # supervisee
                    EVENTS.inc("restart_failed")
                    _log.error("watchdog: restart failed",
                               participant=hb.name, error=repr(e))
        elif hb._flagged is not None:
            hb._flagged = None
            EVENTS.inc("recovered")
            _note_recovered(hb.name)
            _log.warn("watchdog: participant recovered",
                      participant=hb.name, state=st)
    return states


def _note_recovered(name: str) -> None:
    with _LOCK:
        if len(_RECOVERED_NAMES) < _MAX_PARTICIPANTS:
            _RECOVERED_NAMES.add(name)


def recovered_names() -> frozenset:
    """Names of every participant seen recovering since the last
    reset() — the per-participant attribution behind the global
    ``recovered`` counter (bounded at the registry's cardinality)."""
    with _LOCK:
        return frozenset(_RECOVERED_NAMES)


# -- verdict surfaces (MetricsServer /healthz + /readyz) ---------------------


def verdicts() -> dict:
    """Per-subsystem health verdicts.  ``ok`` is False when any
    CRITICAL participant is stale or dead (degraded non-critical
    participants are listed but do not fail the probe)."""
    now = time.monotonic()
    out: dict = {}
    ok = True
    degraded: list = []
    for hb in participants():
        st = hb.state(now)
        out[hb.name] = {
            "state": st,
            "age_s": round(hb.age_s(now), 3),
            "max_age_s": hb.max_age_s,
            "critical": hb.critical,
            "restarts": hb.restarts,
        }
        if st in ("stale", "dead"):
            degraded.append(hb.name)
            if hb.critical:
                ok = False
    return {"ok": ok, "degraded": degraded, "participants": out}


def healthy() -> bool:
    return verdicts()["ok"]


def readiness() -> dict:
    """Readiness = liveness AND the resource governor is not in its
    CRITICAL shed tier.  A node that is alive but actively shedding
    should be drained by its load balancer, not handed more traffic."""
    from . import governor as GV

    v = verdicts()
    gov = GV.current()
    tier = gov.state() if gov is not None else None
    ready = v["ok"] and (tier is None or tier < GV.Tier.CRITICAL)
    return {
        "ready": ready,
        "health_ok": v["ok"],
        "degraded": v["degraded"],
        "governor": GV.TIER_NAMES[tier] if tier is not None else None,
    }


def expose() -> str:
    """Prometheus text: per-participant liveness + watchdog totals."""
    now = time.monotonic()
    lines = [
        "# HELP harmony_health_up participant liveness verdict "
        "(1 = ok/idle, 0 = stale/dead)",
        "# TYPE harmony_health_up gauge",
    ]
    snapshot = sorted(participants(), key=lambda p: p.name)
    for hb in snapshot:
        up = 0 if hb.state(now) in ("stale", "dead") else 1
        lines.append(
            f'harmony_health_up{{participant="{hb.name}"}} {up}'
        )
    lines.append(
        "# HELP harmony_health_beat_age_seconds seconds since the "
        "participant's last beat\n"
        "# TYPE harmony_health_beat_age_seconds gauge"
    )
    for hb in snapshot:
        lines.append(
            "harmony_health_beat_age_seconds"
            f'{{participant="{hb.name}"}} {hb.age_s(now):.3f}'
        )
    lines.append(
        "# HELP harmony_health_watchdog_total watchdog events "
        "(stale/dead detections, restarts, recoveries)\n"
        "# TYPE harmony_health_watchdog_total counter"
    )
    for event, v in EVENTS.items():
        lines.append(
            f'harmony_health_watchdog_total{{event="{event}"}} {v}'
        )
    return "\n".join(lines)
