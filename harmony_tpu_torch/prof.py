"""Kernel-stage profiler: where does a verification's time actually go?

The port's copy of the JAX package's ``prof.py``, with two surfaces:

1. **Stage spans** — ``with prof.stage("hash_to_g2"):`` at the
   host-visible stage boundaries of the pairing pipeline.  Each stage
   records into a per-stage wall-time histogram AND opens a
   ``prof.stage`` trace span, so stages nest under the round trace.
   Disabled cost is one module-bool comparison (the same discipline as
   trace.py — this sits on the verify path).  ``stage_summary()`` is the
   report surface.

2. **Program registry** — ``device.py`` reports every program shape's
   FIRST dispatch here (under torch: the first launch at a program's
   shape, which pays the kernel library's load and the first copies).
   The registry stores that dispatch's wall time; every later dispatch
   feeds a per-program execute-seconds histogram.  All of it exposes as
   the ``harmony_prof_*`` families.

The JAX package's capture hook (``capture``, over ``jax.profiler``) and
its XLA cost analysis of each program have no counterpart here yet: the
first dispatch's record carries its wall time only.

Stdlib + metrics/trace only.
"""

from __future__ import annotations

import os
import threading
import time

from . import trace
from .metrics import Histogram

# The four pipeline stages of PERF_MODEL §1 (plus free-form extras the
# bench tools add).  Order is the exposition order.
STAGES = ("hash_to_g2", "montmul", "miller_loop", "final_exp")

_STAGE_BUCKETS = (1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                  1.0, 5.0)
_EXEC_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
                 5.0, 30.0)
_COMPILE_BUCKETS = (0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)

_MAX_LABELS = 64  # program/stage cardinality bound (pinned buckets
# keep the real set ~a dozen; a runaway label namer must not grow the
# exposition without bound)

_enabled = False
_lock = threading.Lock()  # guards the dicts below; never held across
# anything blocking (histogram observes run on the objects' own locks)
_stage_hist: dict[str, Histogram] = {}
_exec_hist: dict[str, Histogram] = {}
_compile_hist: dict[str, Histogram] = {}
_programs: dict[str, dict] = {}  # program -> {compile_s}


def configure(enabled: bool | None = None) -> None:
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)


def enabled() -> bool:
    """Armed via ``configure`` or HARMONY_TPU_PROF=1 in the
    environment (checked once at first call after reset)."""
    return _enabled


def arm_from_env() -> bool:
    """Apply HARMONY_TPU_PROF=1 (re-applied at import below, callable
    again after a reset)."""
    if os.environ.get("HARMONY_TPU_PROF") == "1":
        configure(enabled=True)
    return _enabled


def reset() -> None:
    """Disarm and drop all recorded data (test teardown)."""
    global _enabled
    _enabled = False
    with _lock:
        _stage_hist.clear()
        _exec_hist.clear()
        _compile_hist.clear()
        _programs.clear()


def _labeled(store: dict, name: str, family: str, help_: str,
             buckets, label: str) -> Histogram | None:
    with _lock:
        h = store.get(name)
        if h is None:
            if len(store) >= _MAX_LABELS:
                return None  # cardinality bound: drop, never grow
            h = Histogram(family, help_, buckets=buckets,
                          labels={label: name})
            store[name] = h
        return h


# -- stage spans -------------------------------------------------------------


class _NoopStage:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopStage()


class _Stage:
    __slots__ = ("name", "_t0", "_span")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self._span = trace.span("prof.stage", component="prof",
                                stage=name, **attrs)
        self._t0 = 0.0

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self._t0
        h = _labeled(
            _stage_hist, self.name, "harmony_prof_stage_seconds",
            "wall time per pairing-pipeline stage",
            _STAGE_BUCKETS, "stage",
        )
        if h is not None:
            h.observe(dt)
        self._span.__exit__(exc_type, exc, tb)
        return False


def stage(name: str, **attrs):
    """``with prof.stage("miller_loop"):`` — one timed pipeline stage,
    recorded as a histogram sample and (when tracing is armed) a
    ``prof.stage`` span nested under the caller's current span.
    Disabled cost: one comparison."""
    if not _enabled:
        return _NOOP
    return _Stage(name, attrs)


def stage_summary() -> dict:
    """{stage: {count, sum_s, p50_s, p99_s}} of everything recorded —
    the bench tools' report surface (no bucket parsing)."""
    with _lock:
        hists = dict(_stage_hist)
    return {name: h.summary() for name, h in hists.items()}


# -- program registry --------------------------------------------------------


def observe_execute(program: str, seconds: float) -> None:
    """One dispatch of a known program shape (post result-sync)."""
    if not _enabled:
        return
    h = _labeled(
        _exec_hist, program, "harmony_prof_execute_seconds",
        "wall time of one dispatch per program shape",
        _EXEC_BUCKETS, "program",
    )
    if h is not None:
        h.observe(seconds)


def on_first_dispatch(program: str, seconds: float) -> None:
    """device.py's hook at the one dispatch per program shape that
    paid the first use: records its wall time.  Never raises into the
    dispatch path."""
    h = _labeled(
        _compile_hist, program, "harmony_prof_compile_seconds",
        "wall time of the first dispatch per program shape",
        _COMPILE_BUCKETS, "program",
    )
    if h is not None:
        h.observe(seconds)
    with _lock:
        if len(_programs) < _MAX_LABELS or program in _programs:
            _programs.setdefault(program, {}).update(compile_s=seconds)


def programs() -> dict:
    """Snapshot of the program registry: {program: {compile_s}}."""
    with _lock:
        return {k: dict(v) for k, v in _programs.items()}


# -- exposition --------------------------------------------------------------

_PROGRAM_GAUGES = (
    ("compile_s", "harmony_prof_program_compile_seconds",
     "wall time of the first dispatch per program"),
)


def expose() -> str:
    """The harmony_prof_* Prometheus families (metrics.Registry hook)."""
    with _lock:
        stages = [_stage_hist[k] for k in sorted(_stage_hist)]
        execs = [_exec_hist[k] for k in sorted(_exec_hist)]
        compiles = [_compile_hist[k] for k in sorted(_compile_hist)]
        progs = {k: dict(v) for k, v in sorted(_programs.items())}
    out = []
    for family in (stages, execs, compiles):
        for i, h in enumerate(family):
            lines = h.expose().splitlines()
            out.append("\n".join(lines if i == 0 else lines[2:]))
    for key, name, help_ in _PROGRAM_GAUGES:
        rows = [(p, v[key]) for p, v in progs.items() if key in v]
        if not rows:
            continue
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} gauge"]
        lines.extend(
            f'{name}{{program="{p}"}} {val:g}' for p, val in rows
        )
        out.append("\n".join(lines))
    return "\n".join(x for x in out if x)


# HARMONY_TPU_PROF=1 arms the profiler for the whole process the
# moment any layer imports this module (device.py does at startup).
arm_from_env()
