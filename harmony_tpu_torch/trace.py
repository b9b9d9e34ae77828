"""End-to-end round tracing + flight recorder.

The repo can survive faults (resilience.py) and count them (metrics.py);
this module answers "where did round N spend its 800 ms?" — the
per-round timeline tying FBFT phases (announce → prepare-quorum →
commit-quorum → finalize) to the BLS device dispatches and sidecar
calls that dominate them, the signature-latency breakdown that
committee-consensus studies treat as the first-class measurement
(PAPERS: arXiv 2302.00418 §5; Handel, arXiv 1906.05132, instruments
per-level aggregation timing the same way).

Design constraints, in order:

1. **Near-zero disabled cost.**  Tracing is OFF by default; every
   entry point (``span``, ``resume``, ``annotate``, ``traceparent``,
   ``record_log``) checks one module-level bool first and returns a
   shared no-op.  No allocation, no lock, no clock read when disabled.
2. **Lock-free hot path when enabled.**  Span begin is an object +
   a contextvar set; span end is two ``deque.append``s (GIL-atomic,
   ``maxlen``-bounded) and a dict del.  The only lock in this module
   guards the rare anomaly-dump path — never a span lifecycle — so
   tracing adds no lock-order edges under the consensus/insert locks.
3. **Cross-boundary context.**  ``traceparent()`` emits a compact
   26-byte binary context (version, 16B trace id, 8B span id, flags)
   carried in FBFT consensus messages, sidecar protocol frames and
   p2p stream requests; ``resume()`` continues the trace on the far
   side so device/sidecar work lands under the round that caused it.
4. **Flight recorder.**  A ring of recent spans + structured log
   records (log.py feeds every emitted record while tracing is on).
   ``anomaly()`` — fired on circuit-breaker open, view-change start,
   sidecar desync, round-SLO overrun — dumps ONE correlated snapshot
   (spans + log records sharing the trace id) to disk and the log.

Consumers: ``GET /debug/trace`` on the metrics server serves
``export_chrome()`` — Chrome trace-event JSON, loadable in Perfetto.

Stdlib-only; importing this module must stay safe from every layer
(log.py imports it at module level).

The port's copy of the JAX package's ``trace.py``, whole: node
attribution (``set_node``, ``bind_node``, ``node_scope``,
``current_node``), the round SLO (``round_slo_s``), the span export hook
and ``export_chrome`` included.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import tempfile
import threading
import time
from collections import deque
from contextvars import ContextVar

# -- configuration -----------------------------------------------------------

_enabled = False  # THE one-comparison fast path
_sample_rate = 1.0
_round_slo_s: float | None = None
_dump_dir: str | None = None

_STORE_CAP = 4096  # finished spans kept for /debug/trace
_EVENT_CAP = 1024  # log records kept for flight-recorder correlation
_DUMP_CAP = 64  # dump paths remembered (files persist regardless)

# Anchors monotonic span clocks to wall time once, so exported ts are
# comparable across the processes of one localnet.
_WALL0 = time.time() - time.monotonic()

# Process-unique id generator: sha256(seed, n) — no per-span urandom
# syscall, unique across processes via the one-time seed.
_ID_SEED = os.urandom(8)
_ID_COUNTER = itertools.count(1)
_PID = os.getpid()  # cached: the getpid syscall costs ~50us on the
# sandboxed CI kernel, dominating an enabled span's lifecycle

TRACEPARENT_LEN = 26  # 1 version + 16 trace id + 8 span id + 1 flags
_FLAG_SAMPLED = 0x01

_current: ContextVar["Span | None"] = ContextVar("harmony_tpu_trace",
                                                 default=None)

# -- node attribution: every span carries node= so traces merged across
# the in-process localnet (one shared store) or across real processes
# (JSONL sink files) remain attributable per node.  Resolution order:
# thread/context binding (pump threads of an in-process localnet), then
# the process-wide default (one real node per process, set by cli.py).
_node_default: str | None = None
_node_ctx: ContextVar["str | None"] = ContextVar("harmony_tpu_trace_node",
                                                 default=None)

# Export hook (obs.SpanSink): called with each finished Span.  A plain
# module global read on the finish path — None when no sink is armed.
_export_hook = None

_finished: deque = deque(maxlen=_STORE_CAP)
_events: deque = deque(maxlen=_EVENT_CAP)
_active: dict[str, "Span"] = {}  # span_id -> open span (dump visibility)
_thread_names: dict[int, str] = {}

_dump_lock = threading.Lock()  # anomaly path only, never span lifecycle
_dumps: list = []  # dump file paths, bounded to _DUMP_CAP
_dump_total = 0  # lifetime dump count; filenames rotate modulo the cap
_dump_last: dict = {}  # kind -> monotonic time of its last dump
_dump_cooldown_s = 30.0  # per-kind rate limit (a flapping breaker or
# repeated view changes must not flood the disk or the trigger path)
_dump_seen: "deque[tuple]" = deque(maxlen=1024)  # (kind, trace_id)
# pairs already dumped: one anomaly trigger per trace writes ONE dump
# — a view-change storm re-firing on the same wedged round must not
# burn the disk budget re-snapshotting the same evidence
_DUMP_BUDGET_DEFAULT = 64 * 1024 * 1024
_dump_budget_bytes = _DUMP_BUDGET_DEFAULT  # lifetime byte cap; 0 = off
_dump_bytes = 0  # payload bytes written since reset()


def configure(enabled: bool | None = None, sample_rate: float | None = None,
              round_slo_s: float | None = ...,
              dump_dir: str | None = None,
              dump_cooldown_s: float | None = None,
              dump_max_bytes: int | None = None) -> None:
    """Arm/tune the tracer.  ``sample_rate`` applies at ROOT span
    creation (deterministic by trace-id hash — no ``random``);
    ``round_slo_s`` arms the round-latency anomaly (``...`` = leave
    unchanged, ``None`` = disarm); ``dump_dir`` is where the flight
    recorder writes (default: $HARMONY_TPU_TRACE_DIR or
    <tmp>/harmony_tpu_flight); ``dump_cooldown_s`` rate-limits dumps
    per anomaly kind (0 disables the limit); ``dump_max_bytes`` caps
    the lifetime bytes the flight recorder may write per process
    (default 64 MiB; 0 disables the budget)."""
    global _enabled, _sample_rate, _round_slo_s, _dump_dir
    global _dump_cooldown_s, _dump_budget_bytes
    if sample_rate is not None:
        _sample_rate = max(0.0, min(1.0, float(sample_rate)))
    if round_slo_s is not ...:
        _round_slo_s = round_slo_s
    if dump_dir is not None:
        _dump_dir = dump_dir
    if dump_cooldown_s is not None:
        _dump_cooldown_s = float(dump_cooldown_s)
    if dump_max_bytes is not None:
        _dump_budget_bytes = int(dump_max_bytes)
    if enabled is not None:
        _enabled = bool(enabled)


def enabled() -> bool:
    return _enabled


def round_slo_s() -> float | None:
    return _round_slo_s


def set_node(name: str | None) -> None:
    """Process-wide node identity stamped onto every span (``node=``
    attr).  One real node per process: cli.py sets this once at boot."""
    global _node_default
    _node_default = name


def bind_node(name: str | None) -> None:
    """Bind a node identity to the CURRENT thread/context — the
    in-process localnet runs several nodes in one process, so each
    consensus pump binds its own name at thread start.  Overrides the
    process default for spans created under this context."""
    _node_ctx.set(name)


class _NodeScope:
    """Context manager scoping a node binding (pump-driven tests run
    many nodes on ONE thread, so the binding must nest and restore)."""

    __slots__ = ("_name", "_token")

    def __init__(self, name: str):
        self._name = name
        self._token = None

    def __enter__(self):
        self._token = _node_ctx.set(self._name)
        return self

    def __exit__(self, *exc):
        _node_ctx.reset(self._token)
        return False


def node_scope(name: str):
    """``with trace.node_scope("shard0-a"):`` — spans created inside
    carry ``node=name``.  Disabled cost: one comparison."""
    if not _enabled:
        return _NOOP
    return _NodeScope(name)


def current_node() -> str | None:
    """The node identity spans would be stamped with right now."""
    node = _node_ctx.get()
    return node if node is not None else _node_default


def set_export_hook(hook) -> None:
    """Install (or clear, with None) the finished-span export hook.
    Called synchronously from ``finish`` — implementations must be
    O(queue append) and never raise (obs.SpanSink qualifies)."""
    global _export_hook
    _export_hook = hook


def reset() -> None:
    """Disarm and drop every buffer (test teardown).  Dump FILES are
    left on disk — they are the evidence a failed test points at."""
    global _enabled, _sample_rate, _round_slo_s, _dump_dir
    global _dump_cooldown_s, _dump_total, _dump_budget_bytes, _dump_bytes
    global _node_default, _export_hook
    _enabled = False
    _node_default = None
    _export_hook = None
    _sample_rate = 1.0
    _round_slo_s = None
    _dump_dir = None
    _dump_cooldown_s = 30.0
    _finished.clear()
    _events.clear()
    _active.clear()
    _thread_names.clear()
    with _dump_lock:
        _dumps.clear()
        _dump_last.clear()
        _dump_seen.clear()
        _dump_total = 0
        _dump_budget_bytes = _DUMP_BUDGET_DEFAULT
        _dump_bytes = 0


def _new_id(nbytes: int) -> str:
    digest = hashlib.sha256(
        _ID_SEED + next(_ID_COUNTER).to_bytes(8, "little")
    ).digest()
    return digest[:nbytes].hex()


# -- spans -------------------------------------------------------------------


class Span:
    """One timed operation.  Mutable only via ``annotate`` until
    ``finish``; identity fields are fixed at creation."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "component",
                 "t0", "dur_s", "attrs", "tid", "pid")

    def __init__(self, trace_id: str, parent_id: str | None, name: str,
                 component: str, attrs: dict):
        self.trace_id = trace_id
        self.span_id = _new_id(8)
        self.parent_id = parent_id
        self.name = name
        self.component = component
        self.t0 = time.monotonic()
        self.dur_s: float | None = None
        self.attrs = attrs
        if "node" not in attrs:
            node = _node_ctx.get()
            if node is None:
                node = _node_default
            if node is not None:
                attrs["node"] = node
        t = threading.current_thread()
        self.tid = t.ident or 0
        self.pid = _PID
        _thread_names.setdefault(self.tid, t.name)
        _active[self.span_id] = self

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "component": self.component,
            "ts": round(self.t0 + _WALL0, 6),
            "dur_s": self.dur_s,
            "attrs": dict(self.attrs),
            "pid": self.pid,
            "tid": self.tid,
        }


class _Noop:
    """Shared disabled/unsampled stand-in: context manager AND span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs):
        pass

    def finish(self):
        pass


_NOOP = _Noop()


class _Handle:
    """Context manager owning one span: sets the context on enter,
    restores it and finishes the span on exit."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span):
        self.span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        _current.reset(self._token)
        if exc_type is not None:
            self.span.attrs.setdefault("error", exc_type.__name__)
        finish(self.span)
        return False


class _Use:
    """Context manager that only sets the current span (no lifecycle):
    for long-lived spans owned elsewhere (the leader's round span)."""

    __slots__ = ("span", "_token")

    def __init__(self, span: Span):
        self.span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _current.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb):
        _current.reset(self._token)
        return False


def _sampled(trace_id: str) -> bool:
    if _sample_rate >= 1.0:
        return True
    if _sample_rate <= 0.0:
        return False
    # deterministic per trace id: the same trace samples the same way
    # on every node that sees it
    return int(trace_id[:8], 16) / 2**32 < _sample_rate


def start(name: str, component: str = "", parent: "Span | None" = None,
          **attrs) -> "Span | None":
    """Begin a span WITHOUT entering its context (caller owns its
    lifetime; pair with ``finish``/``use``; None when tracing is off
    or the trace is unsampled — both accepted by finish/use).  Parent
    defaults to the context's current span; a parentless span roots a
    new trace and is subject to the sampling knob."""
    if not _enabled:
        return None
    if parent is None:
        parent = _current.get()
    if parent is not None and not isinstance(parent, Span):
        return None  # under a no-op parent: stay dark
    if parent is not None:
        return Span(parent.trace_id, parent.span_id, name, component, attrs)
    trace_id = _new_id(16)
    if not _sampled(trace_id):
        return None
    return Span(trace_id, None, name, component, attrs)


def finish(span) -> float | None:
    """Close a span; returns its duration in seconds (None for no-op)."""
    if span is None or isinstance(span, _Noop):
        return None
    span.dur_s = time.monotonic() - span.t0
    _active.pop(span.span_id, None)
    _finished.append(span)
    hook = _export_hook
    if hook is not None:
        try:
            hook(span)
        except Exception:  # noqa: BLE001 — a broken sink must never
            pass  # break the span lifecycle of the path that traced
    return span.dur_s


def span(name: str, component: str = "", **attrs):
    """``with trace.span("device.dispatch", component="device"):`` —
    the one-liner for scoped work.  Disabled cost: one comparison."""
    if not _enabled:
        return _NOOP
    sp = start(name, component, **attrs)
    if sp is None:
        return _NOOP
    return _Handle(sp)


def use(span_: "Span | _Noop | None"):
    """Make an externally-owned span the context's current span for a
    block (does not finish it)."""
    if not _enabled or span_ is None or isinstance(span_, _Noop):
        return _NOOP
    return _Use(span_)


def current_span() -> "Span | None":
    if not _enabled:
        return None
    return _current.get()


def annotate(**attrs) -> None:
    """Attach attributes to the current span (no-op without one)."""
    if not _enabled:
        return
    sp = _current.get()
    if sp is not None:
        sp.attrs.update(attrs)


def current_ids() -> "tuple[str, str] | None":
    """(trace_id, span_id) of the current span — log.py stamps these
    onto every record emitted under an active span."""
    if not _enabled:
        return None
    sp = _current.get()
    if sp is None:
        return None
    return sp.trace_id, sp.span_id


# -- cross-boundary propagation ----------------------------------------------


def traceparent() -> bytes:
    """Compact binary trace context of the current span (b"" when no
    span is active): [u8 version=0][16B trace id][8B span id][u8 flags].
    Carried in consensus messages, sidecar frames and p2p requests."""
    if not _enabled:
        return b""
    sp = _current.get()
    if sp is None:
        return b""
    return (b"\x00" + bytes.fromhex(sp.trace_id)
            + bytes.fromhex(sp.span_id) + bytes([_FLAG_SAMPLED]))


def parse_traceparent(tc: bytes) -> "tuple[str, str] | None":
    """(trace_id, span_id) or None for absent/garbled/unsampled
    context.  Malformed bytes never raise — a peer's junk must not
    kill the receive path."""
    if len(tc) != TRACEPARENT_LEN or tc[0] != 0:
        return None
    if not tc[25] & _FLAG_SAMPLED:
        return None
    return tc[1:17].hex(), tc[17:25].hex()


def resume(tc: bytes, name: str, component: str = "", **attrs):
    """Continue a remote trace: a context manager whose span is a child
    of the traceparent carried in ``tc``.  Empty/garbled context (or
    tracing disabled) yields the shared no-op."""
    if not _enabled:
        return _NOOP
    parsed = parse_traceparent(tc)
    if parsed is None:
        return _NOOP
    trace_id, parent_id = parsed
    return _Handle(Span(trace_id, parent_id, name, component, attrs))


# -- export ------------------------------------------------------------------


def spans(trace_id: str | None = None) -> list:
    """Finished + still-open spans, optionally filtered by trace.
    Lock-free snapshot: concurrent span create/finish can resize the
    containers mid-copy (RuntimeError), so retry — this runs on debug/
    anomaly paths and must never raise into its caller."""
    for _ in range(8):
        try:
            out = list(_finished)
            out.extend(list(_active.values()))
            break
        except RuntimeError:
            continue
    else:
        out = []
    if trace_id is not None:
        out = [s for s in out if s.trace_id == trace_id]
    return out


def export_chrome(trace_id: str | None = None) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): complete events
    (ph="X", µs clocks) plus thread-name metadata."""
    events = []
    seen_threads = set()
    for s in spans(trace_id):
        ts_us = (s.t0 + _WALL0) * 1e6
        dur_us = (s.dur_s if s.dur_s is not None
                  else time.monotonic() - s.t0) * 1e6
        args = {"trace_id": s.trace_id, "span_id": s.span_id}
        if s.parent_id:
            args["parent_id"] = s.parent_id
        if s.dur_s is None:
            args["open"] = True
        args.update({k: str(v) for k, v in s.attrs.items()})
        events.append({
            "name": s.name,
            "cat": s.component or "span",
            "ph": "X",
            "ts": round(ts_us, 1),
            "dur": round(dur_us, 1),
            "pid": s.pid,
            "tid": s.tid,
            "args": args,
        })
        seen_threads.add((s.pid, s.tid))
    for pid, tid in sorted(seen_threads):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": _thread_names.get(tid, f"thread-{tid}")},
        })
    events.sort(key=lambda e: (e["ph"] == "M", e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- flight recorder ---------------------------------------------------------


def record_log(record: dict) -> None:
    """log.py feeds every emitted record here while tracing is armed
    — the correlation half of the flight recorder."""
    if not _enabled:
        return
    _events.append(dict(record))


def dumps() -> list:
    """Paths of flight-recorder dumps written since the last reset."""
    with _dump_lock:
        return list(_dumps)


def anomaly(kind: str, trace_id: str | None = None, **info) -> str | None:
    """Flight-recorder trigger: snapshot the spans + log records
    correlated with ``trace_id`` (default: the current span's trace;
    falls back to everything recent when no trace is active) and dump
    ONE file.  Returns the dump path, or None when tracing is off.

    Wired triggers: circuit-breaker open (resilience.py), view-change
    start (node.py), sidecar stream desync (sidecar/client.py), round
    SLO overrun (node.py).

    Bounded by construction, three ways: a (kind, trace_id) pair dumps
    at most ONCE per process (a view-change storm re-triggering on the
    same wedged round re-snapshots nothing), dumps of one ``kind`` are
    rate-limited (``dump_cooldown_s``; a flapping breaker cycling open
    must not flood the trigger path or the disk), and total payload
    bytes are capped by ``dump_max_bytes`` (file names additionally
    rotate modulo ``_DUMP_CAP``) — so an anomaly storm can never blow
    out $HARMONY_TPU_TRACE_DIR.  Never raises into the trigger site —
    the triggers sit on the consensus/device fallback paths."""
    if not _enabled:
        return None
    try:
        return _dump_anomaly(kind, trace_id, info)
    except Exception:  # noqa: BLE001 — a broken dump (full disk, odd
        # attrs, concurrent mutation) must never break the breaker /
        # view-change / desync path that fired it
        return None


def _dump_anomaly(kind: str, trace_id: str | None, info: dict):
    global _dump_total, _dump_bytes
    if trace_id is None:
        sp = _current.get()
        trace_id = sp.trace_id if sp is not None else None
    now = time.monotonic()
    with _dump_lock:
        if trace_id is not None and (kind, trace_id) in _dump_seen:
            return None  # this trigger already snapshotted this trace
        last = _dump_last.get(kind)
        if (_dump_cooldown_s > 0 and last is not None
                and now - last < _dump_cooldown_s):
            return None  # this kind dumped recently: suppressed
        if _dump_budget_bytes and _dump_bytes >= _dump_budget_bytes:
            return None  # disk budget spent: suppressed
        _dump_last[kind] = now
        if trace_id is not None:
            _dump_seen.append((kind, trace_id))
        _dump_total += 1
        seq = _dump_total % _DUMP_CAP  # on-disk rotation
    snap_spans = [s.to_dict() for s in spans(trace_id)]
    if trace_id is None:
        logs = list(_events)
    else:
        logs = [r for r in list(_events) if r.get("trace_id") == trace_id]
    payload = {
        "kind": kind,
        "ts": round(time.time(), 3),
        "trace_id": trace_id,
        "info": {k: str(v) for k, v in info.items()},
        "spans": snap_spans,
        "logs": logs,
    }
    directory = (_dump_dir or os.environ.get("HARMONY_TPU_TRACE_DIR")
                 or os.path.join(tempfile.gettempdir(),
                                 "harmony_tpu_flight"))
    path = os.path.join(directory, f"flight_{_PID}_{seq:04d}.json")
    data = json.dumps(payload, separators=(",", ":"), default=str)
    try:
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as f:
            f.write(data)
        with _dump_lock:
            _dump_bytes += len(data)
    except OSError:
        path = None  # unwritable dump dir: the log line below is the
        # fallback record — never raise into the trigger site
        with _dump_lock:
            # roll back the dedup/cooldown reservation: a dump that
            # never reached disk must not suppress the NEXT trigger of
            # the same anomaly once the disk recovers (the dedup entry
            # is permanent, unlike the old 30 s cooldown)
            try:
                _dump_seen.remove((kind, trace_id))
            except ValueError:
                pass
            if _dump_last.get(kind) == now:
                del _dump_last[kind]
    if path is not None:
        with _dump_lock:
            if path in _dumps:
                _dumps.remove(path)  # rotation reused the name
            _dumps.append(path)
            del _dumps[:-_DUMP_CAP]
    from .log import get_logger  # lazy: log.py imports this module

    get_logger("trace").error(
        "flight recorder dump", kind=kind, path=path or "<unwritable>",
        dumped_spans=len(snap_spans), dumped_logs=len(logs),
        **({"anomaly_trace": trace_id} if trace_id else {}),
    )
    return path
