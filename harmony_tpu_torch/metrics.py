"""Metrics: counters/gauges/histograms with Prometheus text exposition.

The role of the reference's prometheus service (reference:
api/service/prometheus/service.go:91-120 — a registry served over
HTTP /metrics).  The port's copy of the JAX package's ``metrics.py``,
stdlib only: the primitives (``LockedCounters``, ``Counter``, ``Gauge``,
``Histogram``), ``process_sample``, ``Registry`` and ``MetricsServer``.

``Registry.expose`` renders the same families as the JAX package's:
device, resilience, sched, p2p, slash, process, health, governor, prof,
aot, snapshot, and once their modules are imported the netem family of
``chaostest/netem.py`` and the round-phase and replay-stage histograms
of ``obs/{timeline,replay}.py``.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import trace as _TR  # stdlib-only; log.py already imports it


def process_sample() -> dict:
    """Live process resources, stdlib-only (no psutil): RSS and thread
    count from ``/proc/self/status``, open fds from ``/proc/self/fd``.
    Platforms without procfs degrade per-signal to the best stdlib
    fallback (``resource`` high-water RSS, ``threading`` count) or
    ``None`` — a missing signal is simply not judged/exposed."""
    rss = threads = fds = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                elif line.startswith("Threads:"):
                    threads = int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    if rss is None:
        try:
            import resource
            import sys

            # high-water mark, not current — an honest degraded
            # signal.  ru_maxrss units differ by platform: bytes on
            # macOS, KiB elsewhere — and this branch only RUNS where
            # procfs is absent, so the Linux KiB convention must not
            # be hardcoded (a 1024x-inflated RSS would pin the
            # governor at CRITICAL forever)
            raw = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            rss = raw if sys.platform == "darwin" else raw * 1024
        except (ImportError, OSError, ValueError):
            rss = None
    if threads is None:
        threads = threading.active_count()
    try:
        fds = len(os.listdir("/proc/self/fd"))
    except OSError:
        fds = None
    return {"rss_bytes": rss, "open_fds": fds, "threads": threads}


class LockedCounters:
    """Named monotonic counters behind one lock, with a read-only
    dict-like surface (``x["verify"]``, ``dict(x)``, ``.items()``).

    Replaces the bare ``COUNTERS[kind] += 1`` module dict in
    device.py: that read-modify-write raced the consensus, view-change
    and replay threads and lived as three pinned GL03 findings.  One
    uncontended lock per *signature check* (not per signature) is
    noise against the pairing work it counts."""

    def __init__(self, *names: str):
        self._lock = threading.Lock()
        self._v: dict[str, int] = {n: 0 for n in names}

    def inc(self, name: str, amount: int = 1) -> None:
        with self._lock:
            self._v[name] = self._v.get(name, 0) + amount

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._v.get(name, 0)

    def __setitem__(self, name: str, value: int) -> None:
        # tests pin counters to known values around a scenario
        with self._lock:
            self._v[name] = int(value)

    def keys(self):
        with self._lock:
            return list(self._v)

    def items(self):
        with self._lock:
            return sorted(self._v.items())

    def __iter__(self):
        return iter(self.keys())


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        # locked like inc/expose: the bare dict read raced concurrent
        # first-inc inserts (dict resize mid-read) on the consensus
        # threads; Gauge inherits this read too
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum across every label combination (delta accounting over
        a whole family — e.g. governor rejections per run)."""
        with self._lock:
            return sum(self._values.values())

    def expose(self) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                lines.append(
                    f"{self.name}{_fmt_labels(dict(key))} {v:g}"
                )
        return "\n".join(lines)


class Gauge(Counter):
    def set(self, value: float, **labels):
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._values[key] = float(value)

    def expose(self) -> str:
        return super().expose().replace(" counter", " gauge", 1)


class Histogram:
    DEFAULT_BUCKETS = (
        0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
    )

    def __init__(self, name: str, help_: str = "", buckets=None,
                 labels: dict | None = None):
        """``labels``: constant label set stamped on every sample line
        (the scheduler keeps one Histogram per lane under one family
        name this way — the module has no dynamic label indexing)."""
        self.name, self.help = name, help_
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self.labels = dict(labels or {})
        self._counts = [0] * (len(self.buckets) + 1)
        # bucket index -> (trace_id, value): the LAST traced
        # observation that landed in each bucket — bounded by the
        # bucket count, so a p99 outlier links straight to the trace
        # that produced it (OpenMetrics exemplars)
        self._exemplars: dict = {}
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float):
        ids = _TR.current_ids()  # None unless tracing is armed
        with self._lock:
            self._sum += value
            self._total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    if ids is not None:
                        self._exemplars[i] = (ids[0], value)
                    return
            self._counts[-1] += 1
            if ids is not None:
                self._exemplars[len(self.buckets)] = (ids[0], value)

    def quantile(self, q: float) -> float | None:
        """Estimated q-quantile (0 <= q <= 1) from the bucket counts —
        Prometheus histogram_quantile semantics: find the bucket the
        rank lands in, interpolate linearly inside it.  The +Inf bucket
        clamps to the last finite bound (the standard overestimate-free
        convention).  None while the histogram is empty.

        This is the helper that lets loadgen/bench report p99 without
        hand-parsing bucket counts."""
        with self._lock:
            counts = list(self._counts)
            total = self._total
        if total == 0:
            return None
        q = min(1.0, max(0.0, q))
        rank = q * total
        cum = 0
        for i, b in enumerate(self.buckets):
            prev_cum, cum = cum, cum + counts[i]
            if cum >= rank and counts[i]:
                lo = self.buckets[i - 1] if i else 0.0
                frac = (rank - prev_cum) / counts[i]
                return lo + (b - lo) * frac
        return float(self.buckets[-1])

    def summary(self, quantiles=(0.5, 0.99)) -> dict:
        """{count, sum_s, p50_s, p99_s, ...} — the report-ready digest
        (keys follow ``p{percent}_s`` for each requested quantile)."""
        with self._lock:
            total, sum_ = self._total, self._sum
        out = {"count": total, "sum_s": round(sum_, 6)}
        for q in quantiles:
            v = self.quantile(q)
            key = f"p{q * 100:g}_s"
            out[key] = round(v, 6) if v is not None else None
        return out

    @staticmethod
    def _exemplar_suffix(ex) -> str:
        """OpenMetrics exemplar: ``# {trace_id="…"} value`` appended to
        a _bucket sample — the p99 bucket links to its forensic trace."""
        if ex is None:
            return ""
        trace_id, value = ex
        return f' # {{trace_id="{trace_id}"}} {value:g}'

    def expose(self, exemplars: bool = False) -> str:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} histogram"]
        base = _fmt_labels(self.labels)
        with self._lock:
            exs = dict(self._exemplars) if exemplars else {}
            cum = 0
            for i, (b, c) in enumerate(zip(self.buckets, self._counts)):
                cum += c
                lines.append(
                    f"{self.name}_bucket"
                    f"{_fmt_labels({**self.labels, 'le': f'{b:g}'})} {cum}"
                    f"{self._exemplar_suffix(exs.get(i))}"
                )
            cum += self._counts[-1]
            lines.append(
                f"{self.name}_bucket"
                f"{_fmt_labels({**self.labels, 'le': '+Inf'})} {cum}"
                f"{self._exemplar_suffix(exs.get(len(self.buckets)))}"
            )
            lines.append(f"{self.name}_sum{base} {self._sum:g}")
            lines.append(f"{self.name}_count{base} {self._total}")
        return "\n".join(lines)


class Registry:
    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_make(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_make(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "",
                  buckets=None) -> Histogram:
        return self._get_or_make(
            name, lambda: Histogram(name, help_, buckets)
        )

    def _get_or_make(self, name, factory):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            return m

    def expose(self, exemplars: bool = False) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines = [m.expose(exemplars=exemplars)
                 if isinstance(m, Histogram) else m.expose()
                 for m in metrics]
        lines.append(self._device_counters())
        lines.append(self._resilience_counters())
        lines.append(self._sched_counters())
        lines.append(self._p2p_counters())
        lines.append(self._slash_counters())
        netem = self._netem_counters()
        if netem:
            lines.append(netem)
        lines.append(self._process_gauges())
        lines.append(self._health_metrics())
        lines.append(self._governor_metrics())
        prof = self._prof_counters()
        if prof:
            lines.append(prof)
        lines.append(self._aot_counters())
        lines.append(self._snapshot_counters())
        obs = self._obs_counters(exemplars)
        if obs:
            lines.append(obs)
        return "\n".join(lines) + "\n"

    @staticmethod
    def _obs_counters(exemplars: bool = False) -> str:
        """Round-forensics families (obs module singletons) — only
        when the obs package was ever imported (it always is on a full
        node via the chain insert path; pure-metrics tests stay lean)."""
        import sys

        mod = sys.modules.get("harmony_tpu_torch.obs")
        if mod is None:
            return ""
        return mod.expose_metrics(exemplars=exemplars)

    @staticmethod
    def _process_gauges() -> str:
        """Process resource gauges from /proc/self: the raw signals the
        resource governor tiers on, scrapeable even where no governor is
        armed."""
        s = process_sample()
        names = {
            "rss_bytes": (
                "harmony_process_rss_bytes",
                "resident set size of this process",
            ),
            "open_fds": (
                "harmony_process_open_fds",
                "open file descriptors of this process",
            ),
            "threads": (
                "harmony_process_threads",
                "live threads of this process",
            ),
        }
        out = []
        for key, (name, help_) in names.items():
            v = s.get(key)
            if v is None:
                continue  # signal unavailable on this platform
            out.append(f"# HELP {name} {help_}\n"
                       f"# TYPE {name} gauge\n"
                       f"{name} {v}")
        return "\n".join(out)

    @staticmethod
    def _health_metrics() -> str:
        """Watchdog liveness families (health module singletons)."""
        from . import health as HL

        return HL.expose()

    @staticmethod
    def _governor_metrics() -> str:
        """Resource-governor families (governor module singletons)."""
        from . import governor as GV

        return GV.expose()

    @staticmethod
    def _netem_counters() -> str:
        """Link-conditioning families (chaostest.netem singletons) —
        only when the netem module was ever imported: production
        exposition must not pull the chaos framework in."""
        import sys

        mod = sys.modules.get("harmony_tpu_torch.chaostest.netem")
        if mod is None:
            return ""
        return mod.expose()

    @staticmethod
    def _p2p_counters() -> str:
        """Hostile-wire defense surface (p2p.host module singletons):
        invalid-message verdicts per transport, the throttle/drop/ban
        ladder, and the worst live per-peer score per host."""
        from .p2p import host as PH

        out = [
            "# HELP harmony_p2p_invalid_messages_total invalid-message "
            "events by kind (REJECT verdicts, throttles, drops, bans)",
            "# TYPE harmony_p2p_invalid_messages_total counter",
        ]
        for kind, v in PH.P2P_COUNTERS.items():
            out.append(
                f'harmony_p2p_invalid_messages_total{{kind="{kind}"}} {v}'
            )
        out.append(
            "# HELP harmony_p2p_peer_score worst per-peer gossip "
            "score observed at each host since process start "
            "(a low-water mark, not a live reading)\n"
            "# TYPE harmony_p2p_peer_score gauge"
        )
        for host_name, score in sorted(PH.worst_peer_scores().items()):
            out.append(
                f'harmony_p2p_peer_score{{host="{host_name}"}} {score:g}'
            )
        out.append(PH.INBOUND_VOTES.expose())
        return "\n".join(out)

    @staticmethod
    def _slash_counters() -> str:
        """Double-sign slashing pipeline (staking.slash module
        singletons): detected -> gossiped -> queued -> included ->
        verified -> applied event counts plus the atto amounts moved."""
        from .staking import slash as SL

        out = [
            "# HELP harmony_slash_events_total slashing pipeline "
            "events by stage",
            "# TYPE harmony_slash_events_total counter",
        ]
        for kind, v in SL.COUNTERS.items():
            out.append(
                f'harmony_slash_events_total{{stage="{kind}"}} {v}'
            )
        out.append(
            "# HELP harmony_slash_amount_atto_total atto slashed from "
            "offenders / rewarded to reporters\n"
            "# TYPE harmony_slash_amount_atto_total counter"
        )
        for kind, v in SL.AMOUNTS.items():
            out.append(
                f'harmony_slash_amount_atto_total{{kind="{kind}"}} {v}'
            )
        return "\n".join(out)

    @staticmethod
    def _snapshot_counters() -> str:
        """Snapshot serve/bootstrap families (p2p.stream and
        sync.staged module singletons): late-join bootstrap attempts by
        outcome, account bytes installed, and responses served to
        joining peers — the
        operator's answer to 'did the late joiner take the fast path,
        and who is feeding it?'."""
        from .p2p import stream as PS
        from .sync import staged as SS

        return "\n".join([
            SS.SNAPSHOT_BOOTSTRAPS.expose(),
            SS.SNAPSHOT_BYTES.expose(),
            PS.SNAPSHOT_SERVED.expose(),
        ])

    @staticmethod
    def _device_counters() -> str:
        """Device-path families (``device.expose_metrics``): checks by
        kind, the twin switch, dispatch latency, transfer bytes and the
        program shapes seen — a run can ASSERT over HTTP that quorum
        checks executed on the device path."""
        from . import device as DV

        return DV.expose_metrics()

    @staticmethod
    def _sched_counters() -> str:
        """Verification-scheduler families (queue depth, per-lane wait,
        batch fill ratio, sheds)."""
        from . import sched

        return sched.expose_metrics()

    @staticmethod
    def _aot_counters() -> str:
        """Warmup families (aot module singletons): failed programs by
        reason and kernel-library cache traffic (hit/miss/store/corrupt/
        skew) — the operator's answer to 'did warmup actually warm?'."""
        from . import aot

        return aot.expose()

    @staticmethod
    def _prof_counters() -> str:
        """Kernel-stage profiler families (stage/execute/first-dispatch
        histograms, per-program cost gauges) — empty until the profiler
        has recorded anything."""
        from . import prof

        return prof.expose()

    @staticmethod
    def _resilience_counters() -> str:
        """Circuit-breaker lifecycle (resilience.TRANSITIONS): lets a run
        ASSERT over HTTP that the node NOTICED a flapping backend
        (open/half_open/close) instead of silently degrading."""
        from . import resilience as RS

        out = [
            "# HELP harmony_resilience_events_total circuit-breaker "
            "transitions and rejected dispatches",
            "# TYPE harmony_resilience_events_total counter",
        ]
        for key, v in RS.TRANSITIONS.items():
            breaker, _, event = key.partition(":")
            out.append(
                "harmony_resilience_events_total"
                f'{{breaker="{breaker}",event="{event}"}} {v}'
            )
        return "\n".join(out)


class MetricsServer:
    """The node's always-on debug listener: GET /metrics (Prometheus
    text), /healthz + /readyz (JSON watchdog/governor verdicts with
    200/503 semantics — the orchestrator probes), /debug/pprof/*
    (mounted from pprof.py), and /debug/trace (Chrome trace-event JSON
    from the span tracer's bounded store — load it in Perfetto).  Binds
    127.0.0.1."""

    def __init__(self, registry: Registry, port: int = 0):
        outer_registry = registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                params = dict(
                    kv.split("=", 1)
                    for kv in query.split("&") if "=" in kv
                )
                status = 200
                try:
                    if path == "/metrics":
                        # ?exemplars=1 opts into the OpenMetrics
                        # trace-id exemplar suffix; the default stays
                        # plain Prometheus 0.0.4 text
                        data = outer_registry.expose(
                            exemplars=params.get("exemplars") == "1"
                        ).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/healthz":
                        # per-subsystem watchdog verdicts; 503 when any
                        # CRITICAL participant is wedged or dead — the
                        # orchestrator's liveness probe
                        from . import health as HL

                        verdict = HL.verdicts()
                        data = json.dumps(verdict).encode()
                        ctype = "application/json"
                        status = 200 if verdict["ok"] else 503
                    elif path == "/readyz":
                        # liveness AND the governor below its CRITICAL
                        # shed tier — the load balancer's traffic gate
                        from . import health as HL

                        verdict = HL.readiness()
                        data = json.dumps(verdict).encode()
                        ctype = "application/json"
                        status = 200 if verdict["ready"] else 503
                    elif path == "/debug/trace":
                        from . import trace as TR

                        data = json.dumps(
                            TR.export_chrome(params.get("trace_id"))
                        ).encode()
                        ctype = "application/json"
                    elif path.startswith("/debug/pprof"):
                        from . import pprof as PP

                        body = PP.handle(path, params)
                        if body is None:
                            self.send_response(404)
                            self.end_headers()
                            return
                        data = body.encode()
                        ctype = "text/plain; charset=utf-8"
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                except Exception as e:  # noqa: BLE001 — debug surface
                    self.send_error(500, str(e))
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        # shutdown() BLOCKS FOREVER if serve_forever never ran — guard
        # so stopping a constructed-but-never-started server is a no-op
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
