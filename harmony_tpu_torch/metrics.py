"""Metrics primitives: counters, gauges and histograms with Prometheus
text exposition.

The port's copy of the JAX package's ``metrics.py`` primitives
(``LockedCounters``, ``Counter``, ``Gauge``, ``Histogram``), stdlib only.
The scheduler (``sched.expose_metrics``), the profiler and ``device.py``
render their families through them.  The registry that serves them over
HTTP (``Registry``, ``MetricsServer``) is not ported yet: it reaches
modules of the node that the port does not have.
"""

from __future__ import annotations

import threading

from . import trace as _TR  # stdlib-only; log.py already imports it


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
