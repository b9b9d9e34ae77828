"""Replay-stage attribution for the staged-sync insert path.

The burn-down from ~31 headers/s (ROADMAP item 3) needs to know which
stage owns the time: fetching+decoding blocks off the wire, the seal
batch-verify, EVM-side execution, or the KV commit.  Each stage site
(sync/staged.py, core/blockchain.py) wraps its work in ``stage()``:

- an observation into ``harmony_replay_stage_seconds{stage}`` —
  always on (one clock pair + one locked histogram add per *batch or
  block*, noise against the work measured), and
- a trace span (``replay.<stage>``) — only while tracing is armed, so
  a forensic trace shows the same burn-down inline with the round
  spans around it.

``snapshot()``/``quantiles_since()`` give the chaos runner per-run
deltas from the cumulative histograms (runs share one process).

The port's copy of the JAX package's ``obs/replay.py``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

from .. import metrics, trace

REPLAY_STAGES = ("wire_decode", "seal_verify", "execute", "kv_commit")

_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
            0.25, 0.5, 1.0, 2.5, 5.0)

REPLAY_STAGE_SECONDS = {
    s: metrics.Histogram(
        "harmony_replay_stage_seconds",
        "Seconds per replay/insert stage unit (wire_decode and "
        "seal_verify per window/segment batch, execute and kv_commit "
        "per block)",
        buckets=_BUCKETS, labels={"stage": s},
    )
    for s in REPLAY_STAGES
}


@contextmanager
def stage(name: str, **attrs):
    """Time one replay-stage unit: histogram always, span when armed."""
    h = REPLAY_STAGE_SECONDS[name]
    sp = trace.span(f"replay.{name}", component="replay", **attrs)
    t0 = time.monotonic()
    with sp:
        try:
            yield
        finally:
            h.observe(time.monotonic() - t0)


def snapshot() -> dict:
    """{stage: (count, sum_s, bucket_counts)} — cumulative state."""
    out = {}
    for s, h in REPLAY_STAGE_SECONDS.items():
        with h._lock:
            out[s] = (h._total, h._sum, tuple(h._counts))
    return out


def quantiles_since(base: dict, qs=(0.5, 0.99)) -> dict:
    """Per-stage quantiles of the observations since ``base`` (a prior
    ``snapshot()``), interpolated from the bucket-count deltas the way
    Histogram.quantile does.  Stages with no new observations are
    omitted — absent metric beats a fabricated zero."""
    out = {}
    for s, h in REPLAY_STAGE_SECONDS.items():
        b_total, b_sum, b_counts = base.get(s, (0, 0.0, ()))
        with h._lock:
            total = h._total - b_total
            sum_s = h._sum - b_sum
            counts = [c - (b_counts[i] if i < len(b_counts) else 0)
                      for i, c in enumerate(h._counts)]
        if total <= 0:
            continue
        res = {"count": total, "sum_s": round(sum_s, 6)}
        for q in qs:
            rank = q * total
            cum, val = 0, None
            for i, c in enumerate(counts):
                cum += c
                if cum >= rank and c > 0:
                    if i >= len(h.buckets):  # +Inf: clamp to last bound
                        val = h.buckets[-1]
                    else:
                        lo = h.buckets[i - 1] if i else 0.0
                        hi = h.buckets[i]
                        val = lo + (hi - lo) * ((rank - (cum - c)) / c)
                    break
            res[f"p{q * 100:g}_s"] = round(val, 6) if val is not None \
                else None
        out[s] = res
    return out
