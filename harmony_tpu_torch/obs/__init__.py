"""Round forensics: causal phase attribution for committed rounds.

trace.py records *what happened* (spans with node attribution, a
traceparent crossing the consensus wire); this package answers *where
the time went*:

- ``sink``   — durable per-node JSONL span export (bounded, rotating,
  async writer with a watchdog heartbeat) so traces survive restarts
  and merge across real multi-process nodes.
- ``timeline`` — ``RoundTimeline`` reconstruction: a committed
  ``consensus.round`` trace partitioned into named phases
  (announce_wire, verify_sched_wait, verify_dispatch, vote_return,
  quorum_assembly, commit_insert), feeding the
  ``harmony_round_phase_seconds{phase}`` histograms.
- ``replay`` — stage attribution for the staged-sync insert path
  (wire_decode → seal_verify → execute → kv_commit), feeding
  ``harmony_replay_stage_seconds{stage}``.

Consumers: the metrics server's Prometheus exposition and
``chip_smoke.py``'s boot phase, which splits the committed rounds of
four node processes from their sink files.

Stdlib-only, like trace.py: importable from every layer.

The port's copy of the JAX package's ``obs/__init__.py``.
"""

from __future__ import annotations

from .replay import REPLAY_STAGE_SECONDS, REPLAY_STAGES, stage  # noqa: F401
from .sink import SpanSink, read_spans  # noqa: F401
from .timeline import (  # noqa: F401
    PHASES,
    ROUND_PHASE_SECONDS,
    RoundTimeline,
    align_clocks,
    build_timelines,
    observe_timelines,
)


def _expose_family(family: dict, exemplars: bool = False) -> str:
    """One exposition block for a {label: Histogram} family sharing a
    metric name: first member carries the # HELP/# TYPE header, the
    rest contribute sample lines only (the sched per-lane idiom)."""
    parts = []
    for i, h in enumerate(family.values()):
        lines = h.expose(exemplars=exemplars).split("\n")
        parts.extend(lines if i == 0 else lines[2:])
    return "\n".join(parts)


def expose_metrics(exemplars: bool = False) -> str:
    """Prometheus text for both forensic histogram families (wired
    into metrics.Registry.expose as a static section)."""
    return "\n".join((
        _expose_family(ROUND_PHASE_SECONDS, exemplars),
        _expose_family(REPLAY_STAGE_SECONDS, exemplars),
    ))
