"""RoundTimeline: partition a committed round's wall time into phases.

A committed ``consensus.round`` trace contains, across leader and
validators (distinguished by the ``node=`` attr trace.py now stamps):

  leader:    consensus.round ─ consensus.phase.announce
             ─ consensus.phase.prepare_quorum ─ consensus.phase.commit_quorum
             ─ consensus.prepare / consensus.commit   (vote receives)
             ─ chain.finalize
  validator: consensus.announce / consensus.prepared  (receives, whose
             bodies verify via sched.enqueue → sched.flush → device)
             ─ chain.finalize (their own commit)

The stitcher projects all of it onto the leader's round interval
``[t0, t0+dur]`` and paints every elementary sub-interval with the
highest-priority phase whose evidence covers it:

  6 commit_insert     leader's chain.finalize (+ the post-commit tail)
  5 verify_dispatch   sched.flush windows (consensus-lane batches;
                      matched by time overlap, NOT trace membership —
                      a coalesced flush parents only to the oldest
                      request's trace) and in-trace device.dispatch
  4 verify_sched_wait enqueue-end → first dispatch window per in-trace
                      consensus-lane sched.enqueue
  3 vote_return       validator receive-span end → the leader's last
                      matching vote receive (PREPARE after announce,
                      COMMIT after prepared)
  2 announce_wire     announce-send start → first validator receive
                      (and the PREPARED broadcast leg likewise)
  1 quorum_assembly   the prepare/commit quorum spans — what's left of
                      them is genuinely the leader waiting for votes
  0 positional base   before the first receive → announce_wire; after
                      the commit quorum → commit_insert; between →
                      quorum_assembly

Priorities 0–1 make the partition total: when the trace is complete,
the attributed fraction is ~1.0 *by construction*, and the per-phase
split is the information.  A torn trace (abandoned round, partition,
missing validator spans) degrades to ``partial=True`` with whatever
phases have evidence — never a crash.

Clock skew: spans merged from sink files of different processes carry
per-process wall clocks.  ``align_clocks`` derives one offset per node
from causal edges (a receive cannot precede its send; a vote-send
cannot follow the leader's last vote-receive), clamps 0 into the
feasible window (monotonic-within-node is preserved — only whole nodes
shift), and build_timelines applies it before painting.

The port's copy of the JAX package's ``obs/timeline.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import metrics

PHASES = ("announce_wire", "verify_sched_wait", "verify_dispatch",
          "vote_return", "quorum_assembly", "commit_insert")

_PRIO = {
    "commit_insert": 6, "verify_dispatch": 5, "verify_sched_wait": 4,
    "vote_return": 3, "announce_wire": 2, "quorum_assembly": 1,
}

_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
            1.0, 2.5, 5.0, 10.0)

ROUND_PHASE_SECONDS = {
    p: metrics.Histogram(
        "harmony_round_phase_seconds",
        "Seconds of committed-round wall time attributed to each "
        "causal phase (one observation per phase per round)",
        buckets=_BUCKETS, labels={"phase": p},
    )
    for p in PHASES
}


@dataclass
class RoundTimeline:
    """One round's phase attribution (seconds per phase)."""

    trace_id: str
    block: int | None
    view: int | None
    leader: str | None
    t0: float
    wall_s: float
    phases: dict = field(default_factory=dict)
    # aggregation-overlay activity inside quorum_assembly, per ladder
    # level ("L1", "L2", ..., summed consensus.aggregation span time)
    levels: dict = field(default_factory=dict)
    partial: bool = False
    committed: bool = True
    nodes: tuple = ()

    def attributed_fraction(self) -> float:
        if self.wall_s <= 0:
            return 0.0
        return min(1.0, sum(self.phases.values()) / self.wall_s)

    def dominant_phase(self) -> str | None:
        if not self.phases:
            return None
        return max(self.phases.items(), key=lambda kv: kv[1])[0]

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "block": self.block,
            "view": self.view,
            "leader": self.leader,
            "wall_s": round(self.wall_s, 6),
            "phases": {p: round(s, 6) for p, s in self.phases.items()},
            "levels": {lv: round(s, 6) for lv, s in self.levels.items()},
            "attributed_fraction": round(self.attributed_fraction(), 4),
            "dominant_phase": self.dominant_phase(),
            "partial": self.partial,
            "committed": self.committed,
            "nodes": list(self.nodes),
        }


def _as_dicts(spans) -> list:
    out = []
    for s in spans:
        if hasattr(s, "to_dict"):
            s = s.to_dict()
        if isinstance(s, dict) and s.get("trace_id"):
            out.append(s)
    return out


def _node_of(s: dict) -> str:
    return s.get("attrs", {}).get("node") or f"pid{s.get('pid')}"


def _end(s: dict) -> float:
    dur = s.get("dur_s")
    return s["ts"] + (dur if dur is not None else 0.0)


# -- clock alignment ---------------------------------------------------------


def align_clocks(spans) -> dict:
    """{node: offset_s} aligning every node onto the leaders' clock.

    For each (leader, validator) pair in each trace the causal edges
    give a feasible offset window for the validator:

      lower:  its announce/prepared receive cannot precede the send
              (``off >= send_ts - recv_ts``)
      upper:  its vote send cannot follow the leader's LAST matching
              vote receive (``off <= last_recv - vote_send_ts``)

    The chosen offset is 0 clamped into [lower, upper] — nodes whose
    clocks already satisfy causality (the in-process localnet, NTP'd
    hosts) are left untouched; only provably-skewed nodes shift, by
    the minimum that restores causality.  Windows from several rounds
    intersect; an empty intersection keeps the lower bound (receive-
    after-send is the harder invariant)."""
    spans = _as_dicts(spans)
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    windows: dict = {}  # node -> [lo, hi]
    for group in by_trace.values():
        rnd = next((s for s in group
                    if s["name"] == "consensus.round"), None)
        if rnd is None:
            continue
        leader = _node_of(rnd)
        ann = next((s for s in group
                    if s["name"] == "consensus.phase.announce"), None)
        prep_q = next(
            (s for s in group
             if s["name"] == "consensus.phase.prepare_quorum"), None)
        sends = {"consensus.announce": ann and ann["ts"],
                 "consensus.prepared": prep_q and _end(prep_q)}
        last_recv = {}
        for s in group:
            if s["name"] in ("consensus.prepare", "consensus.commit") \
                    and _node_of(s) == leader:
                last_recv[s["name"]] = max(
                    last_recv.get(s["name"], s["ts"]), s["ts"])
        pair = {"consensus.announce": "consensus.prepare",
                "consensus.prepared": "consensus.commit"}
        for s in group:
            if s["name"] not in pair:
                continue
            node = _node_of(s)
            if node == leader:
                continue
            w = windows.setdefault(node, [float("-inf"), float("inf")])
            send = sends.get(s["name"])
            if send is not None:
                w[0] = max(w[0], send - s["ts"])
            lr = last_recv.get(pair[s["name"]])
            if lr is not None and s.get("dur_s") is not None:
                w[1] = min(w[1], lr - _end(s))
    out = {}
    for node, (lo, hi) in windows.items():
        if lo <= 0.0 <= hi:
            off = 0.0
        elif lo > hi:
            off = lo  # inconsistent evidence: honour receive-after-send
        else:
            off = lo if lo > 0.0 else hi
        if off:
            out[node] = off
    return out


def _shift(spans: list, offsets: dict) -> list:
    if not offsets:
        return spans
    out = []
    for s in spans:
        off = offsets.get(_node_of(s), 0.0)
        if off:
            s = dict(s)
            s["ts"] = s["ts"] + off
        out.append(s)
    return out


# -- timeline construction ---------------------------------------------------


def _clip(lo: float, hi: float, t0: float, t1: float):
    lo, hi = max(lo, t0), min(hi, t1)
    return (lo, hi) if hi > lo else None


def _paint(intervals: list, t0: float, t1: float) -> dict:
    """Paint [t0, t1] with the highest-priority covering interval per
    elementary segment; returns {phase: seconds}."""
    cuts = {t0, t1}
    for _, lo, hi in intervals:
        if t0 < lo < t1:
            cuts.add(lo)
        if t0 < hi < t1:
            cuts.add(hi)
    edges = sorted(cuts)
    phases: dict = {}
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2.0
        best = None
        for phase, lo, hi in intervals:
            if lo <= mid < hi and (best is None
                                   or _PRIO[phase] > _PRIO[best]):
                best = phase
        if best is not None:
            phases[best] = phases.get(best, 0.0) + (b - a)
    return phases


def _build_one(rnd: dict, group: list, all_spans: list) -> RoundTimeline:
    leader = _node_of(rnd)
    t0 = rnd["ts"]
    dur = rnd.get("dur_s")
    children = [s for s in group if s is not rnd]
    if dur is None:
        ends = [_end(s) for s in children] or [t0]
        t1 = max(max(ends), t0)
    else:
        t1 = t0 + dur
    tl = RoundTimeline(
        trace_id=rnd["trace_id"],
        block=rnd.get("attrs", {}).get("block"),
        view=rnd.get("attrs", {}).get("view"),
        leader=leader, t0=t0, wall_s=t1 - t0,
        committed=not rnd.get("attrs", {}).get("abandoned", False),
        partial=dur is None,
        nodes=tuple(sorted({_node_of(s) for s in group})),
    )
    if t1 <= t0:
        tl.partial = True
        return tl

    def find(name):
        return next((s for s in children if s["name"] == name), None)

    ann = find("consensus.phase.announce")
    prep_q = find("consensus.phase.prepare_quorum")
    commit_q = find("consensus.phase.commit_quorum")
    fins = [s for s in children if s["name"] == "chain.finalize"]
    leader_fin = next((s for s in fins if _node_of(s) == leader),
                      fins[0] if fins else None)
    ann_recvs = sorted(
        (s for s in children if s["name"] == "consensus.announce"),
        key=lambda s: s["ts"])
    prepd_recvs = sorted(
        (s for s in children if s["name"] == "consensus.prepared"),
        key=lambda s: s["ts"])
    prepare_recvs = [s for s in children
                     if s["name"] == "consensus.prepare"
                     and _node_of(s) == leader]
    commit_recvs = [s for s in children
                    if s["name"] == "consensus.commit"
                    and _node_of(s) == leader]

    iv = []  # (phase, lo, hi)

    def add(phase, lo, hi):
        c = _clip(lo, hi, t0, t1)
        if c:
            iv.append((phase, c[0], c[1]))

    # 6 commit_insert: the leader's chain insert, plus everything after
    # the commit quorum closed (COMMITTED broadcast + bookkeeping tail)
    if leader_fin is not None:
        add("commit_insert", leader_fin["ts"], _end(leader_fin))
    tail_from = None
    if commit_q is not None and commit_q.get("dur_s") is not None:
        tail_from = _end(commit_q)
    elif leader_fin is not None:
        tail_from = leader_fin["ts"]
    if tail_from is not None:
        add("commit_insert", tail_from, t1)

    # 5 verify_dispatch: consensus-lane flush windows by time overlap
    # (any trace — coalescing re-parents them), in-trace device spans
    dispatch_iv = []
    for s in all_spans:
        if s["name"] == "sched.flush" \
                and s.get("attrs", {}).get("kind") != "backend" \
                and s.get("dur_s") is not None:
            c = _clip(s["ts"], _end(s), t0, t1)
            if c:
                dispatch_iv.append(c)
    for s in children:
        if s["name"] == "device.dispatch" and s.get("dur_s") is not None:
            c = _clip(s["ts"], _end(s), t0, t1)
            if c:
                dispatch_iv.append(c)
    for lo, hi in dispatch_iv:
        add("verify_dispatch", lo, hi)

    # 4 verify_sched_wait: enqueue end -> first dispatch window start
    starts = sorted(lo for lo, _ in dispatch_iv)
    for s in children:
        if s["name"] != "sched.enqueue":
            continue
        if s.get("attrs", {}).get("lane") not in (None, "consensus"):
            continue
        e = _end(s)
        d = next((lo for lo in starts if lo >= e), None)
        if d is not None:
            add("verify_sched_wait", e, d)

    # 3 vote_return: validator receive-span end -> leader's last
    # matching vote receive
    if prepare_recvs:
        last_prep = max(s["ts"] for s in prepare_recvs)
        for a in ann_recvs:
            if a.get("dur_s") is not None:
                add("vote_return", _end(a), last_prep)
    if commit_recvs:
        last_commit = max(s["ts"] for s in commit_recvs)
        for p in prepd_recvs:
            if p.get("dur_s") is not None:
                add("vote_return", _end(p), last_commit)

    # 2 announce_wire: send start -> first receive, both broadcast legs
    first_recv = None
    if ann is not None:
        first_recv = ann_recvs[0]["ts"] if ann_recvs else _end(ann)
        add("announce_wire", ann["ts"], first_recv)
    if prep_q is not None and prep_q.get("dur_s") is not None \
            and prepd_recvs:
        add("announce_wire", _end(prep_q), prepd_recvs[0]["ts"])

    # 1 quorum_assembly: the leader's quorum-wait windows
    for q in (prep_q, commit_q):
        if q is not None:
            add("quorum_assembly", q["ts"], _end(q))

    # aggregation overlay activity: consensus.aggregation
    # spans — verify/merge/emit ticks of the Handel ladder — belong to
    # quorum_assembly by definition, and their ``level`` attr breaks
    # that phase down per ladder rung (round_forensics' per-level rows)
    for s in children:
        if s["name"] != "consensus.aggregation" \
                or s.get("dur_s") is None:
            continue
        c = _clip(s["ts"], _end(s), t0, t1)
        if c is None:
            continue
        add("quorum_assembly", c[0], c[1])
        lvl = s.get("attrs", {}).get("level")
        key = f"L{lvl}" if lvl is not None else "L?"
        tl.levels[key] = tl.levels.get(key, 0.0) + (c[1] - c[0])

    # 0 positional base: makes the partition total on complete traces
    complete = (ann is not None and prep_q is not None
                and (commit_q is not None or leader_fin is not None))
    if complete:
        base_recv = first_recv if first_recv is not None else t0
        # reuse the lowest evidence priorities for the base layer: a
        # tiny epsilon below via ordering is unnecessary since _paint
        # prefers higher priority regardless of insertion order
        add("announce_wire", t0, base_recv)
        until = tail_from if tail_from is not None else t1
        add("quorum_assembly", base_recv, until)
    else:
        tl.partial = True

    tl.phases = _paint(iv, t0, t1)
    return tl


def build_timelines(spans, committed_only: bool = True,
                    skew_align: bool = True) -> list:
    """RoundTimelines for every ``consensus.round`` trace in ``spans``
    (trace store contents, sink dicts, or a mix).  Multi-process merges
    are offset-aligned first (``align_clocks``) when requested."""
    spans = _as_dicts(spans)
    if skew_align and len({s.get("pid") for s in spans}) > 1:
        spans = _shift(spans, align_clocks(spans))
    by_trace: dict = {}
    for s in spans:
        by_trace.setdefault(s["trace_id"], []).append(s)
    out = []
    for group in by_trace.values():
        rnd = next((s for s in group
                    if s["name"] == "consensus.round"), None)
        if rnd is None:
            continue
        tl = _build_one(rnd, group, spans)
        if committed_only and not tl.committed:
            continue
        out.append(tl)
    out.sort(key=lambda t: t.t0)
    return out


def observe_timelines(timelines) -> dict:
    """Feed ``harmony_round_phase_seconds`` from built timelines and
    return per-phase aggregate seconds (runner/CLI summary)."""
    agg = {p: 0.0 for p in PHASES}
    n = 0
    for tl in timelines:
        if not tl.committed:
            continue
        n += 1
        for p, s in tl.phases.items():
            ROUND_PHASE_SECONDS[p].observe(s)
            agg[p] += s
    return {"rounds": n,
            "phase_seconds": {p: round(v, 6) for p, v in agg.items()
                              if v > 0}}
