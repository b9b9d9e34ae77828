"""WAN-realistic network emulation: per-directed-link conditioning.

Every fault the chaos layer could express before this module was
binary — a node alive or killed, a link up or black-holed — delivered
over an ideal zero-latency in-process hub.  Real committee-based
consensus fails in the gray zone: WAN message delay dominates round
latency (arXiv:2302.00418), and slow/lossy/asymmetric links — not
clean crashes — are the common case at scale (Handel,
arXiv:1906.05132).  :class:`NetEm` is the ``tc netem`` of the chaos
framework: a seed-deterministic conditioner for DIRECTED links
(``A->B`` and ``B->A`` condition independently) supporting

* latency: a fixed one-way ``delay_ms`` plus uniform ``jitter_ms``, or
  a per-pair ``rtt_ms=(lo, hi)`` range — each concrete (src, dst) pair
  draws a stable base RTT from the range keyed on (seed, src, dst),
  the WAN-matrix shape (50–150 ms RTT across a real committee);
* ``loss`` probability per message (``loss=1.0`` IS the old binary
  partition — ``Phase.partition`` is now a special case of link
  rules);
* ``dup`` probability (the duplicate gets its own jitter draw, so it
  may overtake the original);
* ``reorder`` probability (tc semantics: a reordered message skips
  the latency queue and jumps ahead of in-flight earlier traffic);
* ``rate_bytes_per_s`` bandwidth cap (store-and-forward queuing: each
  message holds the link for size/rate and queues behind the
  previous one).

Determinism: every stochastic draw is ``sha256(seed | src | dst |
per-link-seq | purpose)`` — the same seed and the same script of
(src, dst, size) events produce a byte-identical delivery schedule
(drop set, delays, duplicate count, reorder flags) regardless of
thread timing; ``tests/test_netem.py`` pins this.  Wall-clock
execution of the schedule rides one lazily-started delivery thread
(a heap ordered by due time); decisions that need no conditioning
(no matching rule, or a zero-delay single copy) stay on the caller's
thread, so a disarmed conditioner costs one ``is None`` check at the
transport and an armed-but-non-matching one costs two dict lookups.

Installed at BOTH transports (p2p/host.py): the in-process hub's
delivery chokepoint (``InProcessNetwork.route`` → ``_deliver_one``)
and the TCPHost publish path (``_mesh_push``).  Observability:
``harmony_netem_events_total{rule,event}`` — delayed / dropped /
duplicated / reordered per link rule, cardinality-bounded (the rule
label is the conditioning rule's ``src->dst``, never the concrete
peer pair, so a big committee cannot explode the label space).

The link-rule grammar, matching precedence and determinism scheme are
documented in docs/ANALYSIS.md ("Network degradation model").

The port's copy of the JAX package's ``chaostest/netem.py``.
"""

from __future__ import annotations

import hashlib
import heapq
import threading
import time
from dataclasses import dataclass, replace

from ..log import get_logger

_log = get_logger("netem")

# module-level per-rule event counters for /metrics exposition
# (instances also count locally for scenario deltas); bounded — past
# the cap new rule labels aggregate under "other"
_MLOCK = threading.Lock()
_MCOUNTS: dict[tuple, int] = {}  # (rule_label, event) -> count
_MLABELS: set = set()            # distinct rule labels seen (bound)
_MAX_RULE_LABELS = 64
EVENTS = ("delayed", "dropped", "duplicated", "reordered")


def _mcount(label: str, event: str, n: int = 1) -> None:
    with _MLOCK:
        if label not in _MLABELS:
            if len(_MLABELS) >= _MAX_RULE_LABELS:
                label = "other"
            _MLABELS.add(label)
        key = (label, event)
        _MCOUNTS[key] = _MCOUNTS.get(key, 0) + n


def expose() -> str:
    """Prometheus families (metrics.Registry pulls this lazily — only
    when this module was ever imported)."""
    out = [
        "# HELP harmony_netem_events_total link-conditioning events "
        "per netem rule (delayed/dropped/duplicated/reordered)",
        "# TYPE harmony_netem_events_total counter",
    ]
    with _MLOCK:
        items = sorted(_MCOUNTS.items())
    for (label, event), v in items:
        out.append(
            "harmony_netem_events_total"
            f'{{event="{event}",rule="{label}"}} {v}'
        )
    return "\n".join(out)


@dataclass(frozen=True)
class LinkRule:
    """One directed-link conditioning rule.  ``src``/``dst`` are host
    names or ``"*"``; the most specific matching rule wins (exact pair
    > src-bound > dst-bound > wildcard; later-installed wins ties).
    Probabilities are [0, 1]; delays are milliseconds; ``rtt_ms``
    (lo, hi) replaces ``delay_ms`` with a per-(src, dst) stable
    one-way base delay of U(lo, hi)/2."""

    src: str = "*"
    dst: str = "*"
    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    loss: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    rate_bytes_per_s: float = 0.0  # 0 = uncapped
    rtt_ms: tuple | None = None    # (lo_ms, hi_ms)
    tag: str = ""                  # install group (phase heal removes)

    def __post_init__(self):
        for name in ("loss", "dup", "reorder"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"netem {name}={v!r} outside [0, 1]")
        for name in ("delay_ms", "jitter_ms", "rate_bytes_per_s"):
            if getattr(self, name) < 0.0:
                raise ValueError(f"netem {name} must be >= 0")
        if self.rtt_ms is not None:
            lo, hi = self.rtt_ms
            if lo < 0 or hi < lo:
                raise ValueError(f"netem rtt_ms range {self.rtt_ms!r}")
        if not self.src or not self.dst:
            raise ValueError("netem src/dst must be non-empty")

    @property
    def label(self) -> str:
        return f"{self.src}->{self.dst}"

    @property
    def specificity(self) -> int:
        return (2 if self.src != "*" else 0) + (
            1 if self.dst != "*" else 0
        )


def _parse_ms(text: str, key: str) -> float:
    t = text.strip().lower()
    for unit, scale in (("ms", 1.0), ("s", 1000.0)):
        if t.endswith(unit):
            t = t[: -len(unit)]
            break
    else:
        scale = 1.0  # bare number = milliseconds
    try:
        return float(t) * scale
    except ValueError:
        raise ValueError(f"netem {key}: bad duration {text!r}") from None


def _parse_prob(text: str, key: str) -> float:
    t = text.strip()
    try:
        if t.endswith("%"):
            return float(t[:-1]) / 100.0
        return float(t)
    except ValueError:
        raise ValueError(f"netem {key}: bad probability {text!r}") from None


def _parse_rate(text: str) -> float:
    t = text.strip().lower()
    for suffix in ("bps", "b/s"):
        if t.endswith(suffix):
            t = t[: -len(suffix)]
            break
    mult = 1.0
    if t and t[-1] in ("k", "m"):
        mult = {"k": 1e3, "m": 1e6}[t[-1]]
        t = t[:-1]
    try:
        return float(t) * mult
    except ValueError:
        raise ValueError(f"netem rate: bad rate {text!r}") from None


def parse_link(spec, tag: str = "") -> LinkRule:
    """Build a :class:`LinkRule` from a dict (``LinkRule`` field
    names) or the string grammar::

        "src->dst delay=300ms jitter=50ms loss=5% dup=1% \
reorder=10% rate=1mbps rtt=50..150ms"

    ``*`` wildcards either side; probabilities accept ``5%`` or
    ``0.05``; durations accept ``ms``/``s`` suffixes (bare = ms);
    rates accept ``k``/``m`` + ``bps`` suffixes (bare = bytes/s).
    Malformed specs raise ``ValueError`` naming the offending field.
    """
    if isinstance(spec, LinkRule):
        return replace(spec, tag=tag) if tag and not spec.tag else spec
    if isinstance(spec, dict):
        d = dict(spec)
        if "rtt_ms" in d and d["rtt_ms"] is not None:
            d["rtt_ms"] = tuple(float(x) for x in d["rtt_ms"])
        d.setdefault("tag", tag)
        try:
            return LinkRule(**d)
        except TypeError as e:
            raise ValueError(f"netem link spec: {e}") from None
    if not isinstance(spec, str):
        raise ValueError(f"netem link spec of type {type(spec).__name__}")
    parts = spec.split()
    if not parts or "->" not in parts[0]:
        raise ValueError(
            f"netem link spec {spec!r}: want 'src->dst key=value ...'"
        )
    src, _, dst = parts[0].partition("->")
    kw: dict = {"src": src.strip() or "*", "dst": dst.strip() or "*",
                "tag": tag}
    for part in parts[1:]:
        key, eq, val = part.partition("=")
        if not eq:
            raise ValueError(f"netem link spec: bare token {part!r}")
        key = key.strip().lower()
        if key == "delay":
            kw["delay_ms"] = _parse_ms(val, key)
        elif key == "jitter":
            kw["jitter_ms"] = _parse_ms(val, key)
        elif key in ("loss", "dup", "reorder"):
            kw[key] = _parse_prob(val, key)
        elif key == "rate":
            kw["rate_bytes_per_s"] = _parse_rate(val)
        elif key == "rtt":
            lo, sep, hi = val.partition("..")
            if not sep:
                raise ValueError(
                    f"netem rtt: want 'lo..hi[ms]', got {val!r}"
                )
            kw["rtt_ms"] = (_parse_ms(lo, key), _parse_ms(hi, key))
        else:
            raise ValueError(f"netem link spec: unknown key {key!r}")
    return LinkRule(**kw)


def partition_rules(name: str, tag: str = "") -> list:
    """The old binary partition as link rules: total loss on every
    link into AND out of ``name`` — exactly what
    ``InProcessNetwork.partitioned`` used to hard-code."""
    return [
        LinkRule(src=name, dst="*", loss=1.0, tag=tag),
        LinkRule(src="*", dst=name, loss=1.0, tag=tag),
    ]


@dataclass(frozen=True)
class Decision:
    """The conditioning verdict for one message on one directed link.
    ``delays`` holds one entry per scheduled copy (len 2 = duplicated);
    a dropped message has none."""

    rule: LinkRule
    drop: bool = False
    delays: tuple = ()
    reordered: bool = False


class NetEm:
    """Seed-deterministic link conditioner + delivery scheduler.

    Thread-safe; one instance per network under test (the chaos
    runner builds one per scenario seeded from the scenario)."""

    def __init__(self, seed: int = 0, clock=time.monotonic):
        self.seed = int(seed)
        self._clock = clock
        self._lock = threading.Lock()
        self._rules: list[LinkRule] = []
        self._seq: dict[tuple, int] = {}        # (src,dst) -> next seq
        self._link_free: dict[tuple, float] = {}  # rate-cap queue tail
        self.counts: dict[tuple, int] = {}      # (label, event) -> n
        self.ever_armed = False
        # delivery scheduler (lazy: never spawned while every decision
        # stays inline)
        self._cond = threading.Condition()
        self._heap: list = []
        self._evseq = 0
        self._thread: threading.Thread | None = None
        self._starting = False
        self._closing = False

    # -- rule management ----------------------------------------------------

    def add(self, *specs, tag: str = "") -> list:
        """Install rules (specs per :func:`parse_link`); returns them."""
        rules = [parse_link(s, tag=tag) for s in specs]
        with self._lock:
            self._rules.extend(rules)
            if rules:
                self.ever_armed = True
        return rules

    def remove_tag(self, tag: str) -> int:
        """Heal: drop every rule installed under ``tag``.  Rate-cap
        queue tails reset with the heal — a backlog accumulated under
        a removed rule must not charge ghost queuing delay to a later
        rule on the same link."""
        with self._lock:
            before = len(self._rules)
            self._rules = [r for r in self._rules if r.tag != tag]
            self._link_free.clear()
            return before - len(self._rules)

    def clear(self) -> None:
        with self._lock:
            self._rules = []
            self._link_free.clear()

    @property
    def armed(self) -> bool:
        return bool(self._rules)

    def rules(self) -> list:
        with self._lock:
            return list(self._rules)

    # -- deterministic draws ------------------------------------------------

    def _u(self, src: str, dst: str, seq: int, what: str) -> float:
        h = hashlib.sha256(
            f"netem|{self.seed}|{src}|{dst}|{seq}|{what}".encode()
        ).digest()
        return int.from_bytes(h[:8], "big") / 2.0**64

    def pair_rtt_ms(self, rule: LinkRule, src: str, dst: str) -> float:
        """The stable per-directed-pair RTT drawn from the rule's
        ``rtt_ms`` range (seq-independent: a pair's latency is a
        property of the link, not of the message)."""
        lo, hi = rule.rtt_ms
        return lo + self._u(src, dst, -1, "rtt") * (hi - lo)

    # -- the conditioning core ---------------------------------------------

    def _match(self, src: str, dst: str) -> LinkRule | None:
        best = None
        best_rank = (-1, -1)
        for i, r in enumerate(self._rules):
            if r.src != "*" and r.src != src:
                continue
            if r.dst != "*" and r.dst != dst:
                continue
            rank = (r.specificity, i)
            if rank > best_rank:
                best, best_rank = r, rank
        return best

    def decide(self, src: str, dst: str, size: int = 0
               ) -> Decision | None:
        """The pure decision for one message: None = no matching rule
        (deliver untouched).  Advances the link's deterministic
        sequence and — when a rate cap is armed — its queue tail."""
        if not self._rules:
            return None  # lock-free disarmed fast path (GIL-safe read)
        with self._lock:
            rule = self._match(src, dst)
            if rule is None:
                return None
            key = (src, dst)
            seq = self._seq.get(key, 0)
            self._seq[key] = seq + 1
            if self._u(src, dst, seq, "loss") < rule.loss:
                return Decision(rule=rule, drop=True)
            if rule.rtt_ms is not None:
                base_s = self.pair_rtt_ms(rule, src, dst) / 2e3
            else:
                base_s = rule.delay_ms / 1e3
            reordered = (
                rule.reorder > 0.0
                and self._u(src, dst, seq, "reorder") < rule.reorder
            )
            delays = []
            copies = 1
            if rule.dup > 0.0 and self._u(src, dst, seq, "dup") < rule.dup:
                copies = 2
            for c in range(copies):
                if reordered:
                    # tc semantics: the reordered message skips the
                    # latency queue and overtakes in-flight traffic
                    d = 0.0
                else:
                    d = base_s
                    if rule.jitter_ms:
                        d += (
                            2.0 * self._u(src, dst, seq, f"jitter{c}")
                            - 1.0
                        ) * rule.jitter_ms / 1e3
                delays.append(max(0.0, d))
            if rule.rate_bytes_per_s > 0.0 and size > 0:
                now = self._clock()
                busy = max(now, self._link_free.get(key, 0.0))
                tx = size / rule.rate_bytes_per_s
                self._link_free[key] = busy + tx
                queue_s = (busy - now) + tx
                delays = [d + queue_s for d in delays]
            return Decision(
                rule=rule, delays=tuple(delays), reordered=reordered
            )

    def _count(self, label: str, event: str) -> None:
        with self._lock:
            key = (label, event)
            self.counts[key] = self.counts.get(key, 0) + 1
        _mcount(label, event)

    def totals(self) -> dict:
        """This instance's event totals across all rules."""
        out = {e: 0 for e in EVENTS}
        with self._lock:
            for (_, event), n in self.counts.items():
                out[event] = out.get(event, 0) + n
        return out

    def send(self, src: str, dst: str, size: int, deliver) -> bool:
        """Condition one message: returns True when this call took
        ownership (dropped, or scheduled for later delivery) and False
        when the caller should deliver inline (no matching rule, or a
        no-op decision — the zero-cost path)."""
        d = self.decide(src, dst, size)
        if d is None:
            return False
        label = d.rule.label
        if d.drop:
            self._count(label, "dropped")
            return True
        if len(d.delays) == 1 and d.delays[0] <= 0.0 and not d.reordered:
            return False  # conditioned to a no-op: stay synchronous
        if d.reordered:
            self._count(label, "reordered")
        if len(d.delays) > 1:
            self._count(label, "duplicated")
        self._count(label, "delayed")
        now = self._clock()
        with self._cond:
            if self._closing:
                return True  # late traffic into a closing net: drop
            for dl in d.delays:
                heapq.heappush(
                    self._heap, (now + dl, self._evseq, deliver)
                )
                self._evseq += 1
            start = self._thread is None and not self._starting
            if start:
                self._starting = True
            self._cond.notify()
        if start:
            # spawn OUTSIDE _cond: health.register takes the health
            # registry lock, and nesting it under _cond would put an
            # undeclared edge in the lock-order graph (GL05)
            self._start()
        return True

    # -- the delivery scheduler --------------------------------------------

    def _start(self):
        from .. import health

        hb = health.register("netem.delivery")
        t = threading.Thread(
            # graftlint: thread-role=netem.scheduler
            target=self._run, args=(hb,), daemon=True,
            name="netem-delivery",
        )
        with self._cond:
            self._thread = t
        t.start()
        hb.bind(t)

    def _run(self, hb):
        while True:
            with self._cond:
                while True:
                    if self._closing and not self._heap:
                        hb.close()
                        return
                    if self._heap:
                        due = self._heap[0][0]
                        wait = due - self._clock()
                        if wait <= 0.0:
                            _, _, deliver = heapq.heappop(self._heap)
                            break
                        hb.idle()
                        self._cond.wait(min(wait, 0.5))
                    else:
                        if self._closing:
                            hb.close()
                            return
                        hb.idle()
                        self._cond.wait(0.5)
            hb.beat()
            try:
                deliver()
            except Exception:  # noqa: BLE001 — one raising subscriber
                # must not kill the conditioner for the whole net
                _log.error("netem delivery raised")

    def close(self, timeout: float = 5.0) -> None:
        """Teardown: stop the scheduler and discard still-queued
        deliveries (the network under test is gone — executing them
        against torn-down hosts buys nothing)."""
        with self._cond:
            self._closing = True
            self._heap.clear()
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)
