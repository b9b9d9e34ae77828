"""Continuous-batching verification scheduler: ONE shared device queue.

Every caller that needs a BLS check — consensus quorum proofs, sync
replay seal batches, tx-pool/RPC single signatures, the sidecar server's
wire requests — used to own its dispatch: the engine padded its own
chunks, consensus verified one aggregate at a time, and every single-sig
check paid a full dispatch round-trip while the device idled between
small bursty batches.  This module is the missing subsystem between
those callers and ``device.py``: an inference-server-style continuous
batcher (Handel, arXiv 1906.05132, restructures *who batches when* the
same way; arXiv 2302.00418 shows verification latency under load — not
peak kernel throughput — gates BFT rounds).

Shape:

- **Requests + futures.**  Callers submit :class:`VerifyRequest`\\s
  (single-sig, masked-aggregate, sidecar-backend) and get a
  :class:`VerifyFuture`; the caller's thread blocks only on its own
  result, never on the device queue.
- **Priority lanes** — consensus > sync > ingress/RPC — with a
  starvation bound: a non-empty lane passed over ``starvation_limit``
  times is served next regardless of priority, and lower lanes also
  ride along as *backfill* in any flush with spare bucket slots.
  FIFO holds within each lane.
- **Deadline-aware admission**: a request whose
  :class:`~harmony_tpu_torch.resilience.Deadline` cannot survive the current
  queue depth (EWMA dispatch cost x batches ahead + flush window) fails
  fast with ``DeadlineExceeded`` instead of stalling a round; a request
  that expires while queued is never dispatched.
- **Backpressure**: bounded per-lane queues; overflow — and any request
  arriving while the device breaker is OPEN — is *shed* on the caller's
  thread and counted in ``harmony_sched_shed_total``.  Off the card it
  is answered by the CPU reference path (bitwise-identical result); a
  check bound for CUDA fails with ``device.DeviceError`` instead, so the
  card's work never moves to the host.
- **Adaptive flush**: dispatch immediately when the queue is otherwise
  idle (no batching opportunity pending), wait up to ``flush_window_s``
  when requests are streaming in — the classic continuous-batching
  latency/throughput tradeoff.

The scheduler thread holds **no lock across dispatch**: queue pops
happen under ``_cond``, the fused device program runs bare, and metric
/ future completion work runs after the critical section (the same
discipline as ``resilience.CircuitBreaker._note``).  Sidecar-backend
batches are handed to a separate worker thread so a wedged sidecar can
back up *its* lane without stalling device flushes.

Observability: ``sched.enqueue`` spans under the caller's round trace,
``sched.flush`` spans resumed from the oldest request's carried
context, and the ``harmony_sched_*`` metric families rendered by
``expose_metrics`` (queue depth, per-lane wait, batch fill ratio, sheds,
flushes).

The port's copy of the JAX package's scheduler.  Two differences: the
scheduler dispatches to the device given at construction (``device``;
None: the node's device of ``device.use_device``, else CUDA), and a shed
check bound for CUDA fails with ``device.DeviceError`` rather than
running on the host.  That holds for every shed, the resource
governor's included (``governor.should_shed``: INGRESS from PRESSURED,
SYNC at CRITICAL, CONSENSUS never).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from enum import IntEnum

from .. import faultinject as FI
from .. import trace
from ..log import get_logger
from ..metrics import Counter, Gauge, Histogram, LockedCounters
from ..resilience import Deadline, DeadlineExceeded

_log = get_logger("sched")


class Lane(IntEnum):
    """Priority lanes, lowest value = highest priority."""

    CONSENSUS = 0  # live FBFT quorum proofs / seal checks on the round
    SYNC = 1       # replay / staged-sync header batches
    INGRESS = 2    # tx-pool admission, RPC submits, gossip sender sigs


LANE_NAMES = {Lane.CONSENSUS: "consensus", Lane.SYNC: "sync",
              Lane.INGRESS: "ingress"}


def max_queue_depth() -> float:
    """Deepest lane's queue depth — the governor's pressure signal and
    the soak harness's stationarity series read the SAME number through
    this one accessor so lane renames can't silently diverge them."""
    return max(
        (QUEUE_DEPTH.value(lane=name) for name in LANE_NAMES.values()),
        default=0.0,
    )

# -- metrics singletons (rendered by expose_metrics) --------------------------

QUEUE_DEPTH = Gauge(
    "harmony_sched_queue_depth",
    "verification requests waiting in the scheduler, per lane",
)
SHED = Counter(
    "harmony_sched_shed_total",
    "requests shed out of the queue (breaker_open/queue_full/deadline/"
    "expired), per lane",
)
FLUSHES = Counter(
    "harmony_sched_flushes_total",
    "fused dispatches issued by the scheduler, per request kind",
)
ITEMS = Counter(
    "harmony_sched_items_total",
    "verification requests dispatched through the scheduler, per lane",
)
# batch fill accounting: live items vs padded bucket slots across every
# *batched* dispatch (the lone-aggregate fast path is unpadded and does
# not enter the ratio) — harmony_sched_batch_fill_ratio is items/slots
FILL = LockedCounters("items", "slots")

_WAIT_BUCKETS = (0.0005, 0.001, 0.002, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 5.0)
WAIT_SECONDS = {
    lane: Histogram(
        "harmony_sched_wait_seconds",
        "enqueue-to-dispatch wait inside the scheduler",
        buckets=_WAIT_BUCKETS, labels={"lane": name},
    )
    for lane, name in LANE_NAMES.items()
}


def expose_metrics() -> str:
    """The scheduler's Prometheus families."""
    out = [QUEUE_DEPTH.expose(), SHED.expose(), FLUSHES.expose(),
           ITEMS.expose()]
    hist_lines: list = []
    for i, lane in enumerate(sorted(WAIT_SECONDS)):
        lines = WAIT_SECONDS[lane].expose().splitlines()
        hist_lines.extend(lines if i == 0 else lines[2:])
    out.append("\n".join(hist_lines))
    items, slots = FILL["items"], FILL["slots"]
    ratio = (items / slots) if slots else 0.0
    out.append(
        "# HELP harmony_sched_batch_fill_ratio live items / padded "
        "bucket slots across all batched dispatches\n"
        "# TYPE harmony_sched_batch_fill_ratio gauge\n"
        f"harmony_sched_batch_fill_ratio {ratio:g}"
    )
    return "\n".join(out)


# -- requests / futures ------------------------------------------------------


class VerifyFuture:
    """Completion handle for one submitted verification."""

    __slots__ = ("_event", "_result", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._result: bool | None = None
        self._exc: BaseException | None = None

    def _complete(self, result: bool) -> None:
        self._result = result
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> bool:
        """The verification verdict; raises what the scheduler raised
        (DeadlineExceeded on fail-fast admission, the dispatch error on
        a failed backend call)."""
        if not self._event.wait(timeout):
            raise TimeoutError("verification result not ready")
        if self._exc is not None:
            raise self._exc
        return bool(self._result)


class VerifyRequest:
    """One verification wanting a bucket slot.

    kind: ``single`` (pk/h/sig points), ``agg`` (committee table + bits
    + h/sig), or ``backend`` (a sidecar ``agg_verify`` call pipelined
    over the wire).  Hash-to-G2 happens on the *submitting* thread —
    the scheduler thread only batches and dispatches.
    """

    __slots__ = ("kind", "lane", "table", "bits", "pk_point", "h_point",
                 "sig_point", "client", "call_args", "deadline", "future",
                 "enqueued_at", "trace_ctx")

    def __init__(self, kind: str, lane: Lane, *, table=None, bits=None,
                 pk_point=None, h_point=None, sig_point=None, client=None,
                 call_args=None, deadline: Deadline | None = None):
        self.kind = kind
        self.lane = Lane(lane)
        self.table = table
        self.bits = bits
        self.pk_point = pk_point
        self.h_point = h_point
        self.sig_point = sig_point
        self.client = client
        self.call_args = call_args
        self.deadline = deadline
        self.future = VerifyFuture()
        self.enqueued_at = 0.0
        self.trace_ctx = b""

    def group_key(self) -> tuple:
        """Requests sharing a key fuse into one dispatch."""
        if self.kind == "agg":
            return ("agg", id(self.table))
        if self.kind == "backend":
            return ("backend", id(self.client))
        return ("single",)


class VerifyScheduler:
    """The shared continuous batcher in front of ``device.py``.

    ``manual=True`` builds a scheduler with no thread: submissions
    queue, and tests drive ``_flush_once()`` deterministically.
    ``device``: where single checks run and which batch buckets apply
    (None: ``device.resolve_device()``); aggregate checks run on their
    table's device."""

    def __init__(self, *, max_queue_per_lane: int = 1024,
                 flush_window_s: float = 0.002,
                 starvation_limit: int = 4,
                 max_batch: int | None = None,
                 clock=time.monotonic, manual: bool = False,
                 device=None):
        self._device = device
        self.max_queue_per_lane = max_queue_per_lane
        self.flush_window_s = flush_window_s
        self.starvation_limit = max(1, starvation_limit)
        self._max_batch = max_batch
        self._clock = clock
        self._manual = manual
        self._cond = threading.Condition()
        self._lanes: dict[Lane, deque] = {lane: deque() for lane in Lane}
        self._skips: dict[Lane, int] = {lane: 0 for lane in Lane}
        self._running = False
        self._thread: threading.Thread | None = None
        # sidecar-backend batches run on their own worker so a slow or
        # dead sidecar never blocks device flushes (its callers still
        # wait only on their own futures)
        self._backend_cond = threading.Condition()
        self._backend_batches: deque = deque()
        self._backend_thread: threading.Thread | None = None
        self._backend_hb = None
        self._ewma_dispatch_s = 0.0
        self._hb = None  # health.Heartbeat once start() registers it

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "VerifyScheduler":
        from .. import health

        with self._cond:
            if self._running or self._manual:
                return self
            self._running = True
        self._thread = threading.Thread(
            # graftlint: thread-role=sched.flush
            target=self._loop, name="sched-flush", daemon=True
        )
        self._thread.start()
        # watchdog registration: the flush thread is CRITICAL (every
        # signature check funnels through it) and restart-SAFE when
        # dead — its queues live on the scheduler object, so a fresh
        # loop resumes exactly where the dead one stopped
        self._hb = health.register(
            "sched.flush", thread=self._thread, critical=True,
            restart=self._revive,
        )
        return self

    def _revive(self) -> bool:
        """Watchdog restart hook: respawn the flush loop if (and only
        if) the scheduler is still running and its thread is dead.  The
        queued requests are untouched — the new loop drains them.
        Returns False when it declines (racing a stop(), or the thread
        is alive after all) so the watchdog does not count a restart
        that never ran."""
        with self._cond:
            if not self._running:
                return False
            t = self._thread
            if t is not None and t.is_alive():
                return False
        thread = threading.Thread(
            # graftlint: thread-role=sched.flush
            target=self._loop, name="sched-flush", daemon=True
        )
        # started BEFORE being published: stop() joins self._thread,
        # and joining a never-started thread raises RuntimeError — a
        # stop() racing this window must find either the old dead
        # thread or a joinable live one.  If stop() wins the race the
        # fresh loop sees _running False and exits by itself.
        thread.start()
        with self._cond:
            if not self._running:
                return False
            self._thread = thread
        if self._hb is not None:
            self._hb.bind(thread)
        return True

    def stop(self) -> None:
        with self._cond:
            self._running = False
            pending: list = []
            for q in self._lanes.values():
                pending.extend(q)
                q.clear()
            self._cond.notify_all()
        with self._backend_cond:
            for batch in self._backend_batches:
                pending.extend(batch)
            self._backend_batches.clear()
            self._backend_cond.notify_all()
        for req in pending:
            req.future._fail(RuntimeError("verification scheduler stopped"))
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._backend_thread is not None:
            self._backend_thread.join(timeout=5.0)
            self._backend_thread = None
        if self._hb is not None:
            self._hb.close()
            self._hb = None

    # -- submission ----------------------------------------------------------

    def submit_single(self, pk_point, h_point, sig_point, *,
                      lane: Lane = Lane.INGRESS,
                      deadline: Deadline | None = None) -> VerifyFuture:
        return self._submit(VerifyRequest(
            "single", lane, pk_point=pk_point, h_point=h_point,
            sig_point=sig_point, deadline=deadline,
        ))

    def submit_agg(self, table, bits, h_point, sig_point, *,
                   lane: Lane = Lane.CONSENSUS,
                   deadline: Deadline | None = None) -> VerifyFuture:
        return self._submit(VerifyRequest(
            "agg", lane, table=table, bits=bits, h_point=h_point,
            sig_point=sig_point, deadline=deadline,
        ))

    def submit_backend(self, client, epoch: int, shard: int,
                       payload: bytes, bitmap: bytes, sig: bytes, *,
                       lane: Lane = Lane.SYNC,
                       deadline: Deadline | None = None) -> VerifyFuture:
        return self._submit(VerifyRequest(
            "backend", lane, client=client,
            call_args=(epoch, shard, payload, bitmap, sig),
            deadline=deadline,
        ))

    def _submit(self, req: VerifyRequest) -> VerifyFuture:
        lane_name = LANE_NAMES[req.lane]
        with trace.span("sched.enqueue", component="sched",
                        lane=lane_name, kind=req.kind):
            req.trace_ctx = trace.traceparent()
            # device breaker OPEN: the queue would only delay the
            # inevitable refusal (CUDA) or reference fallback — shed NOW
            # on the caller's thread (what _guarded would give)
            if req.kind != "backend" and self._breaker_open():
                self._shed(req, "breaker_open")
                return req.future
            # resource-governor degradation: INGRESS sheds from the
            # PRESSURED tier, SYNC from CRITICAL, CONSENSUS never —
            # overload must not buy queue depth ahead of quorum proofs.
            # Off the card the shed verdict is the exact CPU-reference
            # answer on the caller's thread; bound for CUDA it fails
            if req.lane is not Lane.CONSENSUS:
                from .. import governor as GV

                if GV.should_shed(req.lane):
                    self._shed(req, "governor")
                    return req.future
            # fail-fast admission: if the budget cannot survive the
            # queue already ahead of us, refuse before anyone waits
            if req.deadline is not None:
                rem = req.deadline.remaining()
                if rem is not None and rem < self._est_wait_s(req.lane):
                    SHED.inc(lane=lane_name, reason="deadline")
                    trace.annotate(shed="deadline")
                    req.future._fail(DeadlineExceeded(
                        f"sched {req.kind} cannot meet its deadline: "
                        f"{rem:.3f}s left vs "
                        f"~{self._est_wait_s(req.lane):.3f}s queue wait"
                    ))
                    return req.future
            overflow = False
            depth = 0
            with self._cond:
                alive = self._running or self._manual
                if alive:
                    q = self._lanes[req.lane]
                    if len(q) >= self.max_queue_per_lane:
                        overflow = True
                    else:
                        req.enqueued_at = self._clock()
                        q.append(req)
                        depth = len(q)
                        self._cond.notify()
            if not alive:
                # no scheduler: run the exact unscheduled path inline
                self._run_inline(req)
            elif overflow:
                self._shed(req, "queue_full")
            else:
                QUEUE_DEPTH.set(depth, lane=lane_name)
                trace.annotate(queue_depth=depth)
            return req.future

    # -- admission helpers ---------------------------------------------------

    @staticmethod
    def _breaker_open() -> bool:
        from .. import device as DV

        # .state (not .allow()): reading must neither count a rejection
        # nor consume a half-open probe the real dispatch needs
        return DV.BREAKER.state == "open"

    def _est_wait_s(self, lane: Lane) -> float:
        """Worst-case-ish queue wait for a request entering ``lane``:
        everything at equal-or-higher priority dispatches first, in
        batches of the widest bucket, each costing the EWMA dispatch
        time, plus one adaptive-flush window."""
        ahead = sum(
            len(q) for ln, q in self._lanes.items() if ln <= lane
        )
        batches = ahead // self._target_batch() + 1
        per = max(self._ewma_dispatch_s, 1e-3)
        return self.flush_window_s + batches * per

    def device(self):
        """The torch.device this scheduler's single checks run on."""
        from .. import device as DV

        return DV.resolve_device(self._device)

    def _target_batch(self) -> int:
        from .. import device as DV

        return DV.batch_buckets(self.device())[-1]

    # -- shed / inline paths -------------------------------------------------

    def _shed(self, req: VerifyRequest, reason: str) -> None:
        from .. import device as DV

        SHED.inc(lane=LANE_NAMES[req.lane], reason=reason)
        trace.annotate(shed=reason)
        try:
            if self._on_card(req):
                raise DV.DeviceError(
                    f"sched {req.kind} shed ({reason}): a check bound for "
                    f"the card is not run on the host")
            req.future._complete(self._ref_result(req))
        except Exception as e:  # noqa: BLE001 — surfaced via the future
            req.future._fail(e)

    def _on_card(self, req: VerifyRequest) -> bool:
        """Is ``req`` bound for CUDA (its table's device, or this
        scheduler's for a single check)?"""
        from .. import device as DV

        if req.kind == "agg":
            return DV._on_card(req.table.device)
        if req.kind == "single":
            return DV._on_card(self.device())
        return False

    @staticmethod
    def _ref_result(req: VerifyRequest) -> bool:
        """CPU reference verdict for a shed request off the card — the
        same host path device._guarded falls back to."""
        from .. import device as DV

        if req.kind == "agg":
            return DV._ref_agg_verify(
                req.table, req.bits, req.h_point, req.sig_point
            )
        if req.kind == "single":
            from ..ref import bls as RB

            return RB.verify_hashed(
                req.pk_point, req.h_point, req.sig_point
            )
        # backend requests have no local committee to shed onto — the
        # degraded path is the plain synchronous client call
        return req.client.agg_verify(*req.call_args, deadline=req.deadline)

    def _run_inline(self, req: VerifyRequest) -> None:
        """No scheduler running: behave exactly like the pre-scheduler
        call sites (one breaker-guarded dispatch per request)."""
        from .. import device as DV

        try:
            if req.kind == "agg":
                ok = DV.agg_verify_hashed_on_device(
                    req.table, req.bits, req.h_point, req.sig_point
                )
            elif req.kind == "single":
                ok = DV.verify_many_on_device(
                    [req.pk_point], [req.h_point], [req.sig_point],
                    device=self.device(),
                )[0]
            else:
                ok = req.client.agg_verify(
                    *req.call_args, deadline=req.deadline
                )
            req.future._complete(ok)
        except Exception as e:  # noqa: BLE001 — surfaced via the future
            req.future._fail(e)

    # -- the scheduler loop --------------------------------------------------

    def _loop(self) -> None:
        while True:
            # re-read each pass: start() registers the heartbeat only
            # AFTER the thread is running
            hb = self._hb
            kind = batch = expired = None
            # the wedged_thread_recovery chaos scenario's kill switch:
            # an armed exc here dies like any unexpected flush-loop
            # error would — outside every per-batch catch — and the
            # health watchdog must detect the dead thread and revive it
            FI.fire("sched.flush")
            if hb is not None:
                hb.beat()
            # the bucket width resolves OUTSIDE _cond: its first call
            # may run the device backend probe (a bounded Thread.join)
            # and nothing blocking belongs under the queue lock (GL06)
            target = self._target_batch()
            with self._cond:
                while self._running and not any(self._lanes.values()):
                    if hb is not None:
                        hb.idle()  # empty queue: parked healthy, not
                        #            wedged — the watchdog skips idle
                    self._cond.wait()
                if hb is not None:
                    hb.beat()
                if not self._running:
                    return
                lane = self._choose_lane()
                q = self._lanes[lane]
                now = self._clock()
                head_age = now - q[0].enqueued_at
                # adaptive flush: full bucket or window elapsed -> go.
                # Below the bucket, the lanes trade differently: a
                # CONSENSUS request waits only when FUSABLE traffic is
                # already pending (a same-group neighbor — unrelated
                # sync replay can never join its batch, so waiting on
                # its account would be pure added latency on the path
                # that gates rounds); sync/ingress traffic —
                # throughput work — waits out the window even alone,
                # because bursts arrive within it and lone 1-of-8
                # dispatches waste the bucket
                head_key = q[0].group_key()
                fusable = (
                    (len(q) > 1 and q[1].group_key() == head_key)
                    or any(
                        self._lanes[ln] and
                        self._lanes[ln][0].group_key() == head_key
                        for ln in Lane if ln is not lane
                    )
                )
                if (len(q) < target
                        and head_age < self.flush_window_s
                        and (fusable or lane is not Lane.CONSENSUS)):
                    self._cond.wait(self.flush_window_s - head_age)
                    continue
                kind, batch, expired, depths = self._collect(
                    lane, now, target
                )
            self._after_collect(depths, expired)
            if batch:
                self._dispatch(kind, batch)

    def _flush_once(self) -> bool:
        """Test hook (manual mode): one synchronous choose/collect/
        dispatch cycle; returns whether anything was processed."""
        target = self._target_batch()  # outside _cond, like _loop
        with self._cond:
            if not any(self._lanes.values()):
                return False
            lane = self._choose_lane()
            kind, batch, expired, depths = self._collect(
                lane, self._clock(), target
            )
        self._after_collect(depths, expired)
        if batch:
            if kind == "backend":
                self._run_backend(batch)
            else:
                self._dispatch(kind, batch)
        return bool(batch or expired)

    def _choose_lane(self) -> Lane:
        # caller holds self._cond
        candidates = [ln for ln in Lane if self._lanes[ln]]
        starved = [ln for ln in candidates
                   if self._skips[ln] >= self.starvation_limit]
        return min(starved) if starved else min(candidates)

    def _collect(self, lane: Lane, now: float, target: int):
        """Pop one fused batch (same group key), primary lane first,
        then backfill from every other lane head-first — per-lane FIFO
        is preserved because only matching *prefixes* are taken.
        Expired requests are dropped, never dispatched.  Caller holds
        ``self._cond`` and resolved ``target`` (the widest bucket)
        outside it; all completion/metric work is returned for the
        caller to run outside the lock."""
        expired: list = []
        cap = self._max_batch or 4 * target

        def pop_expired(q) -> bool:
            r = q[0]
            if r.deadline is not None and r.deadline.expired():
                expired.append(q.popleft())
                return True
            return False

        q = self._lanes[lane]
        key = None
        while q:
            if pop_expired(q):
                continue
            key = q[0].group_key()
            break
        batch: list = []
        contributed = set()
        if key is not None:
            if key[0] == "backend":
                cap = min(cap, 64)
            for ln in sorted(Lane, key=lambda x: (x is not lane, x)):
                qq = self._lanes[ln]
                while qq and len(batch) < cap:
                    if pop_expired(qq):
                        continue
                    if qq[0].group_key() != key:
                        break
                    batch.append(qq.popleft())
                    contributed.add(ln)
                if len(batch) >= cap:
                    break
        for ln in Lane:
            if ln in contributed:
                self._skips[ln] = 0
            elif self._lanes[ln]:
                self._skips[ln] += 1
        depths = {ln: len(self._lanes[ln]) for ln in Lane}
        return (key[0] if key else None), batch, expired, depths

    def _after_collect(self, depths, expired) -> None:
        for ln, depth in depths.items():
            QUEUE_DEPTH.set(depth, lane=LANE_NAMES[ln])
        for req in expired or ():
            SHED.inc(lane=LANE_NAMES[req.lane], reason="expired")
            req.future._fail(DeadlineExceeded(
                f"sched {req.kind} expired while queued"
            ))

    # -- dispatch ------------------------------------------------------------

    def _flush_span(self, batch):
        tc = batch[0].trace_ctx
        if tc:
            return trace.resume(tc, "sched.flush", component="sched")
        return trace.span("sched.flush", component="sched")

    def _observe_waits(self, batch) -> None:
        now = self._clock()
        for req in batch:
            WAIT_SECONDS[req.lane].observe(
                max(0.0, now - req.enqueued_at)
            )
        lanes: dict = {}
        for req in batch:
            lanes[LANE_NAMES[req.lane]] = lanes.get(
                LANE_NAMES[req.lane], 0
            ) + 1
        for name, n in lanes.items():
            ITEMS.inc(n, lane=name)

    def _dispatch(self, kind: str, batch: list) -> None:
        if kind == "backend":
            self._enqueue_backend(batch)
            return
        with self._flush_span(batch):
            self._observe_waits(batch)
            t0 = self._clock()
            try:
                if kind == "single":
                    results, slots = self._run_single(batch)
                else:
                    results, slots = self._run_agg(batch)
            except Exception as e:  # noqa: BLE001 — dispatch failures
                # surface through every future, never kill the loop
                _log.warn("sched dispatch failed", kind=kind,
                          items=len(batch), error=str(e))
                trace.annotate(error=str(e))
                for req in batch:
                    req.future._fail(e)
                return
            dur = self._clock() - t0
            for req, ok in zip(batch, results):
                req.future._complete(bool(ok))
            if slots:
                FILL.inc("items", len(batch))
                FILL.inc("slots", slots)
            FLUSHES.inc(kind=kind)
            self._ewma_dispatch_s = (
                dur if self._ewma_dispatch_s == 0.0
                else 0.2 * dur + 0.8 * self._ewma_dispatch_s
            )
            trace.annotate(
                kind=kind, items=len(batch), slots=slots,
                fill=round(len(batch) / slots, 3) if slots else 1.0,
                dispatch_s=round(dur, 6),
            )

    def _padded_slots(self, n: int) -> int:
        from .. import device as DV

        device = self.device()
        widest = DV.batch_buckets(device)[-1]
        slots = 0
        remaining = n
        while remaining > 0:
            chunk = min(remaining, widest)
            slots += DV.batch_bucket(chunk, device)
            remaining -= chunk
        return slots

    def _run_single(self, batch: list):
        from .. import device as DV

        results = DV.verify_many_on_device(
            [r.pk_point for r in batch],
            [r.h_point for r in batch],
            [r.sig_point for r in batch],
            device=self.device(),
        )
        return results, self._padded_slots(len(batch))

    def _run_agg(self, batch: list):
        from .. import device as DV

        table = batch[0].table
        if len(batch) == 1:
            # lone aggregate: the unpadded fused program (shared with
            # the pre-scheduler single-check path) — no fill accounting,
            # there are no pad lanes to waste
            r = batch[0]
            ok = DV.agg_verify_hashed_on_device(
                table, r.bits, r.h_point, r.sig_point
            )
            return [ok], 0
        results = DV.agg_verify_batch_on_device(
            table,
            [r.bits for r in batch],
            [r.h_point for r in batch],
            [r.sig_point for r in batch],
        )
        return results, self._padded_slots(len(batch))

    # -- the sidecar-backend worker ------------------------------------------

    def _enqueue_backend(self, batch: list) -> None:
        from .. import health

        spawned = None
        with self._backend_cond:
            if (self._backend_thread is None
                    or not self._backend_thread.is_alive()):
                self._backend_thread = threading.Thread(
                    # graftlint: thread-role=sched.flush
                    target=self._backend_loop, name="sched-backend",
                    daemon=True,
                )
                self._backend_thread.start()
                spawned = self._backend_thread
            self._backend_batches.append(batch)
            self._backend_cond.notify()
        if spawned is not None:
            # registered OUTSIDE _backend_cond (health._LOCK nests
            # under no scheduler lock — GL05).  Non-critical, no
            # restart hook: a dead worker is respawned lazily by the
            # next enqueue, but a WEDGED one (stuck in a sidecar call)
            # must show up stale on /healthz instead of silently
            # stalling verify futures
            self._backend_hb = health.register(
                "sched.backend", thread=spawned,
            )

    def _backend_loop(self) -> None:
        while True:
            # re-read each pass: _enqueue_backend registers the
            # heartbeat only AFTER the thread is running
            hb = self._backend_hb
            with self._backend_cond:
                while self._running and not self._backend_batches:
                    if hb is not None:
                        hb.idle()  # parked empty: healthy, not wedged
                    self._backend_cond.wait()
                if not self._backend_batches:
                    if hb is not None:
                        hb.close()
                    return
                batch = self._backend_batches.popleft()
            if hb is not None:
                hb.beat()
            self._run_backend(batch)

    def _run_backend(self, batch: list) -> None:
        """Pipeline a batch of sidecar agg_verify calls: send every
        frame before waiting on any reply (the client's reader thread
        demultiplexes) — a cross-epoch header batch no longer pays one
        round-trip per header."""
        with self._flush_span(batch):
            self._observe_waits(batch)
            t0 = self._clock()
            handles: list = []
            for req in batch:
                try:
                    handles.append((req, req.client.agg_verify_begin(
                        *req.call_args, deadline=req.deadline
                    )))
                except Exception as e:  # noqa: BLE001 — per-request
                    req.future._fail(e)
            for req, handle in handles:
                try:
                    req.future._complete(handle.result())
                except Exception as e:  # noqa: BLE001 — per-request
                    req.future._fail(e)
            FLUSHES.inc(kind="backend")
            trace.annotate(kind="backend", items=len(batch),
                           dispatch_s=round(self._clock() - t0, 6))
