"""Public surface of the verification scheduler (see scheduler.py).

One process owns ONE shared :class:`VerifyScheduler`; every layer —
consensus proof checks, engine replay batches, tx-pool admission, the
sidecar server — submits into it through the convenience wrappers
below, so in-process and sidecar deployments share a single device
queue.  ``HARMONY_SCHED=0`` (or ``configure(enabled=False)``) restores
the pre-scheduler per-caller dispatch exactly.
"""

from __future__ import annotations

import os
import threading

from ..resilience import Deadline, DeadlineExceeded
from .scheduler import (
    LANE_NAMES,
    Lane,
    VerifyFuture,
    VerifyRequest,
    VerifyScheduler,
    expose_metrics,
)

__all__ = [
    "Lane",
    "LANE_NAMES",
    "VerifyFuture",
    "VerifyRequest",
    "VerifyScheduler",
    "Deadline",
    "DeadlineExceeded",
    "agg_verify",
    "agg_verify_many",
    "backend_agg_verify_many",
    "configure",
    "enabled",
    "expose_metrics",
    "reset",
    "scheduler",
    "verify_single",
]

_LOCK = threading.Lock()
_SCHED: VerifyScheduler | None = None
_ENABLED: bool | None = None  # None -> environment default
_OPTS: dict = {}


def enabled() -> bool:
    """Scheduler routing armed?  Default on; HARMONY_SCHED=0 or
    ``configure(enabled=False)`` restores direct dispatch."""
    if _ENABLED is not None:
        return _ENABLED
    return os.environ.get("HARMONY_SCHED", "1") != "0"


def configure(enabled: bool | None = ..., **opts) -> None:
    """Arm/disarm routing and set construction options for the global
    scheduler (``flush_window_s``, ``max_queue_per_lane``,
    ``starvation_limit``, ``device``, ...).  Options apply to the NEXT
    global scheduler built (call ``reset()`` to rebuild)."""
    global _ENABLED
    if enabled is not ...:
        _ENABLED = enabled
    _OPTS.update(opts)


def scheduler() -> VerifyScheduler:
    """The process-wide scheduler, created and started lazily."""
    global _SCHED
    with _LOCK:
        if _SCHED is None:
            _SCHED = VerifyScheduler(**_OPTS).start()
        return _SCHED


def reset() -> None:
    """Stop and discard the global scheduler + configuration (tests)."""
    global _SCHED, _ENABLED
    with _LOCK:
        sched, _SCHED = _SCHED, None
        _ENABLED = None
        _OPTS.clear()
    if sched is not None:
        sched.stop()


# -- convenience wrappers (what the call sites use) --------------------------


def _await(future: VerifyFuture, deadline: Deadline | None) -> bool:
    """Await a future, bounded by the request's own deadline when one
    was given: admission already vetted the budget, so the cushion only
    guards the caller against a WEDGED dispatch parking it forever
    (the resulting TimeoutError is an OSError like DeadlineExceeded).
    Without a deadline the wait is unbounded — parity with the
    pre-scheduler call sites, which blocked in the dispatch itself."""
    if deadline is None:
        return future.result()
    rem = deadline.remaining()
    if rem is None:
        return future.result()
    return future.result(rem + 5.0)


def verify_single(pk_point, payload: bytes, sig_point, *,
                  lane: Lane = Lane.CONSENSUS,
                  deadline: Deadline | None = None) -> bool:
    """One e(-G1,sig)e(pk,H(payload)) check through the shared queue
    (coalesced with every other pending single check into one fused
    program); the direct device path when routing is disarmed."""
    from .. import device as DV

    if not enabled():
        return DV.verify_on_device(pk_point, payload, sig_point,
                                   device=_OPTS.get("device"))
    from .. import prof
    from ..ref.hash_to_curve import hash_to_g2

    with prof.stage("hash_to_g2"):
        h_point = hash_to_g2(payload)
    return _await(scheduler().submit_single(
        pk_point, h_point, sig_point,
        lane=lane, deadline=deadline,
    ), deadline)


def agg_verify(table, bits, payload: bytes, sig_point, *,
               lane: Lane = Lane.CONSENSUS,
               deadline: Deadline | None = None) -> bool:
    """One masked-aggregate quorum check through the shared queue."""
    from .. import device as DV

    if not enabled():
        return DV.agg_verify_on_device(table, bits, payload, sig_point)
    from .. import prof
    from ..ref.hash_to_curve import hash_to_g2

    with prof.stage("hash_to_g2"):
        h_point = hash_to_g2(payload)
    return _await(scheduler().submit_agg(
        table, bits, h_point, sig_point,
        lane=lane, deadline=deadline,
    ), deadline)


def agg_verify_many(table, bits_list, h_points, sig_points, *,
                    lane: Lane = Lane.SYNC,
                    deadline: Deadline | None = None) -> list:
    """A replay-shaped batch of quorum checks against one committee
    table: submitted individually so the scheduler can interleave
    higher-priority lanes between chunks, coalesced back into the
    pinned-bucket fused programs on dispatch."""
    from .. import device as DV

    if not enabled():
        return DV.agg_verify_batch_on_device(
            table, bits_list, h_points, sig_points
        )
    sched = scheduler()
    futures = [
        sched.submit_agg(table, bits, h, sig, lane=lane,
                         deadline=deadline)
        for bits, h, sig in zip(bits_list, h_points, sig_points)
    ]
    return [_await(f, deadline) for f in futures]


def backend_agg_verify_many(client, calls: list, *,
                            lane: Lane = Lane.SYNC,
                            deadline: Deadline | None = None) -> list:
    """Pipelined sidecar agg_verify calls: returns the submitted
    futures (callers collect per-item so one failed call can fall back
    without poisoning the rest).  ``calls``: (epoch, shard, payload,
    bitmap, sig) tuples.  Disarmed routing degrades to plain
    synchronous calls on the caller's thread — same future-shaped
    return, no scheduler thread armed behind the kill switch."""
    if not enabled():
        out = []
        for args in calls:
            fut = VerifyFuture()
            try:
                fut._complete(client.agg_verify(*args, deadline=deadline))
            except Exception as e:  # noqa: BLE001 — per-item contract
                fut._fail(e)
            out.append(fut)
        return out
    sched = scheduler()
    return [
        sched.submit_backend(client, *args, lane=lane, deadline=deadline)
        for args in calls
    ]
