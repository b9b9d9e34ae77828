"""The device entry points of the quorum-verify path, and the switch that
routes the node's checks to them.

A committee's pubkeys live on the device as one padded table
(``CommitteeTable``); each check ships a bitmap, a hashed payload and a
signature, and gets a bool back.  Every entry point runs on CUDA unless
the caller asks for another device: ``device="cpu"`` on the call, or
``use_device(flag, device="cpu")`` for every check of the node layer (as
the tests do).  With no CUDA and no device asked for, it raises before
any dispatch.

Every dispatch runs under ``BREAKER`` (``_guarded``).  On CUDA the card's
work never moves to the host: a dispatch that raises (a kernel that
fails to build or launch, a wrapper that refuses its tensors) is a
breaker failure and raises ``DeviceError`` to the caller, and an OPEN
breaker refuses the check with ``DeviceError``.  The one counted host
answer on CUDA is for an injected ``device.dispatch`` fault
(``faultinject.FaultInjected``), which ``chip_smoke.py`` arms once to
show the path.  On any other device (the CPU, as the tests run it) the
JAX package's contract holds: a raise or an OPEN breaker is counted in
``COUNTERS["ref_fallback"]``, logged, and answered by the host path
(``ref/``, native when the library loads).  ``chip_smoke.py`` asserts
after each of its phases that ``ref_fallback == 0``, that the scheduler
shed nothing and that ``BREAKER.state == "closed"``.

``device_enabled()`` decides whether the node layer (``bls.py``,
``consensus/mask.py``, ``sched/``) takes this path at all: forced by
``use_device``, else AUTO, which asks ``torch.cuda.is_available()``.
``HARMONY_KERNEL_TWIN=1`` swaps the kernels' entry points for the
bigint twins of ``ops/twin.py`` off the card; on CUDA it is ignored.
"""

from __future__ import annotations

import os
import threading
import time

import numpy as np
import torch

from . import faultinject as FI
from . import prof
from . import trace
from .log import get_logger
from .metrics import Gauge, Histogram, LockedCounters
from .ops import bls as OB
from .ops import curve as CV
from .ops import interop as I
from .resilience import CircuitBreaker

_log = get_logger("device")

_FORCED: bool | None = None
_AUTO: bool | None = None
_NODE_DEVICE: torch.device | None = None
_LOCK = threading.Lock()

COUNTERS = LockedCounters(
    "verify", "agg_verify", "batch_verify", "ref_fallback",
    "masked_pubkey_sum",
)

# Per-dispatch latency, host<->device transfer bytes, and the program
# shapes seen: under torch a program's first use is its first launch at
# that shape (the library's load, the first copies); the names are the
# JAX package's.  All annotated onto the active trace span too.
DISPATCH_SECONDS = Histogram(
    "harmony_device_dispatch_seconds",
    "wall time of one breaker-guarded device dispatch",
)
TRANSFER = LockedCounters("h2d", "d2h")
JIT = LockedCounters("hit", "miss")
JIT_COMPILE_SECONDS = Gauge(
    "harmony_device_jit_compile_seconds",
    "wall time of the first dispatch per program shape",
)

_SEEN_PROGRAMS: set = set()
_SEEN_LOCK = threading.Lock()


def _program_first_use(program: str) -> bool:
    """True exactly once per program shape per process."""
    with _SEEN_LOCK:
        first = program not in _SEEN_PROGRAMS
        if first:
            _SEEN_PROGRAMS.add(program)
    JIT.inc("miss" if first else "hit")
    return first


def mark_warm(program: str) -> None:
    """Record ``program`` as already used, so that later dispatches
    account a warm shape.  No JIT counter moves."""
    with _SEEN_LOCK:
        _SEEN_PROGRAMS.add(program)


def _peak_base(first: bool, dev) -> int | None:
    """At an armed profiler's first dispatch of a program on the card:
    reset the allocator's peak and return the bytes allocated now (the
    base of ``prof``'s ``peak_memory_bytes``); else None."""
    if not (first and prof.enabled() and _on_card(dev)):
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def _record(program: str, first: bool, seconds: float, args: tuple = (),
            out: tuple = (), base: int | None = None, dev=None) -> None:
    if first:
        JIT_COMPILE_SECONDS.set(seconds, program=program)
        peak = (None if base is None
                else torch.cuda.max_memory_allocated(dev) - base)
        prof.on_first_dispatch(program, seconds, args, out, peak)
    else:
        prof.observe_execute(program, seconds)


# The device-dispatch circuit breaker: a backend that keeps raising trips
# it OPEN until a half-open probe re-admits the device; meanwhile checks
# on CUDA raise DeviceError and checks elsewhere take the host path.
BREAKER = CircuitBreaker("device", failure_threshold=5,
                         reset_timeout_s=30.0)

# Optional per-dispatch latency budget (seconds); None disables it.  A
# dispatch that completes but overruns the budget still returns its
# (correct) result; it counts as a breaker failure.
DISPATCH_DEADLINE_S: float | None = None


def set_dispatch_deadline(seconds: float | None) -> None:
    global DISPATCH_DEADLINE_S
    DISPATCH_DEADLINE_S = seconds


class DeviceError(RuntimeError):
    """A check that was to run on the card and did not: its dispatch
    raised, or the breaker is OPEN.  Never answered by the host."""


def _guarded(kind: str, dispatch, fallback, *, device):
    """Run one device dispatch under the breaker.

    Raise -> breaker failure; on CUDA a ``DeviceError`` from the dispatch's
    error, elsewhere (and for an injected fault) a host fallback (the
    caller still gets a correct bool; the failure is counted and
    logged).  Deadline overrun -> breaker failure, device result kept.
    Breaker OPEN -> on CUDA a ``DeviceError``, elsewhere the fallback
    without touching the device at all.  The whole attempt (fallback
    included, when one runs) is a ``device.dispatch`` trace span."""
    card = _on_card(device)
    if not BREAKER.allow():
        if card:
            raise DeviceError(f"device breaker open: {kind} not dispatched")
        COUNTERS.inc("ref_fallback")
        with trace.span("device.dispatch", component="device",
                        kind=kind, outcome="breaker_open"):
            return fallback()
    t0 = time.monotonic()
    with trace.span("device.dispatch", component="device", kind=kind):
        try:
            FI.fire("device.dispatch")
            out = dispatch()
        except Exception as e:  # noqa: BLE001 — any backend failure
            BREAKER.record_failure()
            DISPATCH_SECONDS.observe(time.monotonic() - t0)
            if card and not isinstance(e, FI.FaultInjected):
                _log.error("device dispatch failed", kind=kind,
                           error=str(e))
                trace.annotate(outcome="error", error=str(e))
                raise DeviceError(f"{kind} failed on the card: {e}") from e
            COUNTERS.inc("ref_fallback")
            _log.warn("device dispatch failed; reference fallback",
                      kind=kind, error=str(e))
            trace.annotate(outcome="ref_fallback", error=str(e))
            return fallback()
        elapsed = time.monotonic() - t0
        DISPATCH_SECONDS.observe(elapsed)
        if (DISPATCH_DEADLINE_S is not None
                and elapsed > DISPATCH_DEADLINE_S):
            BREAKER.record_failure()
            _log.warn("device dispatch exceeded deadline", kind=kind,
                      budget_s=DISPATCH_DEADLINE_S)
            trace.annotate(outcome="deadline_overrun")
        else:
            BREAKER.record_success()
        return out


# -- the switch and the node's device -----------------------------------------


def use_device(flag: bool | None, device=None) -> None:
    """Force the path (True/False) or restore AUTO (None), and set the
    device that the node layer's checks run on (None: CUDA)."""
    global _FORCED, _NODE_DEVICE
    _FORCED = flag
    _NODE_DEVICE = None if device is None else torch.device(device)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the node's device set by
    ``use_device``, else CUDA, which must exist."""
    if device is None:
        device = _NODE_DEVICE
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def device_enabled() -> bool:
    global _AUTO
    if _FORCED is not None:
        return _FORCED
    if _AUTO is None:
        with _LOCK:
            if _AUTO is None:
                _AUTO = bool(torch.cuda.is_available())
    return _AUTO


def kernel_twin_active(device=None) -> bool:
    """HARMONY_KERNEL_TWIN=1 swaps the kernels' entry points for the
    bigint/native-backed twins (ops/twin.py), off the card only: on CUDA
    (``device``, else the node's device, else CUDA where it exists) the
    variable is ignored and the kernels run."""
    if os.environ.get("HARMONY_KERNEL_TWIN") != "1":
        return False
    if device is None:
        device = _NODE_DEVICE
    if device is None:
        return not torch.cuda.is_available()
    return not _on_card(device)


def _kernels(device):
    if kernel_twin_active(device):
        from .ops import twin as T

        return T
    return OB


def _host_array(x) -> np.ndarray:
    """A kernel's (tensor) or a twin's (numpy) result on the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# -- committee tables ------------------------------------------------------------

# Committee tables are padded to one of these pinned sizes (pad keys are
# affine (0,0) = infinity, masked off by zero bitmap bits).
COMMITTEE_BUCKETS = (8, 16, 32, 64, 128, 256, 512, 1024)


def committee_bucket(n: int) -> int:
    """Smallest pinned bucket admitting ``n`` committee slots.  Widths
    past the largest bucket raise: no deployed committee exceeds 1024
    slots, and admitting one is a registry change."""
    for b in COMMITTEE_BUCKETS:
        if n <= b:
            return b
    raise ValueError(
        f"committee width {n} exceeds the largest pinned bucket "
        f"{COMMITTEE_BUCKETS[-1]}; extend COMMITTEE_BUCKETS to admit it")


class CommitteeTable:
    """A committee's pubkeys as ONE device-resident padded affine tensor
    (size, 2, 32), so that steady-state quorum checks ship only a bitmap
    and a signature to the device."""

    def __init__(self, points, device=None):
        arr = np.zeros((committee_bucket(max(len(points), 1)), 2, 32),
                       dtype=np.int32)
        if points:
            arr[: len(points)] = I.g1_batch_affine(points).numpy()
        self._init(arr, len(points), device, list(points))

    @classmethod
    def from_numpy(cls, arr, n: int, device=None) -> "CommitteeTable":
        """A table from the JAX package's ``CommitteeTable._np``: an
        (size, 2, 32) int32 array whose first ``n`` rows are the keys and
        whose pad rows are affine (0, 0)."""
        arr = np.asarray(arr, dtype=np.int32)
        if arr.ndim != 3 or arr.shape[1:] != (2, 32):
            raise ValueError(f"table must be (size, 2, 32), got {arr.shape}")
        if arr.shape[0] != committee_bucket(max(n, 1)):
            raise ValueError(
                f"table of {arr.shape[0]} rows is not the bucket of {n} keys")
        table = cls.__new__(cls)
        table._init(arr, n, device, None)
        return table

    def _init(self, arr, n, device, points):
        self.n = n
        self.size = arr.shape[0]
        self.device = resolve_device(device)
        # off the card the host path may answer, so the keys stay at hand
        self._points = None if _on_card(self.device) else points
        self._dev = torch.from_numpy(arr).to(self.device)
        # the one table upload this table exists to amortize
        TRANSFER.inc("h2d", arr.nbytes)

    @property
    def points(self) -> list:
        """The keys as reference affine points (the host path's input):
        read back from the device table where they were not kept."""
        if self._points is not None:
            return self._points
        return [(I.arr_to_fp(row[0]), I.arr_to_fp(row[1]))
                for row in self._dev[: self.n].cpu().numpy()]

    def device_array(self) -> torch.Tensor:
        return self._dev

    def pad_bits(self, bits) -> np.ndarray:
        out = np.zeros((self.size,), dtype=np.int32)
        out[: self.n] = np.asarray(bits, dtype=np.int32)[: self.n]
        return out


_TABLE_CACHE: "dict[tuple, CommitteeTable]" = {}
_TABLE_CACHE_CAP = 8
_TABLE_CACHE_LOCK = threading.Lock()


def get_committee_table(serialized_keys, points, device=None) -> CommitteeTable:
    """Per-committee table cache, keyed by the serialized key tuple and
    the device; bounded at 8 tables (a node tracks at most its own and a
    few foreign committees at once).  The table build runs outside the
    lock: a duplicate build loses only work."""
    device = resolve_device(device)
    key = (tuple(serialized_keys), str(device))
    with _TABLE_CACHE_LOCK:
        tbl = _TABLE_CACHE.get(key)
    if tbl is None:
        tbl = CommitteeTable(points, device)
        with _TABLE_CACHE_LOCK:
            if (key not in _TABLE_CACHE
                    and len(_TABLE_CACHE) >= _TABLE_CACHE_CAP):
                _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
            tbl = _TABLE_CACHE.setdefault(key, tbl)
    return tbl


# Pinned batch widths for the replay path: the CPU caps at 64 lanes.
BATCH_BUCKETS_CPU = (8, 64)
BATCH_BUCKETS_GPU = (8, 64, 256)

_VERIFY_BUCKET = 8


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def batch_buckets(device) -> tuple:
    return BATCH_BUCKETS_GPU if _on_card(device) else BATCH_BUCKETS_CPU


def batch_bucket(n: int, device) -> int:
    """Smallest pinned batch width admitting ``n`` lanes, clamped to the
    widest (callers chunk)."""
    for b in batch_buckets(device):
        if n <= b:
            return b
    return batch_buckets(device)[-1]


# -- host paths ----------------------------------------------------------------------


def _ref_agg_verify(table: CommitteeTable, bits, h_point,
                    sig_point) -> bool:
    """Host twin of the quorum check: the fallback off the card when the
    device backend is open-circuited or raised mid-dispatch, and on the
    card for an injected dispatch fault."""
    from .ref import bls as RB
    from .ref.curve import g1

    agg = None
    for pt, bit in zip(table.points, bits):
        if bit:
            agg = g1.add(agg, pt)
    if agg is None:
        return False
    return RB.verify_hashed(agg, h_point, sig_point)


# -- entry points --------------------------------------------------------------------


def agg_verify_on_device(table: CommitteeTable, bits, payload: bytes,
                         sig_point) -> bool:
    """THE FBFT quorum check from the payload bytes: hash-to-G2 on the
    host, then ``agg_verify_hashed_on_device``.  Breaker-guarded."""
    from .ref.hash_to_curve import hash_to_g2

    with prof.stage("hash_to_g2"):
        h_point = hash_to_g2(payload)
    return agg_verify_hashed_on_device(table, bits, h_point, sig_point)


def agg_verify_hashed_on_device(table: CommitteeTable, bits, h_point,
                                sig_point) -> bool:
    """The FBFT quorum check, payload already hashed to G2: committee
    table resident on the table's device, bitmap in, bool out — masked
    G1 tree-sum and the 2-pairing product in one pass.  The shape the
    scheduler submits (hash-to-curve runs on the submitting thread)."""
    COUNTERS.inc("agg_verify")

    def dispatch() -> bool:
        dev = table.device
        bm = table.pad_bits(bits)
        hh = I.g2_affine_to_arr(h_point)
        sg = I.g2_affine_to_arr(sig_point)
        h2d = bm.nbytes + 4 * (hh.numel() + sg.numel())
        TRANSFER.inc("h2d", h2d)
        program = f"agg_verify_b{table.size}"
        first = _program_first_use(program)
        base = _peak_base(first, dev)
        t0 = time.monotonic()
        args = (table.device_array(), torch.from_numpy(bm).to(dev),
                hh.to(dev), sg.to(dev))
        ok = _kernels(dev).agg_verify(*args)
        res = _host_array(ok)
        _record(program, first, time.monotonic() - t0, args, (ok,), base,
                dev)
        TRANSFER.inc("d2h", res.nbytes)
        trace.annotate(program=program, bucket=table.size,
                       jit_cache="miss" if first else "hit",
                       h2d_bytes=h2d, d2h_bytes=res.nbytes)
        return bool(res)

    return _guarded("agg_verify", dispatch,
                    lambda: _ref_agg_verify(table, bits, h_point, sig_point),
                    device=table.device)


def masked_pubkey_sum(points, bits, fallback, cache=None, device=None):
    """The masked sum of a pubkey list as a reference affine point (None
    for infinity), breaker-guarded: the ``g1_masked_sum`` kernel's affine
    form, one launch on the card.

    The NEWVIEW adoption path aggregates a *candidate* mask's pubkeys —
    not this node's own committee, so the table cache doesn't apply.
    ``cache`` is an optional one-slot list holding the device-resident
    padded key table across calls on the same mask: a call that finds it
    ships only the bitmap.  Points and mask pad to
    ``committee_bucket(len(points))`` (one program shape per pinned
    width); pad rows carry zero bits.  Off the card a raising backend
    degrades to the host ``fallback``; with the twins active the fallback
    runs."""
    if kernel_twin_active(device):
        return fallback()
    dev = resolve_device(device)
    COUNTERS.inc("masked_pubkey_sum")

    def dispatch():
        width = committee_bucket(len(points))
        pks = cache[0] if cache is not None else None
        h2d = 0
        if pks is None or not _same_device(pks.device, dev):
            arr = np.zeros((width, 2, 32), dtype=np.int32)
            if points:
                arr[: len(points)] = I.g1_batch_affine(points).numpy()
            pks = torch.from_numpy(arr).to(dev)
            h2d += arr.nbytes
            if cache is not None:
                cache[0] = pks
        bm = np.zeros((width,), dtype=np.int32)
        bm[: len(points)] = np.asarray(bits, dtype=np.int32)
        h2d += bm.nbytes
        TRANSFER.inc("h2d", h2d)
        program = f"masked_sum_w{width}"
        first = _program_first_use(program)
        base = _peak_base(first, dev)
        t0 = time.monotonic()
        args = (pks, torch.from_numpy(bm).to(dev))
        xy = CV.masked_sum_to_affine(*args)
        res = _host_array(xy)
        _record(program, first, time.monotonic() - t0, args, (xy,), base,
                dev)
        TRANSFER.inc("d2h", res.nbytes)
        trace.annotate(program=program, width=width,
                       jit_cache="miss" if first else "hit",
                       h2d_bytes=h2d, d2h_bytes=res.nbytes)
        if not res.any():
            return None
        return (I.arr_to_fp(res[0]), I.arr_to_fp(res[1]))

    return _guarded("masked_pubkey_sum", dispatch, fallback, device=dev)


def _same_device(have: torch.device, want: torch.device) -> bool:
    return have.type == want.type and want.index in (None, have.index)


def agg_verify_batch_on_device(table: CommitteeTable, bits_list,
                               h_points, sig_points) -> list:
    """Replay-path batch: B quorum checks against one committee table,
    chunked to pinned batch widths (pad lanes repeat lane 0 and are
    sliced off).  h_points are pre-hashed payload points; returns
    list[bool].  Breaker-guarded: a backend failure anywhere in the
    batch re-runs the whole window on the host path."""

    def dispatch():
        dev = table.device
        widest = batch_buckets(dev)[-1]
        tbl = table.device_array()
        fn = _kernels(dev).agg_verify_batch
        # dispatch EVERY chunk before syncing ANY result: a per-chunk copy
        # to the host inside this loop would wait on the device between
        # chunks
        pending = []  # (ok, live lane count, program, issue time, args,
        #               peak base)
        h2d = 0
        firsts = []
        for start in range(0, len(bits_list), widest):
            chunk_bits = bits_list[start:start + widest]
            chunk_h = h_points[start:start + widest]
            chunk_s = sig_points[start:start + widest]
            n, padded = len(chunk_bits), batch_bucket(len(chunk_bits), dev)
            sel = list(range(n)) + [0] * (padded - n)
            bm = np.stack([table.pad_bits(chunk_bits[i]) for i in sel])
            hh = I.g2_batch_affine([chunk_h[i] for i in sel])
            sg = I.g2_batch_affine([chunk_s[i] for i in sel])
            h2d += bm.nbytes + 4 * (hh.numel() + sg.numel())
            program = f"agg_verify_batch_b{table.size}x{padded}"
            first = _program_first_use(program)
            base = _peak_base(first, dev)
            t0 = time.monotonic()
            args = (tbl, torch.from_numpy(bm).to(dev), hh.to(dev),
                    sg.to(dev))
            ok = fn(*args)
            COUNTERS.inc("batch_verify")
            pending.append((ok, n, program, t0, args, base))
            firsts.append(first)
        TRANSFER.inc("h2d", h2d)
        results, d2h = [], 0
        for (ok, n, program, t_issue, args, base), first in zip(pending,
                                                                firsts):
            flat = _host_array(ok)
            # issue->drain latency per chunk (queueing behind siblings
            # included)
            _record(program, first, time.monotonic() - t_issue, args,
                    (ok,), base, dev)
            d2h += flat.nbytes
            results.extend(bool(x) for x in flat[:n])
        TRANSFER.inc("d2h", d2h)
        trace.annotate(chunks=len(pending), checks=len(bits_list),
                       first_uses=sum(firsts), h2d_bytes=h2d,
                       d2h_bytes=d2h)
        return results

    def fallback():
        return [_ref_agg_verify(table, bits, h, sig)
                for bits, h, sig in zip(bits_list, h_points, sig_points)]

    return _guarded("batch_verify", dispatch, fallback,
                    device=table.device)


def verify_on_device(pk_point, payload: bytes, sig_point,
                     device=None) -> bool:
    """One check e(-G1, sig) e(pk, H(payload)) == 1.  On the card it pads
    to the pinned width 8 so every single check shares one shape;
    elsewhere (and with the twins) it runs width 1.

    pk_point: reference affine G1 point; sig_point: affine G2 point;
    payload: signed bytes (hash-to-G2 runs on the host).  Breaker-guarded
    with a host fallback."""
    from .ref.hash_to_curve import hash_to_g2

    dev = resolve_device(device)
    with prof.stage("hash_to_g2"):
        h = hash_to_g2(payload)
    COUNTERS.inc("verify")

    def dispatch() -> bool:
        width = _VERIFY_BUCKET if _on_card(dev) else 1
        pk = I.g1_batch_affine([pk_point] * width)
        hh = I.g2_batch_affine([h] * width)
        sg = I.g2_batch_affine([sig_point] * width)
        h2d = 4 * (pk.numel() + hh.numel() + sg.numel())
        TRANSFER.inc("h2d", h2d)
        program = f"verify_w{width}"
        first = _program_first_use(program)
        base = _peak_base(first, dev)
        t0 = time.monotonic()
        args = (pk.to(dev), hh.to(dev), sg.to(dev))
        ok = _kernels(dev).verify(*args)
        res = _host_array(ok)
        _record(program, first, time.monotonic() - t0, args, (ok,), base,
                dev)
        TRANSFER.inc("d2h", res.nbytes)
        trace.annotate(program=program, width=width,
                       jit_cache="miss" if first else "hit",
                       h2d_bytes=h2d, d2h_bytes=res.nbytes)
        return bool(res[0])

    def fallback() -> bool:
        from .ref import bls as RB

        return RB.verify_hashed(pk_point, h, sig_point)

    return _guarded("verify", dispatch, fallback, device=dev)


def verify_many_on_device(pk_points, h_points, sig_points,
                          device=None) -> list:
    """N *independent* single checks — distinct keys, distinct payload
    points — in pinned-width batches (on the card and with the twins;
    elsewhere each chunk runs at its own width): the continuous-batching
    shape the scheduler feeds with coalesced tx-pool / RPC traffic.
    h_points are pre-hashed payload G2 points.  Pad lanes are affine
    infinity, sliced off before return.  Breaker-guarded; the fallback
    re-checks each lane on the host."""
    dev = resolve_device(device)
    n_total = len(pk_points)
    COUNTERS.inc("verify", n_total)

    def dispatch():
        widest = batch_buckets(dev)[-1]
        pad_to_bucket = _on_card(dev) or kernel_twin_active(dev)
        fn = _kernels(dev).verify
        pending = []  # (ok, live lane count, program, issue time, args,
        #               peak base)
        h2d = 0
        firsts = []
        for start in range(0, n_total, widest):
            chunk_pk = pk_points[start:start + widest]
            chunk_h = h_points[start:start + widest]
            chunk_s = sig_points[start:start + widest]
            n = len(chunk_pk)
            padded = batch_bucket(n, dev) if pad_to_bucket else n
            pk = _pad_lanes(I.g1_batch_affine(chunk_pk), padded - n)
            hh = _pad_lanes(I.g2_batch_affine(chunk_h), padded - n)
            sg = _pad_lanes(I.g2_batch_affine(chunk_s), padded - n)
            h2d += 4 * (pk.numel() + hh.numel() + sg.numel())
            program = f"verify_w{padded}"
            first = _program_first_use(program)
            base = _peak_base(first, dev)
            t0 = time.monotonic()
            args = (pk.to(dev), hh.to(dev), sg.to(dev))
            pending.append((fn(*args), n, program, t0, args, base))
            firsts.append(first)
        TRANSFER.inc("h2d", h2d)
        results, d2h = [], 0
        for (ok, n, program, t_issue, args, base), first in zip(pending,
                                                                firsts):
            flat = _host_array(ok)
            _record(program, first, time.monotonic() - t_issue, args,
                    (ok,), base, dev)
            d2h += flat.nbytes
            results.extend(bool(x) for x in flat[:n])
        TRANSFER.inc("d2h", d2h)
        trace.annotate(chunks=len(pending), checks=n_total,
                       first_uses=sum(firsts), h2d_bytes=h2d,
                       d2h_bytes=d2h)
        return results

    def fallback():
        from .ref import bls as RB

        return [RB.verify_hashed(pk, h, sig)
                for pk, h, sig in zip(pk_points, h_points, sig_points)]

    return _guarded("verify_many", dispatch, fallback, device=dev)


def _pad_lanes(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Append ``pad`` lanes of affine infinity (all-zero limbs)."""
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


# -- warmup: each family's device program at a pinned shape ------------------

# The device program behind each family of ``aot``'s manifest: the
# counterparts of the JAX package's ``_get_*_fn``.
PROGRAMS = {"agg_verify": OB.agg_verify,
            "agg_verify_batch": OB.agg_verify_batch,
            "verify": OB.verify,
            "masked_sum": CV.masked_sum_to_affine}


def warm(family: str, shapes: tuple, device=None) -> None:
    """Run ``family``'s device program once on pad inputs of ``shapes``
    (a manifest program's, ``aot.program_spec``): all-zero int32 limbs,
    which are what the entry points pad with (affine infinity, (0, 0),
    for keys and points; zero bitmap words).  As an entry point does, the
    inputs are made on the host and copied to the device, and the result
    is copied back, which waits for the card.  Under ``BREAKER``: a
    failure, or an OPEN breaker, raises ``DeviceError`` and nothing runs
    on the host in its place.  No entry point's counter moves."""
    dev = resolve_device(device)
    if not BREAKER.allow():
        raise DeviceError(f"device breaker open: {family} not warmed")
    try:
        _host_array(PROGRAMS[family](
            *(torch.zeros(shape, dtype=torch.int32).to(dev)
              for shape in shapes)))
    except Exception as e:  # noqa: BLE001 — any backend failure
        BREAKER.record_failure()
        raise DeviceError(f"warming {family} at {shapes} failed: {e}") from e
    BREAKER.record_success()


def expose_metrics() -> str:
    """The device families in Prometheus text: checks by kind, the twin
    switch, dispatch latency, transfer bytes, program shapes seen."""
    out = [
        "# HELP harmony_device_checks_total verification checks "
        "executed on the device path",
        "# TYPE harmony_device_checks_total counter",
    ]
    for kind, v in COUNTERS.items():
        out.append(f'harmony_device_checks_total{{kind="{kind}"}} {v}')
    out.append(
        "# HELP harmony_device_kernel_twin device kernels are the "
        "host-backed twins (1) vs the hand kernels (0)\n"
        "# TYPE harmony_device_kernel_twin gauge\n"
        f"harmony_device_kernel_twin {1 if kernel_twin_active() else 0}")
    out.append(DISPATCH_SECONDS.expose())
    out.append(
        "# HELP harmony_device_transfer_bytes_total host<->device "
        "bytes shipped by dispatches\n"
        "# TYPE harmony_device_transfer_bytes_total counter")
    for direction, v in TRANSFER.items():
        out.append("harmony_device_transfer_bytes_total"
                   f'{{direction="{direction}"}} {v}')
    out.append(
        "# HELP harmony_device_jit_programs_total dispatches that "
        "reused (hit) vs first used (miss) a program shape\n"
        "# TYPE harmony_device_jit_programs_total counter")
    for kind, v in JIT.items():
        out.append(f'harmony_device_jit_programs_total{{cache="{kind}"}} {v}')
    out.append(JIT_COMPILE_SECONDS.expose())
    return "\n".join(out)
