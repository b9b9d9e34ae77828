"""Durable span export: a bounded, rotating JSONL sink per node.

The tracer's in-memory store is a 4096-span ring that dies with the
process; forensics across restarts — and across the *separate*
processes of a real multi-node deployment — needs spans on disk.  One
``SpanSink`` per process subscribes to ``trace.set_export_hook`` and
writes every finished span as one JSON line.

Discipline (the same rules every other long-lived thread here obeys):

- **Hot path is one queue append.**  The hook runs inside
  ``trace.finish`` on consensus/device threads, so it does nothing but
  ``put_nowait``; serialization and I/O happen on the writer thread.
  A full queue *drops* (counted) — backpressure must never reach the
  span lifecycle.
- **GL14**: the writer is role-annotated (``obs.sink``), registered
  with the watchdog, beats per batch and idles before parking.
- **Bounded disk**: size-based rotation, ``keep`` rotated files per
  sink — a week-long soak cannot blow out the trace directory.
- **GL13 on the way back in**: ``read_spans`` budget-checks each
  record's length *before* parsing and skips garbage without raising —
  sink files travel from other machines and may be truncated mid-line
  by the crash being investigated.

The port's copy of the JAX package's ``obs/sink.py``.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading

from .. import health, trace

_MAX_RECORD = 64 * 1024  # bytes per JSONL record, read AND write side
_QUEUE_CAP = 4096
_MAX_BYTES = 8 * 1024 * 1024  # per active file before rotation
_KEEP = 2  # rotated generations kept besides the active file
_POLL_S = 5.0  # writer wake cadence (beats bound the watchdog age)

_SAFE_TAG = re.compile(r"[^A-Za-z0-9_.\-]")


def _span_fields(d: dict) -> bool:
    return (isinstance(d, dict) and isinstance(d.get("trace_id"), str)
            and isinstance(d.get("span_id"), str)
            and isinstance(d.get("name"), str)
            and isinstance(d.get("ts"), (int, float)))


class SpanSink:
    """Rotating JSONL writer for finished spans.

    ``arm()`` installs the export hook and spawns the writer;
    ``close()`` drains, unhooks and deregisters.  One sink per process
    — arming a second sink replaces the first's hook (last wins), so
    operators compose it with the flight recorder, not with itself.
    """

    def __init__(self, directory: str, node: str | None = None,
                 max_bytes: int = _MAX_BYTES, keep: int = _KEEP,
                 queue_cap: int = _QUEUE_CAP):
        self.directory = directory
        self.node = node or trace.current_node() or f"pid{os.getpid()}"
        self.max_bytes = int(max_bytes)
        self.keep = max(0, int(keep))
        self.dropped = 0  # queue-full + oversize records (GIL-atomic)
        self.written = 0
        self._tag = _SAFE_TAG.sub("_", self.node)[:64]
        self._q: queue.Queue = queue.Queue(maxsize=queue_cap)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._hb = None
        self._file = None
        self._file_bytes = 0

    # -- hot path (trace.finish) --------------------------------------------

    def _hook(self, span) -> None:
        try:
            self._q.put_nowait(span)
        except queue.Full:
            self.dropped += 1

    # -- lifecycle -----------------------------------------------------------

    def path(self) -> str:
        return os.path.join(self.directory, f"spans_{self._tag}.jsonl")

    def files(self) -> list:
        """Active + rotated files, newest first (the read order)."""
        out = [self.path()]
        out.extend(f"{self.path()}.{i}" for i in range(1, self.keep + 1))
        return [p for p in out if os.path.exists(p)]

    def arm(self) -> "SpanSink":
        if self._thread is not None:
            return self
        os.makedirs(self.directory, exist_ok=True)
        self._hb = health.register(
            f"obs.sink[{self._tag}]", max_age_s=4 * _POLL_S,
        )
        t = threading.Thread(  # graftlint: thread-role=obs.sink
            target=self._loop, name=f"obs-sink-{self._tag}", daemon=True,
        )
        self._thread = t
        self._hb.bind(t)
        t.start()
        trace.set_export_hook(self._hook)
        return self

    def close(self, timeout: float = 5.0) -> None:
        """Unhook, drain what's queued, stop the writer."""
        trace.set_export_hook(None)
        if self._thread is None:
            return
        self._stop.set()
        try:
            self._q.put_nowait(None)  # wake the writer past its poll
        except queue.Full:  # timeout; a full queue wakes it anyway
            pass
        self._thread.join(timeout=timeout)
        self._thread = None
        if self._hb is not None:
            self._hb.close()
            self._hb = None

    # -- writer thread -------------------------------------------------------

    def _loop(self) -> None:
        hb = self._hb
        try:
            while True:
                hb.idle()  # parking in a bounded get: healthy wait
                try:
                    span = self._q.get(timeout=_POLL_S)
                except queue.Empty:
                    if self._stop.is_set():
                        break
                    continue
                if span is None:
                    if self._stop.is_set() and self._q.empty():
                        break
                    continue
                hb.beat()
                self._write(span)
                # drain the burst without re-parking per span
                while True:
                    try:
                        span = self._q.get_nowait()
                    except queue.Empty:
                        break
                    if span is not None:
                        self._write(span)
                if self._file is not None:
                    try:
                        self._file.flush()
                    except OSError:
                        pass
                if self._stop.is_set() and self._q.empty():
                    break
        finally:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None

    def _write(self, span) -> None:
        try:
            line = json.dumps(span.to_dict(), separators=(",", ":"),
                              default=str)
        except Exception:  # noqa: BLE001 — one unserializable attr
            self.dropped += 1  # must not kill the sink
            return
        if len(line) > _MAX_RECORD:
            self.dropped += 1  # oversize record: writer enforces the
            return  # same budget the reader checks (GL13 both ways)
        try:
            if self._file is None:
                self._file = open(self.path(), "a", encoding="utf-8")
                self._file_bytes = self._file.tell()
            self._file.write(line + "\n")
            self._file_bytes += len(line) + 1
            self.written += 1
            if self._file_bytes >= self.max_bytes:
                self._rotate()
        except OSError:
            self.dropped += 1  # full/unwritable disk: drop, never raise

    def _rotate(self) -> None:
        try:
            self._file.close()
        except OSError:
            pass
        self._file = None
        self._file_bytes = 0
        base = self.path()
        try:
            for i in range(self.keep, 0, -1):
                src = base if i == 1 else f"{base}.{i - 1}"
                if os.path.exists(src):
                    os.replace(src, f"{base}.{i}")
            if self.keep == 0:
                os.remove(base)
        except OSError:
            pass


# -- reader ------------------------------------------------------------------


def read_spans(paths) -> list:
    """Load span dicts from sink files (a str path or an iterable).

    Wire-taint discipline: each line's length is budget-checked before
    ``json.loads`` allocates on it; oversize lines are skipped by
    chunked reads (never buffered whole), garbled JSON and records
    missing the span schema are dropped.  Content never raises —
    truncated-by-crash files are exactly the interesting ones."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out = []
    for path in paths:
        try:
            f = open(path, "r", encoding="utf-8", errors="replace")
        except OSError:
            continue
        with f:
            while True:
                line = f.readline(_MAX_RECORD + 1)
                if not line:
                    break
                if len(line) > _MAX_RECORD and not line.endswith("\n"):
                    # oversize record: skip to the next newline in
                    # bounded chunks — the budget bounds allocation,
                    # not just parse cost
                    while True:
                        chunk = f.readline(_MAX_RECORD)
                        if not chunk or chunk.endswith("\n"):
                            break
                    continue
                line = line.strip()
                if not line:
                    continue
                try:
                    d = json.loads(line)
                except ValueError:
                    continue
                if _span_fields(d):
                    out.append(d)
    return out
