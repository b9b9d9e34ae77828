"""Structured per-module logging — the role of the reference's zerolog
wrapper (reference: internal/utils/logging.go GetLogger/SetLogContext:
a process-wide sink, per-module child loggers, bound context fields on
every line).  The port's copy of the JAX package's ``log.py``, stdlib
only.

Design: one process-wide sink (stderr by default, or a file), JSON
lines (zerolog's wire shape), per-module child loggers carrying bound
context (shard, port, consensus fields) merged into every record.
Level checks short-circuit before any formatting so disabled-level
calls cost one comparison — this sits inside the consensus pump.

    from harmony_tpu_torch.log import get_logger
    log = get_logger("consensus", shard=0)
    log.info("quorum reached", phase="prepare", block=42)
    round_log = log.with_fields(view_id=7)
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

from . import trace as _trace

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40
_LEVEL_NAMES = {DEBUG: "debug", INFO: "info", WARN: "warn", ERROR: "error"}
_NAME_LEVELS = {v: k for k, v in _LEVEL_NAMES.items()}


class _Sink:
    """Process-wide destination; swap with init_logging."""

    def __init__(self):
        self.level = _NAME_LEVELS.get(
            os.environ.get("HARMONY_TPU_LOG", "info").lower(), INFO
        )
        self.stream = sys.stderr
        self._file = None
        self._lock = threading.Lock()

    def configure(self, level: str | int | None = None,
                  path: str | None = None, stream=None):
        if level is not None:
            self.level = (
                level if isinstance(level, int)
                else _NAME_LEVELS[level.lower()]
            )
        if path is not None:
            if self._file is not None:
                self._file.close()
            self._file = open(path, "a", buffering=1)
            self.stream = self._file
        elif stream is not None:
            self.stream = stream

    def emit(self, record: dict):
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            try:
                self.stream.write(line + "\n")
            except ValueError:
                pass  # closed stream during shutdown


_SINK = _Sink()


def init_logging(level: str | int | None = None, path: str | None = None,
                 stream=None):
    """Configure the process sink (reference: utils.SetLogVerbosity +
    AddLogFile).  level: 'debug'|'info'|'warn'|'error' or int."""
    _SINK.configure(level, path, stream)


def set_level(level: str | int):
    _SINK.configure(level=level)


class Logger:
    """A module logger with bound context fields."""

    __slots__ = ("module", "ctx")

    def __init__(self, module: str, ctx: dict | None = None):
        self.module = module
        self.ctx = ctx or {}

    def with_fields(self, **fields) -> "Logger":
        merged = dict(self.ctx)
        merged.update(fields)
        return Logger(self.module, merged)

    def _log(self, level: int, msg: str, fields: dict):
        if level < _SINK.level:
            return
        record = {
            "ts": round(time.time(), 3),
            "level": _LEVEL_NAMES[level],
            "module": self.module,
            "msg": msg,
        }
        # correlate with the active trace span (one comparison when
        # tracing is disabled) — the flight recorder joins spans and
        # log lines on these ids
        ids = _trace.current_ids()
        if ids is not None:
            record["trace_id"], record["span_id"] = ids
        if self.ctx:
            record.update(self.ctx)
        if fields:
            record.update(fields)
        _trace.record_log(record)
        _SINK.emit(record)

    def debug(self, msg: str, **fields):
        self._log(DEBUG, msg, fields)

    def info(self, msg: str, **fields):
        self._log(INFO, msg, fields)

    def warn(self, msg: str, **fields):
        self._log(WARN, msg, fields)

    def error(self, msg: str, **fields):
        self._log(ERROR, msg, fields)

    def enabled(self, level: int = DEBUG) -> bool:
        """For guarding expensive field computation."""
        return level >= _SINK.level


_REGISTRY: dict = {}
_REG_LOCK = threading.Lock()


def get_logger(module: str, **ctx) -> Logger:
    """Module logger; repeated calls with the same (module, no-ctx)
    return the shared instance (reference: per-package utils.Logger)."""
    if ctx:
        return Logger(module, ctx)
    with _REG_LOCK:
        lg = _REGISTRY.get(module)
        if lg is None:
            lg = _REGISTRY[module] = Logger(module)
        return lg
