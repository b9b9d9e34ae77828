"""Live profiling endpoint: the pprof service, Python-shaped.

The role of the reference's pprof service (reference:
api/service/pprof/service.go — net/http/pprof mounted on a debug
listener; cmd/harmony wires it behind --pprof flags).  Go's pprof
surface maps onto the Python runtime as:

    /debug/pprof/            -> index
    /debug/pprof/goroutine   -> every live thread's stack (the Go
                                "goroutine" profile == thread dump)
    /debug/pprof/profile?seconds=N
                             -> statistical CPU profile: samples
                                sys._current_frames at ~100 Hz for N
                                seconds, reports flat sample counts
                                per frame (folded-stack text, the
                                format flamegraph tooling eats)
    /debug/pprof/heap        -> tracemalloc top allocation sites
                                (starts tracing on first use)
    /debug/pprof/threadz     -> thread table: name, ident, daemon

Text output throughout — the operator's consumers are curl and
flamegraph scripts, not the binary protobuf toolchain.  Like the
reference, the service binds localhost by default and is OFF unless a
port is configured (cli --pprof-port).

The port's copy of the JAX package's ``pprof.py``, stdlib only.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_INDEX = """harmony-tpu pprof
/debug/pprof/goroutine   thread stack dump
/debug/pprof/profile     CPU profile (?seconds=5, folded stacks)
/debug/pprof/heap        top allocation sites (tracemalloc)
/debug/pprof/threadz     thread table
"""


def thread_dump() -> str:
    """All live threads' stacks — the goroutine-profile analog."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(
            f"thread {names.get(ident, '?')} (ident {ident}):\n"
            + "".join(traceback.format_stack(frame))
        )
    return "\n".join(out)


def cpu_profile(seconds: float = 5.0, hz: float = 100.0) -> str:
    """Statistical sampler over every thread, folded-stack output.

    ``sys._current_frames`` costs one dict build per tick — cheap
    enough that sampling a live node does not distort it, unlike
    cProfile's per-call tracing (which also only sees one thread).
    """
    counts: collections.Counter = collections.Counter()
    period = 1.0 / hz
    deadline = time.monotonic() + seconds
    me = threading.get_ident()
    n = 0
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue  # the sampler itself is noise
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name}@{code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}")
                f = f.f_back
            counts[";".join(reversed(stack))] += 1
        n += 1
        time.sleep(period)
    lines = [f"# {n} ticks @ {hz:g} Hz over {seconds:g}s"]
    for stack, c in counts.most_common():
        lines.append(f"{stack} {c}")
    return "\n".join(lines)


def heap_profile(top: int = 32) -> str:
    """tracemalloc top allocation sites; tracing starts on first call
    (so the first response only covers allocations made after it)."""
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return "# tracemalloc started; allocations record from now"
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:top]
    total = sum(s.size for s in snap.statistics("filename"))
    lines = [f"# tracked total {total} bytes"]
    for s in stats:
        lines.append(f"{s.traceback} size={s.size} count={s.count}")
    return "\n".join(lines)


def threadz() -> str:
    lines = []
    for t in threading.enumerate():
        lines.append(
            f"{t.name} ident={t.ident} daemon={t.daemon} "
            f"alive={t.is_alive()}"
        )
    return "\n".join(lines)


def handle(path: str, params: dict) -> str | None:
    """Route one /debug/pprof request to its profile; None = unknown
    path.  The ONE routing table for every debug listener — both
    PprofServer and metrics.MetricsServer mount this."""
    if path in ("/", "/debug/pprof", "/debug/pprof/"):
        return _INDEX
    if path in ("/debug/pprof/goroutine", "/debug/pprof/stacks"):
        # /stacks kept as an operator-facing alias of the old metrics
        # endpoint name
        return thread_dump()
    if path == "/debug/pprof/profile":
        secs = min(float(params.get("seconds", 5)), 120.0)
        return cpu_profile(secs)
    if path == "/debug/pprof/heap":
        return heap_profile()
    if path == "/debug/pprof/threadz":
        return threadz()
    return None


class PprofServer:
    """Serves the profiles over localhost HTTP (reference:
    api/service/pprof/service.go Start/Stop lifecycle)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                path, _, query = self.path.partition("?")
                params = dict(
                    kv.split("=", 1) for kv in query.split("&") if "=" in kv
                )
                try:
                    body = handle(path, params)
                    if body is None:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001 — debug surface
                    self.send_error(500, str(e))
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="pprof-server",
        )

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        if self._thread.is_alive():
            self._httpd.shutdown()
        self._httpd.server_close()
