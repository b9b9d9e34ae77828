"""Kernel-stage profiler: where does a verification's time actually go?

The port's copy of the JAX package's ``prof.py``, with three surfaces:

1. **Stage spans** — ``with prof.stage("hash_to_g2"):`` at the
   host-visible stage boundaries of the pairing pipeline.  Each stage
   records into a per-stage wall-time histogram AND opens a
   ``prof.stage`` trace span, so stages nest under the round trace.
   Disabled cost is one module-bool comparison (the same discipline as
   trace.py — this sits on the verify path).  ``stage_summary()`` is the
   report surface.

2. **Program registry** — ``device.py`` reports every program shape's
   FIRST dispatch here (under torch: the first launch at a program's
   shape, which pays the kernel library's load and the first copies).
   The registry stores that dispatch's wall time always; when the
   profiler is armed it adds the port's counterpart of the JAX package's
   XLA cost analysis under the same keys (``_cost_analysis``): the
   program's integer operations (``flops``), its argument and output
   bytes, and the allocator's peak over that dispatch.  Every later
   dispatch feeds a per-program execute-seconds histogram.  All of it
   exposes as the ``harmony_prof_*`` families.

3. **Capture hook** — ``with prof.capture():`` records a
   ``torch.profiler`` trace of the block (CPU and, on the card, CUDA
   activity) and writes it as Chrome trace JSON into
   ``HARMONY_TPU_PROFILE_DIR`` or the directory passed, loadable in
   Perfetto.  Nested captures share the outer trace: ``torch.profiler``
   runs one profiler at a time.

Stdlib + metrics/trace at import; torch is touched lazily and only
behind the capture hook.
"""

from __future__ import annotations

import os
import threading
import time

from . import trace
from .metrics import Histogram

# The four pipeline stages of PERF_MODEL §1 (plus free-form extras the
# bench tools add).  Order is the exposition order.
STAGES = ("hash_to_g2", "montmul", "miller_loop", "final_exp")

_STAGE_BUCKETS = (1e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                  1.0, 5.0)
_EXEC_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
                 5.0, 30.0)
_COMPILE_BUCKETS = (0.01, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0)

_MAX_LABELS = 64  # program/stage cardinality bound (pinned buckets
# keep the real set ~a dozen; a runaway label namer must not grow the
# exposition without bound)

_enabled = False
_lock = threading.Lock()  # guards the dicts below; never held across
# anything blocking (histogram observes run on the objects' own locks)
_stage_hist: dict[str, Histogram] = {}
_exec_hist: dict[str, Histogram] = {}
_compile_hist: dict[str, Histogram] = {}
_programs: dict[str, dict] = {}  # program -> {compile_s, flops, ...}

_capture_lock = threading.Lock()
_capture_depth = 0  # nested capture() blocks share one profiler
_capture_profiler = None  # the torch.profiler recording, if one is
_capture_path: str | None = None  # where that recording is written


def configure(enabled: bool | None = None) -> None:
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)


def enabled() -> bool:
    """Armed via ``configure`` or HARMONY_TPU_PROF=1 in the
    environment (checked once at first call after reset)."""
    return _enabled


def arm_from_env() -> bool:
    """Apply HARMONY_TPU_PROF=1 (re-applied at import below, callable
    again after a reset)."""
    if os.environ.get("HARMONY_TPU_PROF") == "1":
        configure(enabled=True)
    return _enabled


def reset() -> None:
    """Disarm and drop all recorded data (test teardown)."""
    global _enabled
    _enabled = False
    with _lock:
        _stage_hist.clear()
        _exec_hist.clear()
        _compile_hist.clear()
        _programs.clear()


def _labeled(store: dict, name: str, family: str, help_: str,
             buckets, label: str) -> Histogram | None:
    with _lock:
        h = store.get(name)
        if h is None:
            if len(store) >= _MAX_LABELS:
                return None  # cardinality bound: drop, never grow
            h = Histogram(family, help_, buckets=buckets,
                          labels={label: name})
            store[name] = h
        return h


# -- stage spans -------------------------------------------------------------


class _NoopStage:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopStage()


class _Stage:
    __slots__ = ("name", "_t0", "_span")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self._span = trace.span("prof.stage", component="prof",
                                stage=name, **attrs)
        self._t0 = 0.0

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = time.monotonic() - self._t0
        h = _labeled(
            _stage_hist, self.name, "harmony_prof_stage_seconds",
            "wall time per pairing-pipeline stage",
            _STAGE_BUCKETS, "stage",
        )
        if h is not None:
            h.observe(dt)
        self._span.__exit__(exc_type, exc, tb)
        return False


def stage(name: str, **attrs):
    """``with prof.stage("miller_loop"):`` — one timed pipeline stage,
    recorded as a histogram sample and (when tracing is armed) a
    ``prof.stage`` span nested under the caller's current span.
    Disabled cost: one comparison."""
    if not _enabled:
        return _NOOP
    return _Stage(name, attrs)


def stage_summary() -> dict:
    """{stage: {count, sum_s, p50_s, p99_s}} of everything recorded —
    the bench tools' report surface (no bucket parsing)."""
    with _lock:
        hists = dict(_stage_hist)
    return {name: h.summary() for name, h in hists.items()}


# -- program registry --------------------------------------------------------


def observe_execute(program: str, seconds: float) -> None:
    """One dispatch of a known program shape (post result-sync)."""
    if not _enabled:
        return
    h = _labeled(
        _exec_hist, program, "harmony_prof_execute_seconds",
        "wall time of one dispatch per program shape",
        _EXEC_BUCKETS, "program",
    )
    if h is not None:
        h.observe(seconds)


def on_first_dispatch(program: str, seconds: float, args: tuple = (),
                      out: tuple = (), peak_bytes: int | None = None
                      ) -> None:
    """device.py's hook at the one dispatch per program shape that
    paid the first use: records its wall time, and — when the profiler
    is armed — the program's cost (``_cost_analysis``) from its argument
    and output tensors and the allocator's peak over the dispatch
    (``peak_bytes``, None off the card).  Never raises into the dispatch
    path."""
    h = _labeled(
        _compile_hist, program, "harmony_prof_compile_seconds",
        "wall time of the first dispatch per program shape",
        _COMPILE_BUCKETS, "program",
    )
    if h is not None:
        h.observe(seconds)
    entry = {"compile_s": seconds}
    if _enabled:
        entry.update(_cost_analysis(program, args, out, peak_bytes))
    with _lock:
        if len(_programs) < _MAX_LABELS or program in _programs:
            _programs.setdefault(program, {}).update(entry)


# Montgomery products per lane that the kernels' plans fix, counted as
# PERF.md §6 counts a bound, and the int32 IMAD of one product
MONT_IMAD = 2 * 288
MILLER_PRODUCTS = 63 * (36 + 54 + 34) + 5 * (54 + 44)  # one pair
FP12_MUL_PRODUCTS = 54  # the product of a check's two Miller values
FINAL_EXP_PRODUCTS = 315 * 18 + 34 * 54 + 36 + 112 + 3 * 18
# one single check: two pairs' Miller loops, their product, the final
# exponentiation
CHECK_PRODUCTS = 2 * MILLER_PRODUCTS + FP12_MUL_PRODUCTS + FINAL_EXP_PRODUCTS


def masked_sum_products(n: int) -> int:
    """Products of one lane of the masked G1 sum over a table of ``n``
    (a power of two) affine keys, every key selected: n/2 adds of two
    points with Z = 1 (6 products), n/2 - 1 adds of two Jacobian points
    (16), and 4 for the affine form."""
    return 6 * (n // 2) + 16 * (n // 2 - 1) + 4


def program_operations(program: str) -> int | None:
    """int32 operations of one run of a manifest program with every lane
    live: its Montgomery products at ``MONT_IMAD`` each.  The inversions'
    GCD steps, whose count depends on the data, are left out.  None for
    a name that is not a manifest program."""
    from . import aot

    spec = aot.program_spec(program)
    if spec is None:
        return None
    family, dims, _ = spec
    if family == "agg_verify":
        products = masked_sum_products(dims[0]) + CHECK_PRODUCTS
    elif family == "agg_verify_batch":
        products = dims[1] * (masked_sum_products(dims[0]) + CHECK_PRODUCTS)
    elif family == "verify":
        products = dims[0] * CHECK_PRODUCTS
    else:  # masked_sum
        products = masked_sum_products(dims[0])
    return products * MONT_IMAD


def _nbytes(xs) -> int:
    return sum(int(x.nbytes) for x in xs if hasattr(x, "nbytes"))


def _cost_analysis(program: str, args: tuple, out: tuple,
                   peak_bytes: int | None) -> dict:
    """The port's view of one program: its integer operations
    (``flops``, under the JAX package's key), the bytes of its argument
    and output tensors and their sum (``bytes_accessed``: each read or
    written once), and ``peak_memory_bytes``, the allocator's peak over
    the dispatch above what was allocated when it began."""
    out_ = {}
    try:
        ops = program_operations(program)
        if ops is not None:
            out_["flops"] = float(ops)
        arg_b, out_b = _nbytes(args), _nbytes(out)
        out_["argument_bytes"] = float(arg_b)
        out_["output_bytes"] = float(out_b)
        out_["bytes_accessed"] = float(arg_b + out_b)
        if peak_bytes is not None:
            out_["peak_memory_bytes"] = float(peak_bytes)
    except Exception:  # noqa: BLE001 — profiling must not break dispatch
        pass
    return out_


def programs() -> dict:
    """Snapshot of the program registry: {program: {compile_s, flops,
    bytes_accessed, peak_memory_bytes, ...}}."""
    with _lock:
        return {k: dict(v) for k, v in _programs.items()}


# -- capture hook ------------------------------------------------------------


def capture_dir() -> str | None:
    return os.environ.get("HARMONY_TPU_PROFILE_DIR") or None


class _Capture:
    __slots__ = ("dir", "path", "_counted")

    def __init__(self, directory: str | None):
        self.dir = directory
        self.path = None  # the trace file this block records into
        self._counted = False  # this handle is in _capture_depth

    def __enter__(self):
        global _capture_depth, _capture_profiler, _capture_path
        if self.dir is None:
            return self
        # the profiler starts UNDER the lock: the whole enter is atomic,
        # so a failed start can never strand the depth counter while a
        # sibling thread slips in between count and start
        with _capture_lock:
            if _capture_depth == 0:
                try:
                    import torch
                    from torch.profiler import ProfilerActivity, profile

                    activities = [ProfilerActivity.CPU]
                    if torch.cuda.is_available():
                        activities.append(ProfilerActivity.CUDA)
                    os.makedirs(self.dir, exist_ok=True)
                    recording = profile(activities=activities)
                    recording.start()
                except Exception:  # noqa: BLE001 — capture is
                    # best-effort; the measurement it wraps must
                    # proceed uninstrumented (and uncounted)
                    return self
                _capture_profiler = recording
                _capture_path = os.path.join(
                    self.dir, f"harmony_tpu_torch.{os.getpid()}."
                    f"{time.time_ns()}.pt.trace.json")
            _capture_depth += 1
            self._counted = True
            self.path = _capture_path
        return self

    def __exit__(self, *exc):
        global _capture_depth, _capture_profiler, _capture_path
        if not self._counted:
            return False
        # the trace stops when the LAST counted handle leaves — never
        # while a sibling capture is still inside (ownership follows
        # the depth counter, not whichever handle happened to start)
        recording = None
        with _capture_lock:
            _capture_depth -= 1
            if _capture_depth == 0 and _capture_profiler is not None:
                recording, path = _capture_profiler, _capture_path
                _capture_profiler = _capture_path = None
        if recording is not None:
            try:
                recording.stop()
                recording.export_chrome_trace(path)
            except Exception:  # noqa: BLE001 — same best-effort contract
                pass
        return False


def capture(directory: str | None = None):
    """``with prof.capture() as c:`` — a torch.profiler trace of the
    wrapped block lands in ``HARMONY_TPU_PROFILE_DIR`` (or
    ``directory``) as Chrome trace JSON at ``c.path``, loadable in
    Perfetto.  Without a directory configured the block runs
    uninstrumented (``c.path`` None); nested captures share the outer
    trace."""
    return _Capture(directory or capture_dir())


# -- exposition --------------------------------------------------------------

_PROGRAM_GAUGES = (
    ("flops", "harmony_prof_program_flops",
     "int32 operations per program (Montgomery products x 576 IMAD)"),
    ("bytes_accessed", "harmony_prof_program_bytes_accessed",
     "argument and output bytes per program"),
    ("peak_memory_bytes", "harmony_prof_program_peak_memory_bytes",
     "allocator peak over the first dispatch above its start, per "
     "program"),
    ("compile_s", "harmony_prof_program_compile_seconds",
     "wall time of the first dispatch per program"),
)


def expose() -> str:
    """The harmony_prof_* Prometheus families (metrics.Registry hook)."""
    with _lock:
        stages = [_stage_hist[k] for k in sorted(_stage_hist)]
        execs = [_exec_hist[k] for k in sorted(_exec_hist)]
        compiles = [_compile_hist[k] for k in sorted(_compile_hist)]
        progs = {k: dict(v) for k, v in sorted(_programs.items())}
    out = []
    for family in (stages, execs, compiles):
        for i, h in enumerate(family):
            lines = h.expose().splitlines()
            out.append("\n".join(lines if i == 0 else lines[2:]))
    for key, name, help_ in _PROGRAM_GAUGES:
        rows = [(p, v[key]) for p, v in progs.items() if key in v]
        if not rows:
            continue
        lines = [f"# HELP {name} {help_}", f"# TYPE {name} gauge"]
        lines.extend(
            f'{name}{{program="{p}"}} {val:g}' for p, val in rows
        )
        out.append("\n".join(lines))
    return "\n".join(x for x in out if x)


# HARMONY_TPU_PROF=1 arms the profiler for the whole process the
# moment any layer imports this module (device.py does at startup) —
# the documented operator path needs no code hook.
arm_from_env()
