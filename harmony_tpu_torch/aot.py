"""Warmup: no first use of a program on a serving path.

The port's counterpart of the JAX package's ``aot.py``.  There a program
is an XLA executable per pinned shape, compiled (or loaded from a
content-addressed cache) before the node serves.  Here every program runs
from ONE kernel library (``kernels/_build.py``, nvcc, sm_90a), and a
program's first use on the card pays the library's build or load, the
first launches of its kernels and the allocator's first blocks at its
shape.  :func:`warmup` pays them at boot, for every program of the
port's own manifest (``load_manifest``: the 43 names the pinned bucket
registries of ``device.py`` give, the same as the JAX package's
committed manifest), then marks each program warm (``device.mark_warm``)
so that its first serving call counts a JIT hit.

The content-addressed executable cache maps onto the library itself,
whose file name carries the hash of its sources, flags and constants
(``_build.library_path()``).  Cache traffic counts
``harmony_aot_cache_total{event}``: ``hit`` (the library was present and
loaded), ``miss`` and ``store`` (nvcc built it), ``corrupt`` (a present
library failed to load, was unlinked and rebuilt), ``skew`` (the build
directory held only libraries of another hash).

Failures never take a node down: each failed program logs once, counts
``harmony_aot_fallback_total{reason}`` and is not marked warm.  Nothing
falls back to a plain version: the next entry-point call at that shape
dispatches to the card as it would have without warmup, and raises
``device.DeviceError`` if the card still fails.

The JAX package's second layer, shipped ``jax.export`` artifacts
(``load``), and its serialized executables have no counterpart: the port
has no per-program executable to ship or resolve.
"""

from __future__ import annotations

import re
import threading
import time

from .log import get_logger
from .metrics import Counter

log = get_logger("aot")

FALLBACKS = Counter(
    "harmony_aot_fallback_total",
    "warmup programs that failed (not marked warm), by reason",
)
CACHE_EVENTS = Counter(
    "harmony_aot_cache_total",
    "kernel-library cache events at warmup, by event",
)

_warned: set = set()
_lock = threading.Lock()


def expose() -> str:
    """Prometheus exposition for this module's counter families
    (hooked from metrics.Registry)."""
    return "\n".join((FALLBACKS.expose(), CACHE_EVENTS.expose()))


def _fallback(name: str, reason: str, detail: str) -> None:
    """Record a failed program exactly once per (name, reason) in the
    log; the counter counts every failure."""
    FALLBACKS.inc(reason=reason)
    key = (name, reason)
    with _lock:
        if key in _warned:
            return
        _warned.add(key)
    log.warn("aot warmup program failed — not marked warm",
             artifact=name, reason=reason, detail=detail)


def resolve(name: str):
    """None: the port has no per-program executable.  Every program
    dispatches from the one kernel library, which warmup has loaded."""
    return None


def _reset_for_tests() -> None:
    with _lock:
        _warned.clear()


# ---------------------------------------------------------------------------
# the kernel library as the cache
# ---------------------------------------------------------------------------

def _load_library() -> tuple:
    """Build or load the kernel library once, counting its cache events;
    ("cached" | "compiled", seconds nvcc took).  Raises when it can be
    neither loaded nor built."""
    from .kernels import _build

    if _build._lib is not None:  # loaded in this process already
        CACHE_EVENTS.inc(event="hit")
        return "cached", 0.0
    so = _build.library_path()
    if so.exists():
        try:
            _build.build()
        except (OSError, AttributeError) as e:  # truncated/foreign file
            CACHE_EVENTS.inc(event="corrupt")
            _fallback(so.name, "corrupt", f"{so}: {e!r}")
            so.unlink(missing_ok=True)
        else:
            CACHE_EVENTS.inc(event="hit")
            return "cached", 0.0
    else:
        CACHE_EVENTS.inc(event="miss")
        _note_skew(so)
    t0 = time.monotonic()
    _build.build()
    seconds = time.monotonic() - t0
    CACHE_EVENTS.inc(event="store")
    return "compiled", seconds


def _note_skew(missed) -> None:
    """On a miss, a build directory that holds kernel libraries of other
    hashes is skew: sources, flags or constants changed since the last
    build — worth a counter so operators see 'warm directory, other
    build' instead of an unexplained slow start."""
    others = sorted(p.name for p in missed.parent.glob("harmony_kernels_*.so")
                    if p != missed)
    if others:
        CACHE_EVENTS.inc(event="skew")
        _fallback(missed.name, "skew",
                  f"build directory holds {', '.join(others)}")


# ---------------------------------------------------------------------------
# manifest + warmup
# ---------------------------------------------------------------------------

def load_manifest() -> dict:
    """The port's manifest, from its pinned registries: an
    ``agg_verify_b{n}`` and a ``masked_sum_w{n}`` per committee bucket,
    an ``agg_verify_batch_b{n}x{b}`` per committee and card batch bucket,
    and a ``verify_w{w}`` per card batch bucket — every program shape a
    serving path can dispatch on the card."""
    from . import device as DV

    committees, batches = DV.COMMITTEE_BUCKETS, DV.BATCH_BUCKETS_GPU
    return {"programs": [
        {"family": "agg_verify_batch_b{}x{}",
         "names": [f"agg_verify_batch_b{n}x{b}"
                   for n in committees for b in batches]},
        {"family": "agg_verify_b{}",
         "names": [f"agg_verify_b{n}" for n in committees]},
        {"family": "masked_sum_w{}",
         "names": [f"masked_sum_w{n}" for n in committees]},
        {"family": "verify_w{}",
         "names": [f"verify_w{w}" for w in batches]},
    ]}


def manifest_names(manifest: dict | None) -> list:
    if not manifest:
        return []
    names: list = []
    for fam in manifest.get("programs", []):
        names.extend(fam.get("names", []))
    return sorted(set(names))


_FAMILY_RES = (
    (re.compile(r"agg_verify_batch_b(\d+)x(\d+)\Z"), "agg_verify_batch"),
    (re.compile(r"agg_verify_b(\d+)\Z"), "agg_verify"),
    (re.compile(r"verify_w(\d+)\Z"), "verify"),
    (re.compile(r"masked_sum_w(\d+)\Z"), "masked_sum"),
)


def program_spec(name: str):
    """(family, bucket tuple, argument shapes) of a manifest program
    name; None for an unrecognized name.  int32 limbs throughout, the
    shapes ``device.py`` dispatches; the JAX package's, but for
    ``masked_sum``'s keys, which are the resident affine table here
    ((n, 2, 32); Jacobian (n, 3, 32) there)."""
    for rx, family in _FAMILY_RES:
        m = rx.match(name)
        if not m:
            continue
        dims = tuple(int(g) for g in m.groups())
        if family == "agg_verify":
            n, = dims
            shapes = ((n, 2, 32), (n,), (2, 2, 32), (2, 2, 32))
        elif family == "agg_verify_batch":
            n, b = dims
            shapes = ((n, 2, 32), (b, n), (b, 2, 2, 32), (b, 2, 2, 32))
        elif family == "verify":
            w, = dims
            shapes = ((w, 2, 32), (w, 2, 2, 32), (w, 2, 2, 32))
        else:  # masked_sum
            n, = dims
            shapes = ((n, 2, 32), (n,))
        return family, dims, shapes
    return None


def _warm_one(name: str) -> bool:
    """Run one manifest program on the card and mark it warm; False
    (counted, logged once) when it failed."""
    from . import device as DV

    spec = program_spec(name)
    if spec is None:
        _fallback(name, "unknown-program",
                  "manifest name matches no program family")
        return False
    family, _, shapes = spec
    try:
        DV.warm(family, shapes)
    except Exception as e:  # noqa: BLE001 — warmup must not kill boot
        _fallback(name, "warmup", repr(e))
        return False
    DV.mark_warm(name)
    return True


def _on_card() -> bool:
    """Whether the node's checks run on CUDA: the device of
    ``device.use_device``, else CUDA where it exists."""
    import torch

    from . import device as DV

    dev = DV._NODE_DEVICE
    return torch.cuda.is_available() if dev is None else DV._on_card(dev)


def warmup(manifest: dict | None = None) -> dict:
    """Run every manifest program once before the node serves, so the
    serving paths (consensus pump, sched lanes, ingress, sync) never pay
    a program's first use (the JAX package's NEWVIEW wedge class).

    Mode-aware, with the JAX package's stats keys:
      * ``no-manifest`` — no manifest: nothing is warmed.
      * ``twin`` — the twins are plain python callables; every manifest
        program (plus the single-signature ``verify_w1`` hot path) is
        marked warm so JIT first-use counters stay flat.
      * ``eager`` — the node's checks run the plain versions on the CPU:
        there is nothing to build or load.
      * ``cuda`` — build or load the kernel library once (``cached`` or
        ``compiled`` counts the programs warmed after a hit or a build;
        ``compile_s`` is nvcc's; ``saved_s`` stays 0: one library, so no
        program's own build is avoided), then run each program on the
        card (the node's device of ``device.use_device``, else CUDA).
    """
    from . import device as DV

    if manifest is None:
        manifest = load_manifest()
    names = manifest_names(manifest)
    stats = {"mode": "eager", "programs": len(names), "warmed": 0,
             "cached": 0, "compiled": 0, "failed": 0,
             "compile_s": 0.0, "saved_s": 0.0}
    if manifest is None:
        stats["mode"] = "no-manifest"
        log.warn("aot warmup: no manifest — serving paths may pay "
                 "first uses")
        return stats
    if DV.kernel_twin_active():
        stats["mode"] = "twin"
        for name in names + ["verify_w1"]:
            DV.mark_warm(name)
        stats["warmed"] = len(names) + 1
        return stats
    if not _on_card():
        return stats
    stats["mode"] = "cuda"
    try:
        outcome, stats["compile_s"] = _load_library()
    except Exception as e:  # noqa: BLE001 — warmup must not kill boot
        for name in names:
            _fallback(name, "warmup", f"kernel library: {e!r}")
        stats["failed"] = len(names)
        return stats
    for name in names:
        if _warm_one(name):
            stats[outcome] += 1
            stats["warmed"] += 1
        else:
            stats["failed"] += 1
    return stats


def startup_warmup() -> dict | None:
    """Node boot hook: warm the full manifest, log the verdict, never
    raise (a broken warmup degrades to first uses on the serving path,
    which the JIT counters surface)."""
    try:
        t0 = time.monotonic()
        stats = warmup()
        stats["wall_s"] = round(time.monotonic() - t0, 3)
        log.info(
            "aot warmup done", mode=stats["mode"],
            warmed=stats["warmed"], programs=stats["programs"],
            cached=stats["cached"], compiled=stats["compiled"],
            compile_s=round(stats["compile_s"], 2),
            failed=stats["failed"], wall_s=stats["wall_s"])
        return stats
    except Exception as e:  # noqa: BLE001 — boot must proceed
        log.warn("aot warmup failed — node will pay first uses",
                 error=repr(e))
        return None
