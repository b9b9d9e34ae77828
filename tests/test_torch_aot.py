"""The port's warmup (``aot.py``) against the JAX package's.

The port's manifest is built from its pinned bucket registries; it must
name the JAX package's committed 43 programs, with the JAX package's
argument shapes.  ``warmup`` keeps the JAX package's modes and stats keys:
the twin and no-manifest modes must give the same stats on both packages,
and so must the CPU's eager mode.  The card's mode runs here with the
kernel library's build replaced by a stub (no nvcc here) and the device
programs by recorders: the cache events on a temporary build directory, a
program that fails, a build that raises.  Nothing pairing-shaped compiles
(the JAX package's shapes are ``ShapeDtypeStruct``s, never lowered).
"""

import pytest

from harmony_tpu import aot as J_AOT
from harmony_tpu_torch import aot as T_AOT
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import prof as T_PROF
from harmony_tpu_torch.kernels import _build


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("HARMONY_AOT_CACHE", str(tmp_path / "aotc"))
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    J_AOT._reset_for_tests()
    T_AOT._reset_for_tests()
    yield
    J_AOT._reset_for_tests()
    T_AOT._reset_for_tests()
    T_DV.use_device(None)
    T_PROF.reset()


def _counts(counter):
    return {dict(k).popitem()[1]: v for k, v in counter._values.items()}


def _delta(counter, before):
    now = _counts(counter)
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v != before.get(k, 0)}


def test_the_manifest_names_the_jax_packages_43_programs():
    names = T_AOT.manifest_names(T_AOT.load_manifest())
    assert names == J_AOT.manifest_names(J_AOT.load_manifest())
    assert len(names) == 43
    fams = {f["family"] for f in T_AOT.load_manifest()["programs"]}
    assert fams == {f["family"] for f in J_AOT.load_manifest()["programs"]}


def test_program_specs_match_the_jax_packages_shapes():
    """Name for name the same family, buckets and argument shapes, but
    for masked_sum's keys: the port dispatches the resident affine table
    ((n, 2, 32)), the JAX package Jacobian points ((n, 3, 32))."""
    for name in T_AOT.manifest_names(T_AOT.load_manifest()):
        family, dims, shapes = T_AOT.program_spec(name)
        j_family, j_dims, j_specs = J_AOT.program_spec(name)
        j_shapes = tuple(tuple(s.shape) for s in j_specs)
        assert (family, dims) == (j_family, j_dims), name
        assert all(str(s.dtype) == "int32" for s in j_specs)
        if family == "masked_sum":
            n, = dims
            assert j_shapes == ((n, 3, 32), (n,))
            assert shapes == ((n, 2, 32), (n,))
        else:
            assert shapes == j_shapes, name
    assert T_AOT.program_spec("not_a_program") is None
    assert J_AOT.program_spec("not_a_program") is None


def _without_wall(stats):
    return {k: v for k, v in stats.items() if k != "wall_s"}


def test_twin_mode_stats_equal_the_jax_packages(monkeypatch):
    """As tests/test_aot_cache.py runs it: the twins mark every manifest
    name plus verify_w1 warm, and no JIT counter moves."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T_DV.use_device(True, device="cpu")
    manifest = {"programs": [{"family": "t_b{}",
                              "names": ["t_b8", "t_b16"]}]}
    jit = dict(T_DV.JIT.items())
    before = set(T_DV._SEEN_PROGRAMS)
    stats = T_AOT.warmup(manifest)
    assert stats == J_AOT.warmup(manifest)
    assert stats["mode"] == "twin" and stats["warmed"] == 3
    assert set(T_DV._SEEN_PROGRAMS) - before <= {"t_b8", "t_b16",
                                                  "verify_w1"}
    assert {"t_b8", "t_b16", "verify_w1"} <= set(T_DV._SEEN_PROGRAMS)
    assert dict(T_DV.JIT.items()) == jit
    full = T_AOT.warmup()
    assert full == J_AOT.warmup(J_AOT.load_manifest())
    assert full["warmed"] == 44


def test_no_manifest_stats_equal_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.setattr(J_AOT, "MANIFEST_PATH", str(tmp_path / "none.json"))
    monkeypatch.setattr(T_AOT, "load_manifest", lambda: None)
    stats = T_AOT.warmup()
    assert stats == J_AOT.warmup()
    assert stats["mode"] == "no-manifest" and stats["programs"] == 0


def test_eager_mode_on_the_cpu_equals_the_jax_packages():
    """The node's checks on the CPU run the plain versions: nothing to
    build or load, nothing marked warm (the JAX package's XLA:CPU route
    gives the same stats)."""
    T_DV.use_device(True, device="cpu")
    before = set(T_DV._SEEN_PROGRAMS)
    stats = T_AOT.warmup()
    assert stats == J_AOT.warmup(J_AOT.load_manifest())
    assert stats["mode"] == "eager" and stats["warmed"] == 0
    assert set(T_DV._SEEN_PROGRAMS) == before
    assert T_AOT.resolve("agg_verify_b8") is None


@pytest.fixture
def card(monkeypatch, tmp_path):
    """The card's mode without a card: a temporary build directory, a
    build that writes the library file where nvcc would (and fails to
    load one whose bytes are b"junk"), the device programs replaced by
    recorders, and a fresh breaker.  Yields (builds, warmed calls)."""
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_lib", None)
    builds, calls = [], []

    def fake_build():
        so = _build.library_path()
        if so.exists():
            if so.read_bytes() == b"junk":
                raise OSError(f"{so}: invalid ELF header")
            return None
        build_dir.mkdir(parents=True, exist_ok=True)
        so.write_bytes(b"library")
        builds.append(so.name)
        return None

    monkeypatch.setattr(_build, "build", fake_build)
    monkeypatch.setattr(T_AOT, "_on_card", lambda: True)
    monkeypatch.setattr(T_DV, "BREAKER", type(T_DV.BREAKER)(
        "device", failure_threshold=5, reset_timeout_s=30.0))

    def recorder(family):
        def run(*args):
            calls.append((family, tuple(tuple(a.shape) for a in args),
                          {str(a.dtype) for a in args},
                          all(not a.any() for a in args)))
        return run

    monkeypatch.setattr(T_DV, "PROGRAMS",
                        {f: recorder(f) for f in T_DV.PROGRAMS})
    monkeypatch.setattr(T_DV, "_SEEN_PROGRAMS", set())
    T_DV.use_device(True, device="cpu")
    return build_dir, builds, calls


def test_the_cards_mode_runs_every_program_once_on_pad_inputs(card):
    build_dir, builds, calls = card
    events = _counts(T_AOT.CACHE_EVENTS)
    jit = dict(T_DV.JIT.items())
    stats = T_AOT.startup_warmup()
    names = T_AOT.manifest_names(T_AOT.load_manifest())
    assert _without_wall(stats) == {
        "mode": "cuda", "programs": 43, "warmed": 43, "cached": 0,
        "compiled": 43, "failed": 0, "compile_s": stats["compile_s"],
        "saved_s": 0.0}
    assert _delta(T_AOT.CACHE_EVENTS, events) == {"miss": 1, "store": 1}
    assert len(builds) == 1
    assert [(f, s) for f, s, _, _ in calls] == [
        T_AOT.program_spec(n)[::2] for n in names]
    assert all(d == {"torch.int32"} and zero for _, _, d, zero in calls)
    assert T_DV._SEEN_PROGRAMS == set(names)
    assert dict(T_DV.JIT.items()) == jit
    assert T_DV.BREAKER.state == "closed"
    # the library is there now: the next boot loads it (a hit)
    events = _counts(T_AOT.CACHE_EVENTS)
    stats = T_AOT.warmup()
    assert (stats["cached"], stats["compiled"]) == (43, 0)
    assert _delta(T_AOT.CACHE_EVENTS, events) == {"hit": 1}
    assert len(builds) == 1


def test_cache_events_corrupt_and_skew(card):
    build_dir, builds, _ = card
    build_dir.mkdir()
    (build_dir / "harmony_kernels_0123456789abcdef.so").write_bytes(b"old")
    fallbacks = _counts(T_AOT.FALLBACKS)
    events = _counts(T_AOT.CACHE_EVENTS)
    assert T_AOT._load_library()[0] == "compiled"
    assert _delta(T_AOT.CACHE_EVENTS, events) == {"miss": 1, "skew": 1,
                                                  "store": 1}
    _build.library_path().write_bytes(b"junk")
    events = _counts(T_AOT.CACHE_EVENTS)
    assert T_AOT._load_library()[0] == "compiled"
    assert _delta(T_AOT.CACHE_EVENTS, events) == {"corrupt": 1, "store": 1}
    assert _build.library_path().read_bytes() == b"library"
    assert _delta(T_AOT.FALLBACKS, fallbacks) == {"skew": 1, "corrupt": 1}
    assert len(builds) == 2


def test_a_failed_program_is_counted_and_not_marked_warm(card, monkeypatch):
    _, _, calls = card
    failing = T_DV.PROGRAMS["verify"]

    def verify(*args):
        failing(*args)
        if args[0].shape[0] == 64:
            raise RuntimeError("verify_kernel launch failed: CUDA error 700")

    monkeypatch.setitem(T_DV.PROGRAMS, "verify", verify)
    fallbacks = _counts(T_AOT.FALLBACKS)
    stats = T_AOT.startup_warmup()
    assert (stats["warmed"], stats["failed"]) == (42, 1)
    assert _delta(T_AOT.FALLBACKS, fallbacks) == {"warmup": 1}
    assert "verify_w64" not in T_DV._SEEN_PROGRAMS
    assert "verify_w8" in T_DV._SEEN_PROGRAMS
    assert len(calls) == 43
    # the programs after it succeeded: the breaker holds no failure
    assert T_DV.BREAKER.state == "closed"
    assert T_DV.BREAKER._failures == 0


def test_a_raising_build_marks_nothing_warm(card, monkeypatch):
    def nvcc_fails():
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(_build, "build", nvcc_fails)
    _, _, calls = card
    fallbacks = _counts(T_AOT.FALLBACKS)
    stats = T_AOT.startup_warmup()
    assert stats is not None and stats["mode"] == "cuda"
    assert (stats["warmed"], stats["failed"]) == (0, 43)
    assert _delta(T_AOT.FALLBACKS, fallbacks) == {"warmup": 43}
    assert not T_DV._SEEN_PROGRAMS and not calls


def test_startup_warmup_never_raises(monkeypatch):
    def broken(manifest=None):
        raise RuntimeError("manifest unreadable")

    monkeypatch.setattr(T_AOT, "warmup", broken)
    assert T_AOT.startup_warmup() is None


def test_the_breaker_guards_every_warm_program(card):
    """An OPEN breaker refuses the warm with DeviceError: nothing runs."""
    _, _, calls = card
    for _ in range(5):
        T_DV.BREAKER.record_failure()
    with pytest.raises(T_DV.DeviceError, match="breaker open"):
        T_DV.warm("verify", ((8, 2, 32), (8, 2, 2, 32), (8, 2, 2, 32)))
    assert not calls


def test_warm_runs_the_plain_masked_sum_on_the_cpu():
    """The one device program cheap enough here: the masked G1 sum at
    bucket 8 on pad inputs, through the CPU plain version."""
    T_DV.warm("masked_sum", T_AOT.program_spec("masked_sum_w8")[2], "cpu")
    assert T_DV.BREAKER.state == "closed"


@pytest.mark.parametrize("name, products", [
    ("agg_verify_b256", 6 * 128 + 16 * 127 + 4 + 2 * 8302 + 54 + 7708),
    ("agg_verify_batch_b8x64", 64 * (6 * 4 + 16 * 3 + 4 + 2 * 8302 + 54
                                     + 7708)),
    ("verify_w8", 8 * (2 * 8302 + 54 + 7708)),
    ("masked_sum_w1024", 6 * 512 + 16 * 511 + 4),
])
def test_program_operations_count_the_plans_products(name, products):
    assert T_PROF.program_operations(name) == products * 576
    assert T_PROF.program_operations("t_b8") is None


def test_an_armed_first_dispatch_records_the_programs_cost(monkeypatch):
    """With the profiler armed, the first dispatch of verify_w8 (the
    twins, on the CPU) records the JAX package's cost keys: operations,
    argument and output bytes (no allocator peak off the card)."""
    from harmony_tpu_torch import bls as T_B
    from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2

    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    monkeypatch.setattr(T_DV, "_SEEN_PROGRAMS", set())
    T_DV.use_device(True, device="cpu")
    T_PROF.reset()
    T_PROF.configure(enabled=True)
    key = T_B.PrivateKey.generate(b"\x05")
    payload = b"aot-profiled-payload"
    sig = key.sign_hash(payload).point
    assert T_DV.verify_many_on_device([key.pub.point], [hash_to_g2(payload)],
                                      [sig]) == [True]
    got = T_PROF.programs()["verify_w8"]
    assert got["flops"] == T_PROF.program_operations("verify_w8")
    assert got["argument_bytes"] == 4 * 8 * (64 + 128 + 128)
    assert got["output_bytes"] == 8
    assert got["bytes_accessed"] == got["argument_bytes"] + 8
    assert "peak_memory_bytes" not in got and got["compile_s"] >= 0
    text = T_PROF.expose()
    for family in ("harmony_prof_program_flops",
                   "harmony_prof_program_bytes_accessed",
                   "harmony_prof_program_compile_seconds"):
        assert f'{family}{{program="verify_w8"}}' in text
