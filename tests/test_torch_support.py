"""The port's support modules against the JAX package's: resilience,
faultinject, trace, log, metrics and health.

Each case is one scenario, taken from tests/test_resilience.py,
test_trace.py and test_health.py (and the metrics primitives those
reach), run as the same call sequence on the JAX package's modules and on
the port's copies.  A scenario asserts what its original test asserts and
returns what it observed (states, counters, outputs, exposition text);
the two packages' observations must be equal.  Nothing here is timed
against a bound tighter than the original's.
"""

import io
import json
import sys
import threading
import time
import types

import pytest

import harmony_tpu.faultinject as J_FI
import harmony_tpu.health as J_HL
import harmony_tpu.log as J_LOG
import harmony_tpu.metrics as J_MT
import harmony_tpu.resilience as J_RS
import harmony_tpu.trace as J_TR
import harmony_tpu_torch.faultinject as T_FI
import harmony_tpu_torch.health as T_HL
import harmony_tpu_torch.log as T_LOG
import harmony_tpu_torch.metrics as T_MT
import harmony_tpu_torch.resilience as T_RS
import harmony_tpu_torch.trace as T_TR

PACKAGES = {
    "jax": types.SimpleNamespace(FI=J_FI, HL=J_HL, LOG=J_LOG, MT=J_MT,
                                 RS=J_RS, TR=J_TR),
    "port": types.SimpleNamespace(FI=T_FI, HL=T_HL, LOG=T_LOG, MT=T_MT,
                                  RS=T_RS, TR=T_TR),
}


def _reset(m):
    m.FI.reset()
    m.HL.reset()
    m.TR.reset()


# -- resilience: Deadline, RetryPolicy, CircuitBreaker ---------------------------


def deadline_budget_and_bound(m, tmp):
    dl = m.RS.Deadline.after(10.0)
    rem = dl.remaining()
    assert 9.0 < rem <= 10.0
    assert dl.bound(None) == pytest.approx(rem, abs=0.5)
    dl.check("op")
    gone = m.RS.Deadline.after(0.0)
    with pytest.raises(m.RS.DeadlineExceeded):
        gone.check("op")
    return (dl.expired(), dl.bound(3.0), gone.expired(), gone.bound(3.0))


def deadline_none_is_unbounded(m, tmp):
    dl = m.RS.Deadline.none()
    dl.check()
    return (dl.remaining(), dl.expired(), dl.bound(2.5), dl.bound(None))


def deadline_exceeded_is_oserror(m, tmp):
    return (issubclass(m.RS.DeadlineExceeded, TimeoutError),
            issubclass(m.RS.DeadlineExceeded, OSError))


def retry_delays_deterministic(m, tmp):
    p = m.RS.RetryPolicy(attempts=5, base_delay_s=0.1, multiplier=2.0,
                         max_delay_s=0.5, jitter=0.5, seed=7)
    a = [p.delay(i, key="x") for i in range(1, 5)]
    assert a == [p.delay(i, key="x") for i in range(1, 5)]
    for i, d in enumerate(a, start=1):
        cap = min(0.5, 0.1 * 2.0 ** (i - 1))
        assert 0.5 * cap <= d <= cap
    return a, [p.delay(i, key="y") for i in range(1, 5)]


def retry_run_retries_then_raises(m, tmp):
    calls, slept = [], []
    p = m.RS.RetryPolicy(attempts=3, base_delay_s=0.01)

    def fails():
        calls.append(1)
        raise ValueError("nope")

    with pytest.raises(ValueError):
        p.run(fails, retry_on=(ValueError,), sleep=slept.append)
    first = (len(calls), slept)
    calls.clear()

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise ValueError("once")
        return "ok"

    return first, p.run(flaky, retry_on=(ValueError,),
                        sleep=slept.append), len(calls)


def retry_run_respects_deadline(m, tmp):
    p = m.RS.RetryPolicy(attempts=10, base_delay_s=5.0, max_delay_s=5.0)
    calls, slept = [], []

    def fails():
        calls.append(1)
        raise ValueError("nope")

    t0 = time.monotonic()
    with pytest.raises(ValueError):
        p.run(fails, retry_on=(ValueError,),
              deadline=m.RS.Deadline.after(0.2), sleep=slept.append)
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(m.RS.DeadlineExceeded):
        p.run(fails, retry_on=(ValueError,),
              deadline=m.RS.Deadline.after(0.0))
    return len(calls), slept


def breaker_lifecycle_with_metrics(m, tmp):
    now = [0.0]
    brk = m.RS.CircuitBreaker("t-lifecycle", failure_threshold=3,
                              reset_timeout_s=10.0, clock=lambda: now[0])
    names = ("open", "half_open", "close", "rejected")
    base = {k: m.RS.TRANSITIONS[f"t-lifecycle:{k}"] for k in names}
    seen = []

    def note(what):
        seen.append((what, brk.state, tuple(
            m.RS.TRANSITIONS[f"t-lifecycle:{k}"] - base[k] for k in names)))

    note(brk.allow())
    brk.record_failure()
    brk.record_failure()
    note("two failures")
    brk.record_success()
    brk.record_failure()
    brk.record_failure()
    note("count reset by a success")
    brk.record_failure()
    note("tripped")
    note(brk.allow())
    now[0] = 10.1
    note(brk.allow())  # the single half-open probe
    note(brk.allow())  # a second concurrent probe is rejected
    brk.record_failure()
    note("probe failed")
    now[0] = 20.3
    note(brk.allow())
    brk.record_success()
    note("probe succeeded")
    assert seen[3][1] == "open" and seen[-1][1] == "closed"
    return seen


# -- faultinject ---------------------------------------------------------------------


def faultinject_disarmed_is_noop(m, tmp):
    m.FI.fire("some.point")
    return m.FI.garble("some.point", b"abc")


def faultinject_counting_and_selectors(m, tmp):
    m.FI.arm("p", exc=RuntimeError, every=2, after=1, times=2)
    fired = []
    for i in range(1, 8):
        try:
            m.FI.fire("p")
        except RuntimeError:
            fired.append(i)
    assert fired == [2, 4]
    return fired, m.FI.hits("p"), m.FI.fired("p")


def faultinject_key_matching(m, tmp):
    m.FI.arm("peer", exc=ConnectionResetError, key="10.0.0.2:99")
    m.FI.fire("peer", key="10.0.0.1:99")
    with pytest.raises(ConnectionResetError):
        m.FI.fire("peer", key="10.0.0.2:99")
    return m.FI.fired("peer", key="10.0.0.2:99"), m.FI.hits("peer")


def faultinject_delay_and_garble_deterministic(m, tmp):
    m.FI.arm("slow", delay_s=0.05)
    t0 = time.monotonic()
    m.FI.fire("slow")
    assert time.monotonic() - t0 >= 0.05
    m.FI.arm("wire", garble=True)
    m.FI.set_seed(42)
    data = bytes(range(32))
    g1 = m.FI.garble("wire", data)
    assert g1 != data and len(g1) == len(data)
    m.FI.reset()
    m.FI.arm("wire", garble=True)
    m.FI.set_seed(42)
    assert m.FI.garble("wire", data) == g1
    return g1


def faultinject_phased_window(m, tmp):
    live = [False]
    m.FI.arm("phase", exc=RuntimeError, when=lambda: live[0], times=1)
    out = []
    for flag in (False, True, True):
        live[0] = flag
        try:
            m.FI.fire("phase")
            out.append("clean")
        except RuntimeError:
            out.append("fault")
    return out, m.FI.fired("phase")


# -- trace and log ----------------------------------------------------------------


def span_nesting_and_context(m, tmp):
    m.TR.configure(enabled=True)
    with m.TR.span("round", component="consensus") as root:
        assert m.TR.current_span() is root
        with m.TR.span("dispatch", component="device") as child:
            assert child.trace_id == root.trace_id
            assert child.parent_id == root.span_id
        assert m.TR.current_span() is root
    assert m.TR.current_span() is None
    spans = m.TR.spans(root.trace_id)
    assert all(s.dur_s is not None for s in spans)
    return sorted(s.name for s in spans)


def traceparent_roundtrip_and_garbage(m, tmp):
    m.TR.configure(enabled=True)
    with m.TR.span("r") as sp:
        tc = m.TR.traceparent()
        assert m.TR.parse_traceparent(tc) == (sp.trace_id, sp.span_id)
    junk_parsed = []
    for junk in (b"", b"junk", b"\xff" * 26, b"\x00" * 25):
        junk_parsed.append(m.TR.parse_traceparent(junk))
        with m.TR.resume(junk, "x"):
            pass
    return (len(tc), m.TR.TRACEPARENT_LEN, junk_parsed,
            m.TR.spans(trace_id="ffffffffffffffffffffffffffffffff"))


def sampling_knob_deterministic(m, tmp):
    m.TR.configure(enabled=True, sample_rate=0.0)
    with m.TR.span("unsampled"):
        unsampled = m.TR.traceparent()
    before = len(m.TR.spans())
    m.TR.configure(sample_rate=1.0)
    with m.TR.span("sampled"):
        pass
    return unsampled, before, [s.name for s in m.TR.spans()]


def disabled_span_is_a_shared_noop(m, tmp):
    assert not m.TR.enabled()
    assert m.TR.span("a") is m.TR.span("b")
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with m.TR.span("device.dispatch", component="device"):
            pass
    assert (time.perf_counter() - t0) / n < 20e-6
    return m.TR.traceparent()


def log_records_carry_trace_ids(m, tmp):
    m.TR.configure(enabled=True, dump_dir=str(tmp))
    buf = io.StringIO()
    m.LOG.init_logging(level="info", stream=buf)
    try:
        log = m.LOG.get_logger("test-trace")
        with m.TR.span("round", component="consensus") as sp:
            log.info("inside the round", block=7)
        log.info("outside any span")
    finally:
        m.LOG.init_logging(stream=sys.stderr)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    inside = next(ln for ln in lines if ln["msg"] == "inside the round")
    outside = next(ln for ln in lines if ln["msg"] == "outside any span")
    assert inside["trace_id"] == sp.trace_id
    dump = m.TR.anomaly("unit_test", trace_id=sp.trace_id)
    payload = json.load(open(dump))
    assert all(r.get("trace_id") == sp.trace_id for r in payload["logs"])
    drop = ("ts", "trace_id", "span_id")
    return ([{k: v for k, v in ln.items() if k not in drop}
             for ln in lines],
            "trace_id" in outside, payload["kind"],
            [r["msg"] for r in payload["logs"]])


# -- metrics primitives ------------------------------------------------------------


def metrics_counter_gauge_histogram(m, tmp):
    c = m.MT.Counter("x_total", "a counter")
    c.inc()
    c.inc(2.5, lane="sync")
    c.inc(lane="consensus")
    g = m.MT.Gauge("x_depth", "a gauge")
    g.set(3, lane="sync")
    g.set(1.25, lane="sync")
    h = m.MT.Histogram("x_seconds", "a histogram",
                       buckets=(0.001, 0.01, 0.1, 1.0),
                       labels={"lane": "ingress"})
    for v in (0.0005, 0.002, 0.002, 0.05, 0.5, 7.0):
        h.observe(v)
    lc = m.MT.LockedCounters("verify", "ref_fallback")
    lc.inc("verify", 3)
    lc.inc("masked_pubkey_sum")
    lc["ref_fallback"] = 2
    return (c.expose(), c.value(lane="sync"), c.total(), g.expose(),
            h.expose(), h.quantile(0.5), h.quantile(0.99), h.summary(),
            m.MT.Histogram("empty").quantile(0.5), lc.items(), dict(lc),
            list(lc))


def metrics_histogram_exemplars(m, tmp):
    m.TR.configure(enabled=True)
    h = m.MT.Histogram("x_seconds", "exemplars", buckets=(0.01, 1.0))
    with m.TR.span("round") as sp:
        h.observe(0.5)
    h.observe(0.005)
    text = h.expose(exemplars=True)
    assert f'trace_id="{sp.trace_id}"' in text
    return text.replace(sp.trace_id, "<trace>")


# -- health ---------------------------------------------------------------------------


def _dead_thread():
    t = threading.Thread(target=lambda: None)
    t.start()
    t.join()
    return t


def health_states_ok_stale_idle_closed(m, tmp):
    m.HL.configure(enabled=False)
    hb = m.HL.register("a", max_age_s=0.05)
    seen = [hb.state()]
    time.sleep(0.08)
    seen.append(hb.state())
    hb.beat()
    seen.append(hb.state())
    hb.idle()
    time.sleep(0.08)
    seen.append(hb.state())
    hb.close()
    seen.append(hb.state())
    return seen, [p.name for p in m.HL.participants()]


def health_dead_thread_state(m, tmp):
    m.HL.configure(enabled=False)
    return m.HL.register("gone", thread=_dead_thread(),
                         max_age_s=100.0).state()


def health_close_is_identity_guarded(m, tmp):
    m.HL.configure(enabled=False)
    old = m.HL.register("reader")
    new = m.HL.register("reader")
    old.close()
    assert m.HL.participants() == [new]
    return [p.name for p in m.HL.participants()]


def health_watchdog_stale_dumps_once_and_recovery(m, tmp):
    m.HL.configure(enabled=False)
    m.TR.configure(enabled=True, dump_dir=str(tmp), dump_cooldown_s=0)
    hb = m.HL.register("wedgy", max_age_s=0.05)
    time.sleep(0.08)
    seen = [m.HL.check_once()["wedgy"], m.HL.EVENTS.items(),
            len(m.TR.dumps())]
    kinds = [json.load(open(p))["kind"] for p in m.TR.dumps()]
    seen += [m.HL.check_once()["wedgy"], m.HL.EVENTS.items(),
             len(m.TR.dumps())]
    hb.beat()
    seen += [m.HL.check_once()["wedgy"], m.HL.EVENTS.items()]
    return seen, kinds


def health_watchdog_restarts_dead_participant(m, tmp):
    m.HL.configure(enabled=False)
    revived = []

    def restart():
        live = threading.Thread(target=time.sleep, args=(5.0,),
                                daemon=True)
        live.start()
        hb.bind(live)
        revived.append(live)

    hb = m.HL.register("svc", thread=_dead_thread(), restart=restart)
    states = m.HL.check_once()
    return states, m.HL.EVENTS.items(), len(revived), hb.state()


def health_restart_failure_counted_not_fatal(m, tmp):
    m.HL.configure(enabled=False)

    def broken():
        raise RuntimeError("no resurrection today")

    m.HL.register("doomed", thread=_dead_thread(), restart=broken)
    return m.HL.check_once(), m.HL.EVENTS.items()


def health_close_while_flagged_counts_recovery(m, tmp):
    m.HL.configure(enabled=False)
    hb = m.HL.register("reader", max_age_s=0.05)
    time.sleep(0.08)
    m.HL.check_once()
    stale = m.HL.EVENTS["stale"]
    hb.close(reason="desync")
    return stale, m.HL.EVENTS.items()


def health_registry_cardinality_bound(m, tmp):
    m.HL.configure(enabled=False)
    keeper = m.HL.register("keeper", critical=True)
    for i in range(m.HL._MAX_PARTICIPANTS + 8):
        m.HL.register(f"transient{i}")
    names = sorted(p.name for p in m.HL.participants())
    assert len(names) <= m.HL._MAX_PARTICIPANTS and keeper.name in names
    return names


def health_verdicts_and_critical_gating(m, tmp):
    m.HL.configure(enabled=False)
    m.HL.register("fine")
    sick = m.HL.register("sick", max_age_s=0.01)
    time.sleep(0.03)
    v = m.HL.verdicts()
    first = (v["ok"], v["degraded"], v["participants"]["sick"]["state"])
    sick.critical = True
    return first, m.HL.verdicts()["ok"], m.HL.healthy()


def health_exposition(m, tmp):
    m.HL.configure(enabled=False)
    hb = m.HL.register("pump", max_age_s=0.05)
    time.sleep(0.08)
    m.HL.check_once()
    hb.beat()
    m.HL.check_once()
    hb.max_age_s = 60.0
    hb.beat()
    # beat ages are wall-clock readings: compare the lines without them
    return [ln for ln in m.HL.expose().splitlines()
            if not ln.startswith("harmony_health_beat_age_seconds{")]


SCENARIOS = [
    deadline_budget_and_bound, deadline_none_is_unbounded,
    deadline_exceeded_is_oserror, retry_delays_deterministic,
    retry_run_retries_then_raises, retry_run_respects_deadline,
    breaker_lifecycle_with_metrics, faultinject_disarmed_is_noop,
    faultinject_counting_and_selectors, faultinject_key_matching,
    faultinject_delay_and_garble_deterministic, faultinject_phased_window,
    span_nesting_and_context, traceparent_roundtrip_and_garbage,
    sampling_knob_deterministic, disabled_span_is_a_shared_noop,
    log_records_carry_trace_ids, metrics_counter_gauge_histogram,
    metrics_histogram_exemplars, health_states_ok_stale_idle_closed,
    health_dead_thread_state, health_close_is_identity_guarded,
    health_watchdog_stale_dumps_once_and_recovery,
    health_watchdog_restarts_dead_participant,
    health_restart_failure_counted_not_fatal,
    health_close_while_flagged_counts_recovery,
    health_registry_cardinality_bound, health_verdicts_and_critical_gating,
    health_exposition,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_port_module_behaves_as_the_jax_package(scenario, tmp_path):
    observed = {}
    for name, m in PACKAGES.items():
        _reset(m)
        try:
            (tmp_path / name).mkdir()
            observed[name] = scenario(m, tmp_path / name)
        finally:
            _reset(m)
    assert observed["port"] == observed["jax"]


def test_the_port_keeps_the_public_names():
    import harmony_tpu.aot as J_AOT
    import harmony_tpu.governor as J_GV
    import harmony_tpu.pprof as J_PP
    import harmony_tpu.prof as J_PROF
    import harmony_tpu.ratelimit as J_RL
    import harmony_tpu_torch.aot as T_AOT
    import harmony_tpu_torch.governor as T_GV
    import harmony_tpu_torch.pprof as T_PP
    import harmony_tpu_torch.prof as T_PROF
    import harmony_tpu_torch.ratelimit as T_RL

    pairs = [(getattr(PACKAGES["jax"], mod), getattr(PACKAGES["port"], mod))
             for mod in ("FI", "HL", "LOG", "MT", "RS", "TR")]
    pairs += [(J_GV, T_GV), (J_RL, T_RL), (J_PP, T_PP), (J_PROF, T_PROF),
              (J_AOT, T_AOT)]
    for jax_mod, port_mod in pairs:
        public = {n for n in vars(jax_mod) if not n.startswith("_")
                  and not isinstance(vars(jax_mod)[n], types.ModuleType)}
        missing = public - set(vars(port_mod))
        # aot's jax.export artifacts and serialized-executable cache have
        # no counterpart: the port runs every program from one kernel
        # library, which its warmup builds or loads
        allowed = ({"MANIFEST_PATH", "cache_dir", "cache_key", "cache_load",
                    "cache_meta", "cache_store", "jaxlib_version", "load"}
                   if jax_mod is J_AOT else set())
        assert missing == allowed, (jax_mod.__name__, sorted(missing))
    for name in ("LockedCounters", "Counter", "Gauge", "Histogram",
                 "process_sample", "Registry", "MetricsServer"):
        assert hasattr(T_MT, name)
