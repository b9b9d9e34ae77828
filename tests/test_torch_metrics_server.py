"""The port's serving surface against the JAX package's: ``health.readiness``,
the ``MetricsServer`` probes and debug routes, the trace's node
attribution, round SLO, export hook and Chrome export, and
``prof.capture`` over ``torch.profiler``.

Each scenario runs the same calls on both packages and compares what they
observed; wall times, ids and ages are left out of the comparison.  The
servers bind 127.0.0.1 on port 0 and are read over loopback.
"""

import json
import time
import types
import urllib.error
import urllib.request

import pytest

import harmony_tpu.governor as J_GV
import harmony_tpu.health as J_HL
import harmony_tpu.metrics as J_MT
import harmony_tpu.trace as J_TR
import harmony_tpu_torch.governor as T_GV
import harmony_tpu_torch.health as T_HL
import harmony_tpu_torch.metrics as T_MT
import harmony_tpu_torch.prof as T_PROF
import harmony_tpu_torch.trace as T_TR

PACKAGES = {
    "jax": types.SimpleNamespace(GV=J_GV, HL=J_HL, MT=J_MT, TR=J_TR),
    "port": types.SimpleNamespace(GV=T_GV, HL=T_HL, MT=T_MT, TR=T_TR),
}


@pytest.fixture(autouse=True)
def _clean():
    for m in PACKAGES.values():
        m.HL.reset()
        m.TR.reset()
    yield
    for m in PACKAGES.values():
        m.GV.uninstall()
        m.HL.reset()
        m.TR.reset()
    T_PROF.reset()


def _governor(m, tier):
    gov = m.GV.ResourceGovernor(sample_fn=lambda: {})
    gov._state = m.GV.Tier[tier]
    return m.GV.install(gov)


@pytest.mark.parametrize("tier", [None, "NORMAL", "PRESSURED", "CRITICAL"])
def test_readiness_equals_the_jax_packages(tier):
    """As tests/test_health.py runs it: alive and below CRITICAL is
    ready; a CRITICAL governor drains the node though it is alive."""
    out = {}
    for name, m in PACKAGES.items():
        m.HL.configure(enabled=False)
        m.HL.register("pump", critical=True)
        if tier is not None:
            _governor(m, tier)
        out[name] = m.HL.readiness()
    assert out["port"] == out["jax"]
    assert out["port"]["ready"] is (tier != "CRITICAL")
    assert out["port"]["health_ok"] is True


def _get(port, path):
    try:
        resp = urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                      timeout=10)
        return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _probe(port, path):
    status, body = _get(port, path)
    body = json.loads(body)
    for p in body.get("participants", {}).values():
        p.pop("age_s")
    return status, body


def test_probes_answer_as_the_jax_packages_server():
    """/healthz and /readyz give the same status codes and JSON on both
    servers for the same state: alive, a critical participant gone stale,
    its beat back, then a CRITICAL governor."""
    seen = {}
    servers = {}
    beats = {}
    try:
        for name, m in PACKAGES.items():
            m.HL.configure(enabled=False)
            beats[name] = m.HL.register("pump", critical=True, max_age_s=0.2)
            m.HL.register("sync", max_age_s=60.0)
            servers[name] = m.MT.MetricsServer(m.MT.Registry(),
                                               port=0).start()
        for step in ("alive", "stale", "beat", "critical"):
            if step == "stale":  # the critical pump goes silent
                time.sleep(0.3)
            for name, m in PACKAGES.items():
                if step == "beat":
                    beats[name].beat()
                elif step == "critical":
                    _governor(m, "CRITICAL")
            seen[step] = {name: (_probe(srv.port, "/healthz"),
                                 _probe(srv.port, "/readyz"))
                          for name, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.stop()
    for step, both in seen.items():
        assert both["port"] == both["jax"], step
    codes = {step: (both["port"][0][0], both["port"][1][0])
             for step, both in seen.items()}
    assert codes == {"alive": (200, 200), "stale": (503, 503),
                     "beat": (200, 200), "critical": (200, 503)}
    assert seen["critical"]["port"][1][1]["governor"] == "critical"


def test_the_servers_routes():
    """/metrics carries the port's families (p2p, slash and snapshot
    among them, and the round timeline's once obs is imported; netem's
    once chaostest/netem.py is imported, as in the JAX package);
    /debug/pprof/* and
    /debug/trace answer; an unknown route is a 404; stopping a server
    that never started is a no-op."""
    import importlib
    import sys

    from harmony_tpu_torch import aot, obs, sched  # noqa: F401 — families

    T_HL.configure(enabled=False)
    T_HL.register("pump", critical=True)
    T_PROF.configure(enabled=True)
    with T_PROF.stage("hash_to_g2"):
        pass
    registry = T_MT.Registry()
    registry.counter("harmony_test_total", "a registry's own").inc(2)
    srv = T_MT.MetricsServer(registry, port=0).start()
    try:
        status, text = _get(srv.port, "/metrics")
        text = text.decode()
        assert status == 200
        for family in ("harmony_device_checks_total",
                       "harmony_device_jit_programs_total",
                       "harmony_resilience_events_total",
                       "harmony_sched_shed_total",
                       "harmony_sched_batch_fill_ratio",
                       "harmony_process_rss_bytes",
                       "harmony_process_threads",
                       "harmony_health_up", "harmony_governor_state",
                       "harmony_prof_stage_seconds",
                       "harmony_aot_fallback_total",
                       "harmony_aot_cache_total",
                       "harmony_p2p_invalid_messages_total",
                       "harmony_slash_events_total",
                       "harmony_snapshot_bootstrap_total",
                       "harmony_round_phase_seconds",
                       "harmony_replay_stage_seconds",
                       "harmony_test_total 2"):
            assert family in text, family
        netem = "harmony_tpu_torch.chaostest.netem"
        if netem not in sys.modules:
            assert "harmony_netem_" not in text
            importlib.import_module(netem)
            status, text = _get(srv.port, "/metrics")
            text = text.decode()
        assert status == 200 and "harmony_netem_events_total" in text
        status, body = _get(srv.port, "/debug/pprof/threadz")
        assert status == 200 and b"MainThread" in body
        status, body = _get(srv.port, "/debug/pprof/")
        assert status == 200 and b"/debug/pprof/goroutine" in body
        status, body = _get(srv.port, "/debug/trace")
        assert status == 200 and "traceEvents" in json.loads(body)
        assert _get(srv.port, "/debug/pprof/nothing")[0] == 404
        assert _get(srv.port, "/nothing")[0] == 404
    finally:
        srv.stop()
    T_MT.MetricsServer(T_MT.Registry(), port=0).stop()
    assert T_MT.process_sample().keys() == J_MT.process_sample().keys()


def _family_shape(text):
    """The rendered families' HELP and TYPE lines, and the samples of the
    fixed-key tables (labels ``kind`` and ``stage``); samples whose labels
    depend on what this process ran (hosts, outcomes, votes) left out."""
    heads = [line for line in text.splitlines() if line.startswith("#")]
    fixed = sorted(line.split(" ")[0] for line in text.splitlines()
                   if not line.startswith("#")
                   and ('{kind="' in line or '{stage="' in line)
                   and "inbound_votes" not in line)
    return heads, fixed


@pytest.mark.parametrize("family", ("_p2p_counters", "_slash_counters",
                                    "_snapshot_counters", "_obs_counters"))
def test_registry_families_equal_the_jax_packages(family):
    """The p2p, slash, snapshot and obs (round phases, replay stages)
    families render with the JAX package's names, help, types and fixed
    label sets, and /metrics carries them."""
    import harmony_tpu.obs  # noqa: F401 — the obs families render once
    import harmony_tpu_torch.obs  # noqa: F401 — their packages are loaded

    got = getattr(T_MT.Registry, family)()
    assert _family_shape(got) == _family_shape(getattr(J_MT.Registry,
                                                       family)())
    assert all(line in T_MT.Registry().expose()
               for line in _family_shape(got)[0])


def _span_tree(m):
    """One round's spans on two nodes, with the node attribution, the
    round SLO, the export hook and the Chrome export; what they gave,
    ids and times left out."""
    exported = []
    m.TR.configure(enabled=True, sample_rate=1.0, round_slo_s=0.25)
    m.TR.set_export_hook(lambda span: exported.append(
        (span.name, span.attrs.get("node"))))
    m.TR.set_node("node-a")
    nodes = [m.TR.current_node()]
    with m.TR.span("fbft.round", component="consensus", view=7) as root:
        with m.TR.span("sched.enqueue", component="sched", lane="consensus"):
            m.TR.annotate(queue_depth=1)
        with m.TR.node_scope("node-b"):
            nodes.append(m.TR.current_node())
            with m.TR.span("device.dispatch", component="device",
                           kind="agg_verify"):
                pass
        nodes.append(m.TR.current_node())
        trace_id = root.trace_id
    m.TR.bind_node("node-c")
    nodes.append(m.TR.current_node())
    m.TR.bind_node(None)
    slo = m.TR.round_slo_s()
    m.TR.configure(round_slo_s=None)
    chrome = m.TR.export_chrome(trace_id)
    ids = {}
    events = []
    for e in chrome["traceEvents"]:
        e = dict(e)
        args = dict(e.get("args", {}))
        for key in ("trace_id", "span_id", "parent_id"):
            if key in args:
                args[key] = ids.setdefault(args[key], len(ids))
        e["args"] = args
        for key in ("ts", "dur", "pid", "tid"):
            e.pop(key, None)
        events.append(e)
    return (nodes, slo, m.TR.round_slo_s(), exported, events,
            chrome["displayTimeUnit"])


def test_trace_export_and_attribution_equal_the_jax_packages():
    out = {name: _span_tree(m) for name, m in PACKAGES.items()}
    assert out["port"] == out["jax"]
    nodes, slo, disarmed, exported, events, _ = out["port"]
    assert nodes == ["node-a", "node-b", "node-a", "node-c"]
    assert (slo, disarmed) == (0.25, None)
    assert exported == [("sched.enqueue", "node-a"),
                        ("device.dispatch", "node-b"),
                        ("fbft.round", "node-a")]
    assert {e["ph"] for e in events} == {"X", "M"}


def test_capture_writes_a_chrome_trace_and_nests(tmp_path, monkeypatch):
    """On the CPU the capture records torch's CPU ops; the file parses as
    Chrome trace JSON, a nested capture shares the outer one's file, and
    without a directory the block runs uninstrumented."""
    import torch

    monkeypatch.delenv("HARMONY_TPU_PROFILE_DIR", raising=False)
    with T_PROF.capture() as off:
        pass
    assert off.path is None
    monkeypatch.setenv("HARMONY_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    with T_PROF.capture() as outer:
        torch.ones(8).add_(1)
        with T_PROF.capture(str(tmp_path / "other")) as inner:
            torch.ones(8).mul_(2)
        assert inner.path == outer.path
        assert T_PROF._capture_depth == 1
    assert T_PROF._capture_depth == 0
    files = list((tmp_path / "prof").iterdir())
    assert [str(f) for f in files] == [outer.path]
    assert not (tmp_path / "other").exists()
    names = {e.get("name") for e in json.loads(files[0].read_text())[
        "traceEvents"]}
    assert {"aten::add_", "aten::mul_"} <= names
    with T_PROF.capture(str(tmp_path / "again")) as again:
        pass
    assert again.path != outer.path and json.load(open(again.path))
