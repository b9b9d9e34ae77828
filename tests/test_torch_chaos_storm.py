"""The chaos framework's acceptance scenario on both packages:
``view_change_storm(quick=True)`` (the leader black-holed under an
ingress flood, the committee changes view and keeps committing, the
healed ex-leader resyncs) must pass on the port, on the twins off the
card, as it passes on the JAX package.  Thread interleavings differ from
run to run, so the two runs are held to their verdicts and floors, not
to equal numbers."""

from __future__ import annotations

import pytest

from harmony_tpu.chaostest import run as jax_run
from harmony_tpu.chaostest import scenarios as JSC
from harmony_tpu_torch import device as TDV
from harmony_tpu_torch.chaostest import run as port_run
from harmony_tpu_torch.chaostest import scenarios as TSC


@pytest.mark.parametrize("package", ["jax", "port"])
def test_view_change_storm_passes(package, tmp_path, monkeypatch):
    monkeypatch.setenv("HARMONY_TPU_TRACE_DIR", str(tmp_path))
    monkeypatch.delenv("HARMONY_CHAOS_REAL_KERNELS", raising=False)
    run, scenarios = {"jax": (jax_run, JSC), "port": (port_run, TSC)}[package]
    fallbacks = TDV.COUNTERS["ref_fallback"]
    checks = TDV.COUNTERS["agg_verify"] + TDV.COUNTERS["batch_verify"]
    r = run(scenarios.view_change_storm(quick=True))
    assert r.passed, f"violations: {r.violations}"
    assert r.metrics["consensus_sheds"]["value"] == 0
    assert r.metrics["new_views_adopted"]["value"] >= 1
    assert r.metrics["blocks_min"]["value"] >= 4
    assert not r.violation_dumps
    # the port's quorum checks went through the device path (the twins),
    # none fell back to the host
    assert TDV.COUNTERS["ref_fallback"] == fallbacks
    if package == "port":
        assert (TDV.COUNTERS["agg_verify"] + TDV.COUNTERS["batch_verify"]
                > checks)
