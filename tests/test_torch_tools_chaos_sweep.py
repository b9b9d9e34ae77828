"""The port's chaos sweep (``harmony_tpu_torch/tools/chaos_sweep.py``):
its usage errors exit 2 as the JAX package's ``tools/chaos_sweep.py``
does, and ``view_change_storm --quick --check --cpu`` passes on the twins
with the JAX tool's metric names, its bench file written where asked."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from harmony_tpu_torch import device as DV
from harmony_tpu_torch import sched, trace
from harmony_tpu_torch.chaostest import SCENARIOS
from harmony_tpu_torch.tools import chaos_sweep

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    monkeypatch.delenv("HARMONY_CHAOS_REAL_KERNELS", raising=False)
    monkeypatch.setenv("HARMONY_TPU_TRACE_DIR", str(tmp_path / "dumps"))
    yield
    sched.reset()
    trace.reset()
    trace.configure(enabled=False)
    DV.use_device(None)
    assert "HARMONY_KERNEL_TWIN" not in os.environ


@pytest.mark.parametrize("argv", (
    ["--scenario", "no_such_scenario"],
    ["--only", "matches-nothing"],
    ["--scenario", "view_change_storm", "--only", "rolling"],
), ids=("unknown-scenario", "unmatched-only", "only-filters-scenarios"))
def test_usage_errors_exit_2_in_both_packages(argv, capsys):
    jax = subprocess.run(
        [sys.executable, str(REPO / "tools" / "chaos_sweep.py"), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert jax.returncode == 2
    capsys.readouterr()
    assert chaos_sweep.main([*argv, "--cpu"]) == 2
    err = capsys.readouterr().err
    assert err.splitlines()[-1] == jax.stderr.splitlines()[-1]
    assert str(sorted(SCENARIOS)) in err


def test_view_change_storm_passes_on_the_twins(tmp_path, capsys):
    bench = tmp_path / "bench.json"
    capsys.readouterr()
    assert chaos_sweep.main([
        "--quick", "--check", "--cpu", "--scenario", "view_change_storm",
        "--bench-out", str(bench), "--bench-round", "6"]) == 0
    doc = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith('{"metric"')][-1])
    assert doc["value"] == 1 and doc["meta"]["violations"] == []
    assert doc["meta"]["scenarios"] == ["view_change_storm"]
    extra = doc["extra"]
    assert extra["chaos_scenarios_passed"]["total"] == 1
    for name in ("blocks_min", "round_p99_s", "consensus_sheds",
                 "new_views_adopted"):
        assert f"chaos_view_change_storm_{name}" in extra
    assert extra["chaos_view_change_storm_consensus_sheds"]["value"] == 0
    written = json.loads(bench.read_text())
    assert written["n"] == 6 and written["parsed"] == doc
