"""The port's load generator (``harmony_tpu_torch/tools/loadgen.py``)
against the JAX package's (``tools/loadgen.py``) at a small load: two
seconds of 200 transfers/s and 4 proofs of possession/s over four nodes.
Both must report the same metric names and checks, every check true; the
numbers differ by thread timing and are held to their floors only.  The
JAX tool runs as a subprocess (it sets environment variables at import),
and so does the port's, with ``--cpu``: each a fresh process, so that no
counter of this one (sheds, lanes' items) enters its checks."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ARGS = ("--duration", "2", "--rate", "200", "--rate-floor", "100",
        "--pop-rate", "4", "--check")


def _report(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"metric"')][-1])


def _run(*cmd):
    """(rc, the report line, stderr) of one run."""
    out = subprocess.run([sys.executable, *cmd], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return out.returncode, _report(out.stdout), out.stderr


def test_both_packages_report_the_same_metrics_and_checks():
    rc, jax_report, err = _run(str(REPO / "tools" / "loadgen.py"), *ARGS)
    assert rc == 0, err[-2000:]
    rc, got, err = _run("-m", "harmony_tpu_torch.tools.loadgen", *ARGS,
                        "--cpu")
    assert rc == 0, err[-2000:]
    assert set(got["extra"]) == set(jax_report["extra"])
    assert got["meta"]["checks"] == jax_report["meta"]["checks"]
    assert all(got["meta"]["checks"].values())
    assert got["metric"] == jax_report["metric"] == \
        "loadgen_submitted_tx_per_s"
    for report in (got, jax_report):
        assert report["meta"]["lanes_active"] == [
            "consensus", "ingress", "sync"]
        assert report["value"] >= 100
        assert report["extra"]["consensus_lane_sheds"]["value"] == 0
        assert report["extra"]["round_p50_s"]["rounds"] >= 2
        for name, entry in report["extra"].items():
            assert entry["source"] == "measured", name


def test_the_rate_floor_bites():
    """A floor above the pace fails --check (exit 1) with only the rate
    check false."""
    argv = list(ARGS)
    argv[argv.index("--rate-floor") + 1] = "100000"
    rc, report, _ = _run("-m", "harmony_tpu_torch.tools.loadgen", *argv,
                         "--cpu")
    assert rc == 1
    checks = report["meta"]["checks"]
    assert [k for k, ok in checks.items() if not ok] == ["rate_floor"]
