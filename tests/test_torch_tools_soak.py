"""The port's soak (``harmony_tpu_torch/tools/soak.py``) against the JAX
package's (``tools/soak.py``) on a short window: 6 s at the quick rates,
two rounds, a sample every 0.2 s so that ``samples_collected`` (8 samples
after the warmup share) holds.  Both must report the same metric names
and checks, every check true; the slopes themselves follow the host.
``slope_per_s`` and the bench file are held to the JAX package's on the
same inputs.  Both tools run as fresh processes (the JAX one sets
environment variables at import), so that no counter of this process
(sheds) enters their checks."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from harmony_tpu_torch.tools import soak

REPO = Path(__file__).resolve().parents[1]
ARGS = ("--quick", "--check", "--window", "6", "--rounds", "2",
        "--sample-interval", "0.2")


def _report(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"metric"')][-1])


def test_both_packages_report_the_same_metrics_and_checks(tmp_path):
    jax_bench = tmp_path / "jax.json"
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "soak.py"), *ARGS,
         "--bench-out", str(jax_bench), "--bench-round", "7"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    want = _report(out.stdout)

    port_bench = tmp_path / "port.json"
    out = subprocess.run(
        [sys.executable, "-m", "harmony_tpu_torch.tools.soak", *ARGS,
         "--cpu", "--bench-out", str(port_bench), "--bench-round", "7"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    got = _report(out.stdout)
    assert set(got["extra"]) == set(want["extra"])
    assert got["meta"]["checks"] == want["meta"]["checks"]
    assert all(got["meta"]["checks"].values())
    for report in (got, want):
        assert report["extra"]["soak_samples"]["value"] >= 8
        assert report["extra"]["soak_blocks_min"]["value"] >= 2
    # the bench file the caller named, in the same shape
    jb, pb = (json.loads(p.read_text()) for p in (jax_bench, port_bench))
    assert jb["n"] == pb["n"] == 7
    assert set(pb["parsed"]) == set(jb["parsed"])
    assert pb["cmd"] == "python -m harmony_tpu_torch.tools.soak --quick"


@pytest.mark.parametrize("samples", [
    [],
    [(0.0, 1.0), (1.0, 2.0)],
    [(0.0, 5.0), (1.0, 5.0), (2.0, 5.0)],
    [(0.0, 1.0), (0.5, None), (1.0, 3.0), (2.5, 4.0), (3.0, 9.5)],
    [(1.0, 2.0), (1.0, 3.0), (1.0, 4.0)],
])
def test_slope_per_s_matches_the_jax_tool(samples):
    code = ("import sys, runpy\n"
            f"sys.argv = [{str(REPO / 'tools' / 'soak.py')!r}]\n"
            f"ns = runpy.run_path(sys.argv[0], run_name='soak')\n"
            f"print(repr(ns['slope_per_s']({samples!r})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert repr(soak.slope_per_s(samples)) == out.stdout.strip()
