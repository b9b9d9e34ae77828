"""The port's observability, scheduler and compile-surface smokes
(``harmony_tpu_torch/tools/``) against the JAX package's (``tools/``).

The JAX tools set environment variables at import, so they run as
subprocesses of this interpreter; so do the port's, with ``--cpu`` (the
node's checks on the CPU through the twins), each from a fresh process
as the JAX tool's.  Both must pass their
own gates, print the same lines, and count no first use after warmup
across the committee-width change."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from harmony_tpu_torch import device as DV
from harmony_tpu_torch import sched, trace

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    sched.reset()
    trace.reset()
    fallbacks = DV.COUNTERS["ref_fallback"]
    yield
    sched.reset()
    trace.reset()
    trace.configure(enabled=False)
    DV.use_device(None)
    assert DV.COUNTERS["ref_fallback"] == fallbacks
    assert "HARMONY_KERNEL_TWIN" not in os.environ


def jax_tool(name, *argv):
    """(rc, stdout) of the JAX package's tools/<name>.py."""
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / f"{name}.py"), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return out.returncode, out.stdout


def port_tool(name, *argv):
    """(rc, stdout) of python -m harmony_tpu_torch.tools.<name> --cpu: a
    fresh process, as the JAX tool's, so that no counter of this one
    (fill ratio, sheds, first uses) enters its checks."""
    out = subprocess.run(
        [sys.executable, "-m", f"harmony_tpu_torch.tools.{name}", "--cpu",
         *argv], cwd=REPO, capture_output=True, text=True, timeout=120)
    return out.returncode, out.stdout


def _lines(name, out):
    """The tool's own lines, numbers and ids masked: what both packages
    must print alike."""
    own = [ln for ln in out.splitlines() if ln.startswith(name)]
    return [re.sub(r"[0-9a-f]{32}|\d+(\.\d+)?", "#", ln) for ln in own]


@pytest.mark.parametrize("name", ("obs_smoke", "sched_smoke",
                                  "compile_surface_smoke"))
def test_the_smoke_passes_in_both_packages(name):
    rc, want = jax_tool(name)
    assert rc == 0, want[-2000:]
    rc, got = port_tool(name)
    assert rc == 0, got[-2000:]
    assert _lines(name, got) == _lines(name, want)


def test_no_first_use_after_warmup_in_either_package():
    """Both count 0 first uses after warmup across the width change, the
    port's on the twins' program names, with the same warm dispatches."""
    rc, want = jax_tool("compile_surface_smoke")
    assert rc == 0
    rc, got = port_tool("compile_surface_smoke")
    assert rc == 0
    pattern = (r"width 5 -> 12 \(bucket 8 -> 16\), (\d+) warm dispatches, "
               r"0 post-warmup compiles \((\d+) programs warmed, mode=twin\)")
    assert re.search(pattern, got).groups() == re.search(
        pattern, want).groups()


def test_a_gap_in_the_manifest_is_a_first_use(capsys, monkeypatch):
    """The gate bites: a manifest without the bucket-16 quorum program
    leaves that program cold, and the smoke fails on its first use."""
    from harmony_tpu_torch import aot
    from harmony_tpu_torch.tools import compile_surface_smoke as CSS

    full = aot.load_manifest

    def gapped():
        m = full()
        for fam in m["programs"]:
            fam["names"] = [n for n in fam["names"] if n != "agg_verify_b16"]
        return m

    monkeypatch.setattr(aot, "load_manifest", gapped)
    monkeypatch.setattr(DV, "_SEEN_PROGRAMS", set())
    with pytest.raises(SystemExit) as e:
        CSS.main(["--cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "post-warmup first use" in out and "agg_verify_b16" in out
