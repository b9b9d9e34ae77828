"""The port's storage crash-point sweep
(``harmony_tpu_torch/tools/crash_sweep.py``) against the JAX package's
(``tools/crash_sweep.py``) at two blocks and a byte stride of 64: both
sweep the same 26 points (10 kv.commit fault points and 16 truncation
offsets, each also opened by the native store) with no failure.

The JAX tool runs as a subprocess (it sets environment variables at
import), its native binding pointed at the port's build of the same
``kvstore.cpp`` so that it never runs the JAX package's ``make``; the
port's runs in this process."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from harmony_tpu_torch import faultinject as FI
from harmony_tpu_torch.core import kv_native as T_KVN
from harmony_tpu_torch.tools import crash_sweep

REPO = Path(__file__).resolve().parents[1]
ARGS = ("--blocks", "2", "--stride", "64", "--check")


@pytest.fixture(autouse=True)
def _clean():
    FI.reset()
    yield
    FI.reset()


@pytest.fixture(scope="module")
def library():
    return T_KVN.build_native()


def _report(out):
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith('{"metric"')][-1])


def _jax_sweep(library, *argv):
    code = ("import runpy, sys\n"
            "from harmony_tpu.core import kv_native\n"
            f"kv_native._LIB_PATH = {str(library)!r}\n"
            f"sys.argv = [{str(REPO / 'tools' / 'crash_sweep.py')!r}, "
            f"*{list(argv)!r}]\n"
            "runpy.run_path(sys.argv[0], run_name='__main__')\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})


def test_both_packages_sweep_the_same_points(library, capsys):
    out = _jax_sweep(library, *ARGS)
    assert out.returncode == 0, out.stderr[-2000:]
    want = _report(out.stdout)
    capsys.readouterr()
    assert crash_sweep.main(list(ARGS)) == 0
    got = _report(capsys.readouterr().out)
    for report in (got, want):
        points = report["extra"]["crash_points_swept"]
        assert (report["value"], points["value"], points["fault_points"],
                points["truncation_points"]) == (26, 26, 10, 16)
        assert report["meta"] == {"blocks": 2, "stride": 64,
                                  "failures": []}
    assert set(got["extra"]) == set(want["extra"])


def test_the_native_parity_sweep_is_optional(capsys):
    """--no-native sweeps the same points on the FileKV alone."""
    capsys.readouterr()
    assert crash_sweep.main([*ARGS, "--no-native"]) == 0
    got = _report(capsys.readouterr().out)
    assert got["value"] == 26 and got["meta"]["failures"] == []


def test_a_broken_recovery_fails_the_check(capsys, monkeypatch):
    """The gate bites: a reopen that lands one block short is a failure
    at every point, and --check exits 1."""
    real = crash_sweep._reopen

    def short(path, genesis):
        chain = real(path, genesis)
        if chain.head_number:
            chain.revert_to(chain.head_number - 1)
        return chain

    monkeypatch.setattr(crash_sweep, "_reopen", short)
    capsys.readouterr()
    assert crash_sweep.main(["--blocks", "2", "--stride", "256",
                             "--check", "--no-native"]) == 1
    got = _report(capsys.readouterr().out)
    assert got["meta"]["failures"]
    assert got["value"] < got["extra"]["crash_points_swept"]["value"]
