"""Each operator tool of the port that builds nodes or checks signatures
runs those checks on the card unless it is given ``--cpu``: without CUDA
it raises ``RuntimeError`` before it builds anything, never answers on
the host or the twins, and leaves the node's device path as it found it.
CUDA is hidden by patching ``torch.cuda.is_available``, so the tests
hold on a machine with a card too."""

from __future__ import annotations

import importlib
import os

import pytest
import torch

from harmony_tpu_torch import device as DV
from harmony_tpu_torch import sched, trace

CASES = {
    "obs_smoke": [],
    "sched_smoke": [],
    "compile_surface_smoke": [],
    "loadgen": ["--duration", "1", "--check"],
    "soak": ["--quick", "--check"],
    "chaos_sweep": ["--quick", "--check", "--scenario", "view_change_storm"],
    "round_forensics": ["--scenario", "view_change_storm", "--quick"],
    "localnet": ["--nodes", "4", "--blocks", "1"],
}


@pytest.fixture(autouse=True)
def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    sched.reset()
    yield
    sched.reset()
    trace.reset()
    trace.configure(enabled=False)


@pytest.mark.parametrize("name", sorted(CASES))
def test_without_cuda_and_without_cpu_the_tool_raises(name, monkeypatch):
    built = []

    def no_building(*a, **k):
        built.append(a)
        raise AssertionError("a node was built before the device check")

    from harmony_tpu_torch.core import blockchain
    monkeypatch.setattr(blockchain.Blockchain, "__init__", no_building)
    monkeypatch.setattr("subprocess.Popen", no_building)
    checks = DV.COUNTERS["agg_verify"] + DV.COUNTERS["verify"]
    tool = importlib.import_module(f"harmony_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool.main(CASES[name])
    assert not built
    assert DV.COUNTERS["agg_verify"] + DV.COUNTERS["verify"] == checks
    assert DV._FORCED is None and DV._NODE_DEVICE is None
    assert "HARMONY_KERNEL_TWIN" not in os.environ


class _Child:
    pid = 0
    returncode = None

    def poll(self):
        return None

    def send_signal(self, sig):
        pass

    wait = kill = send_signal


@pytest.mark.parametrize("flags,verify", [
    ((), "--device-verify"),
    (("--device-path",), "--device-verify"),
    (("--cpu",), "--host-verify"),
    (("--cpu", "--device-path"), "--host-verify"),
])
def test_localnet_nodes_check_on_the_card_unless_given_cpu(
        flags, verify, monkeypatch, tmp_path):
    """A localnet's node processes verify on the card by default and on
    the host only under --cpu; --device-path changes nothing."""
    from harmony_tpu_torch.tools import localnet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cmds = []

    def child(cmd, **kw):
        cmds.append(cmd)
        return _Child()

    def interrupt(_):
        raise KeyboardInterrupt

    monkeypatch.setattr(localnet.subprocess, "Popen", child)
    monkeypatch.setattr(localnet.time, "sleep", interrupt)
    assert localnet.main(["--nodes", "4", "--blocks", "1", "--data-dir",
                          str(tmp_path), *flags]) == 0
    nodes = [c for c in cmds if "harmony_tpu_torch.cli" in c]
    assert len(nodes) == 4 and len(cmds) == 5
    other = ({"--device-verify", "--host-verify"} - {verify}).pop()
    assert all(verify in c and other not in c for c in nodes)


def test_the_storage_tool_needs_no_card(capsys):
    """crash_sweep checks no signature: it runs without CUDA and takes
    no --cpu."""
    from harmony_tpu_torch.tools import crash_sweep

    assert crash_sweep.main(["--blocks", "1", "--stride", "512",
                             "--no-native", "--check"]) == 0
    with pytest.raises(SystemExit):
        crash_sweep.main(["--cpu"])
    capsys.readouterr()


def test_span_files_need_no_card(tmp_path):
    """round_forensics over span files builds no node: no CUDA needed."""
    from harmony_tpu_torch.tools import round_forensics

    empty = tmp_path / "spans_x.jsonl"
    empty.write_text("")
    assert round_forensics.main([str(empty), "--out",
                                 str(tmp_path / "r.json")]) == 0


@pytest.mark.parametrize("name", ("obs_smoke", "compile_surface_smoke"))
def test_with_cpu_the_twins_answer_and_the_path_goes_back_to_auto(name):
    tool = importlib.import_module(f"harmony_tpu_torch.tools.{name}")
    assert tool.main(["--cpu"]) == 0
    assert DV._FORCED is None and DV._NODE_DEVICE is None
    assert "HARMONY_KERNEL_TWIN" not in os.environ
