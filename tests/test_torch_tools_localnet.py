"""The port's localnet launcher (``harmony_tpu_torch/tools/localnet.py``)
on this CPU: a bootnode and four ``python -m harmony_tpu_torch.cli``
processes of one dev key each, host-verifying (``--cpu``), commit two
blocks at a 1 s block time and exit 0, with no traceback in any node's
log.  The launcher uses the JAX package's fixed ports (RPC 9500+, p2p
9000+, sync 9100+, metrics 9700+, the bootnode's 9900); where one of
them is taken on this machine the test skips and names it."""

from __future__ import annotations

import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
NODES = 4
PORTS = [9900] + [base + i for base in (9500, 9000, 9100, 9700)
                  for i in range(NODES)]


def _taken(port):
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind(("127.0.0.1", port))
        except OSError:
            return True
    return False


def test_four_node_processes_commit_two_blocks(tmp_path):
    taken = [p for p in PORTS if _taken(p)]
    if taken:
        pytest.skip(f"the localnet's fixed ports {taken} are in use here")
    data = tmp_path / "net"
    out = subprocess.run(
        [sys.executable, "-m", "harmony_tpu_torch.tools.localnet", "--cpu",
         "--nodes", str(NODES), "--blocks", "2", "--block-time", "1",
         "--data-dir", str(data), "--timeout", "120"],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, (out.stdout + out.stderr)[-3000:]
    assert "localnet OK: shard heads {0: " in out.stdout
    head = int(out.stdout.split("localnet OK: shard heads {0: ")[1]
               .split("}")[0])
    assert head >= 2
    logs = sorted(data.glob("s0n*.log"))
    assert len(logs) == NODES
    for log in logs:
        text = log.read_text(errors="replace")
        assert "Traceback" not in text, text[-2000:]
        assert "harmony-tpu node up" in text or "node up" in text
    # every node kept its chain on disk (a relaunch resumes from it)
    assert all((data / f"s0n{i}").is_dir() for i in range(NODES))

