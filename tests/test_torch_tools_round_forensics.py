"""The port's round forensics
(``harmony_tpu_torch/tools/round_forensics.py``) against the JAX
package's (``tools/round_forensics.py``) on the same span files: two
rounds of four in-process port nodes, pumped by hand, traced into the
port's ``SpanSink``.  Both reports must be equal: the
timelines, the attributed fraction, the dominating phase and each
phase's quantiles.  The JAX tool runs as a subprocess (it sets
environment variables at import), the port's in this process."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from harmony_tpu_torch import device as DV
from harmony_tpu_torch import health, obs, trace
from harmony_tpu_torch.tools import round_forensics

REPO = Path(__file__).resolve().parents[1]
CHAIN_ID = 2


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    trace.reset()
    health.reset()
    trace.configure(dump_dir=str(tmp_path / "dumps"))
    yield
    trace.reset()
    health.reset()
    trace.configure(enabled=False)
    DV.use_device(None)


@pytest.fixture(scope="module")
def span_files(tmp_path_factory):
    """Two committed rounds of four port nodes on the host path, every
    finished span exported by the port's ``SpanSink`` as the node binary
    does under ``--span-sink-dir``."""
    from harmony_tpu_torch.core.blockchain import Blockchain
    from harmony_tpu_torch.core.genesis import dev_genesis
    from harmony_tpu_torch.core.kv import MemKV
    from harmony_tpu_torch.core.tx_pool import TxPool
    from harmony_tpu_torch.multibls import PrivateKeys
    from harmony_tpu_torch.node.node import Node
    from harmony_tpu_torch.node.registry import Registry
    from harmony_tpu_torch.p2p import InProcessNetwork

    directory = tmp_path_factory.mktemp("spans")
    trace.reset()
    DV.use_device(False)
    trace.configure(enabled=True)
    sink = obs.SpanSink(str(directory)).arm()
    genesis, _, bls_keys = dev_genesis(n_keys=4)
    net = InProcessNetwork()
    nodes = []
    try:
        for i in range(4):
            chain = Blockchain(MemKV(), genesis, blocks_per_epoch=16)
            reg = Registry(blockchain=chain,
                           txpool=TxPool(CHAIN_ID, 0, chain.state),
                           host=net.host(f"node{i}"))
            nodes.append(Node(reg, PrivateKeys.from_keys([bls_keys[i]])))
        for height in (1, 2):
            next(n for n in nodes if n.is_leader).start_round_if_leader()
            for _ in range(50):
                if not any(n.process_pending() for n in nodes):
                    break
            assert all(n.chain.head_number == height for n in nodes)
    finally:
        for n in nodes:
            n.stop()
        sink.close()
        DV.use_device(None)
    trace.reset()
    assert sink.written and not sink.dropped
    return sink.files()


def _jax_report(files, out, *argv):
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "round_forensics.py"),
         *files, "--out", str(out), *argv],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    return proc.returncode, proc.stderr


def test_both_packages_give_the_same_report(span_files, tmp_path):
    rc, err = _jax_report(span_files, tmp_path / "jax.json", "--check")
    assert rc == 0, err[-2000:]
    want = json.loads((tmp_path / "jax.json").read_text())
    assert round_forensics.main(
        [*span_files, "--check", "--out", str(tmp_path / "port.json")]) == 0
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == want
    agg = got["aggregate"]
    assert agg["rounds"] == 2 and agg["attributed_fraction"] >= 0.95
    assert agg["dominant_phase"] in obs.PHASES


def test_a_directory_of_sink_files_reads_as_its_files(span_files, tmp_path):
    """A directory argument takes its spans_*.jsonl* files: the same
    report as the files named one by one."""
    directory = os.path.dirname(span_files[0])
    for argv, out in (([directory], "dir.json"), (span_files, "files.json")):
        assert round_forensics.main(
            [*argv, "--out", str(tmp_path / out)]) == 0
    assert (tmp_path / "dir.json").read_text() == (
        tmp_path / "files.json").read_text()


def test_no_input_and_no_rounds_fail_as_the_jax_tool(tmp_path, capsys):
    assert round_forensics.main([]) == 2
    empty = tmp_path / "spans_none.jsonl"
    empty.write_text("")
    rc, _ = _jax_report([str(empty)], tmp_path / "jax.json", "--check")
    assert rc == 1
    assert round_forensics.main(
        [str(empty), "--check", "--out", str(tmp_path / "port.json")]) == 1
    assert (tmp_path / "port.json").read_text() == (
        tmp_path / "jax.json").read_text()
