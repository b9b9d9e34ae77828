"""The port's node binary (``harmony_tpu_torch/cli.py``) against the JAX
package's ``cli.py``: tests/test_cli.py's cases on the port, and the
binary's offline modes on copies of one chain in both packages.

``build_node`` brings up the whole stack (chain on the port's native KV,
consensus, RPC, WebSocket, explorer, Rosetta, metrics, sync server, the
span sink) with host checks, and the dev node commits blocks alone.
``load_config`` reads the same TOML and overrides to the same config.
``main(argv)`` with ``--revert-to``, ``--snapshot-export``,
``--snapshot-import`` and ``--prune-states`` prints the same lines and
leaves the same heads as the JAX package's.  ``--device-verify`` without
CUDA fails at boot: a check bound for the card is never answered on the
host."""

import base64
import http.client
import json
import os
import shutil
import socket
import time

import pytest

from harmony_tpu import cli as J_CLI
from harmony_tpu.core import kv as J_KV
from harmony_tpu.core.blockchain import Blockchain as J_Blockchain
from harmony_tpu.core.genesis import dev_genesis as j_dev_genesis
from harmony_tpu.core.tx_pool import TxPool as J_TxPool
from harmony_tpu.core.types import Transaction as J_Transaction
from harmony_tpu.node.worker import Worker as J_Worker
from harmony_tpu_torch import cli as T_CLI
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import trace as T_TR
from harmony_tpu_torch.core.kv_native import NativeKV

CHAIN_ID = 2


def _rpc(port, method, params=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("POST", "/", json.dumps({
        "jsonrpc": "2.0", "id": 1, "method": method,
        "params": params or []}), {"Content-Type": "application/json"})
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = (resp.status, resp.read())
    conn.close()
    return out


def _cfg(tmp_path, **over):
    cfg = T_CLI.load_config(None, {})
    cfg.update(datadir=str(tmp_path), rpc_port=0, metrics_port=0,
               p2p_port=0, sync_port=0, blocks_per_epoch=16, **over)
    return cfg


def test_build_node_full_stack(tmp_path):
    """The dev node holds the whole committee: blocks flow solo, on its
    native-KV datadir, with every optional service up."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    ws_port = probe.getsockname()[1]
    probe.close()
    cfg = _cfg(tmp_path / "data", ws_port=ws_port, explorer_port=0,
               rosetta_port=0, block_time=0.5,
               span_sink_dir=str(tmp_path / "spans"))
    node, manager, reg, rpc, metrics = T_CLI.build_node(cfg)
    assert isinstance(node.chain.db, NativeKV)
    manager.start_services()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and node.chain.head_number < 2:
            time.sleep(0.05)
        assert node.chain.head_number >= 2
        assert _rpc(rpc.port, "hmyv2_blockNumber")["result"] >= 2
        block1 = _rpc(rpc.port, "hmy_getBlockByNumber", ["0x1", False])
        assert block1["result"]["number"] == "0x1"
        status, text = _get(metrics.port, "/metrics")
        assert status == 200
        assert b"harmony_round_phase_seconds" in text
        assert _get(metrics.port, "/readyz")[0] == 200
        status, height = _get(reg.get("explorer").port, "/height")
        assert status == 200 and json.loads(height)["height"] >= 2
        conn = http.client.HTTPConnection(
            "127.0.0.1", reg.get("rosetta").port, timeout=10)
        conn.request("POST", "/network/status", "{}")
        status = json.loads(conn.getresponse().read())
        conn.close()
        assert status["current_block_identifier"]["index"] >= 2
        sock = socket.create_connection(("127.0.0.1", cfg["ws_port"]),
                                        timeout=10)
        key = base64.b64encode(b"0123456789abcdef").decode()
        sock.sendall(
            f"GET / HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        assert b" 101 " in sock.recv(4096).split(b"\r\n")[0]
        sock.close()
    finally:
        manager.stop_services()
        node.chain.db.close()
        T_TR.reset()
    assert any(name.startswith("spans_")
               for name in os.listdir(tmp_path / "spans"))


def test_load_config_as_the_jax_package(tmp_path):
    cfg_file = tmp_path / "node.toml"
    cfg_file.write_text(
        'network = "testnet"\nshard_id = 3\nrpc_port = 1234\n'
        'peers = ["127.0.0.1:9000"]\nws_port = 0\n'
        'governor_limits = { rss_pressured_bytes = 123 }\n'
        '[[bls_keys]]\npath = "k.key"\npassphrase_env = "P"\n')
    overrides = {"rpc_port": 4321, "block_time": 1.5, "datadir": None,
                 "fsync": "always"}
    assert T_CLI.DEFAULTS == J_CLI.DEFAULTS
    got = T_CLI.load_config(str(cfg_file), overrides)
    assert got == J_CLI.load_config(str(cfg_file), overrides)
    assert got["rpc_port"] == 4321 and got["shard_id"] == 3
    assert got["datadir"] == T_CLI.DEFAULTS["datadir"]
    assert T_CLI.load_config(None, {}) == J_CLI.load_config(None, {})


def test_foreign_shard_committee_fails_closed(tmp_path):
    cfg = _cfg(tmp_path, in_memory=True)
    node, manager, reg, rpc, metrics = T_CLI.build_node(cfg)
    try:
        engine = node.chain.engine
        assert len(engine.epoch_context(cfg["shard_id"], 0)) > 0
        assert len(engine.epoch_context(cfg["shard_id"] + 7, 0)) == 0
        from harmony_tpu_torch.chain.header import Header

        hdr = Header(shard_id=cfg["shard_id"] + 7, epoch=0)
        assert not engine.verify_header_signature(
            hdr, b"\x01" * 96, b"\xff")
    finally:
        manager.stop_services()


def test_device_verify_without_cuda_fails_loudly(tmp_path):
    """Forced onto the card on a machine without CUDA, the binary fails
    at boot (``device.resolve_device``); it never answers on the host."""
    import torch

    assert not torch.cuda.is_available()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            T_CLI.build_node(_cfg(tmp_path / "a", in_memory=True,
                                  device_verify=True))
        with pytest.raises(RuntimeError, match="CUDA"):
            T_CLI.main(["--datadir", str(tmp_path / "b"),
                        "--device-verify", "--skip-ntp-check",
                        "--rpc-port", "0", "--metrics-port", "0",
                        "--p2p-port", "0", "--sync-port", "0",
                        "--log-level", "error"])
        assert T_DV.device_enabled() is True
    finally:
        T_DV.use_device(None)
    # --host-verify forces the host path, as the JAX package's does
    node, manager, *_ = T_CLI.build_node(_cfg(
        tmp_path / "c", in_memory=True, device_verify=False))
    try:
        assert T_DV.device_enabled() is False
        assert node.chain.engine is not None
    finally:
        manager.stop_services()
        T_DV.use_device(None)


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    """A datadir of 6 blocks with transfers, written by the JAX package's
    chain on its FileKV (the binary's dev genesis of 4 keys)."""
    root = tmp_path_factory.mktemp("chain")
    genesis, keys, _ = j_dev_genesis(n_keys=4, shard_id=0)
    db = J_KV.FileKV(str(root / "shard0.db"), fsync="batch")
    chain = J_Blockchain(db, genesis, blocks_per_epoch=32768)
    pool = J_TxPool(CHAIN_ID, 0, chain.state)
    worker = J_Worker(chain, pool)
    for i in range(6):
        pool.add(J_Transaction(
            nonce=i, gas_price=1, gas_limit=25_000, shard_id=0, to_shard=0,
            to=bytes([0x40 + i]) * 20, value=1000 + i).sign(keys[0],
                                                            CHAIN_ID))
        block = worker.propose_block(view_id=i + 1, timestamp=100 + i)
        assert chain.insert_chain([block], verify_seals=False) == 1
        assert len(block.transactions) == 1
        pool.drop_applied()
    db.close()
    return root


def _run(CLI, argv, capsys):
    assert CLI.main(argv + ["--log-level", "error"]) == 0
    return capsys.readouterr().out


def _head(CLI, datadir, native):
    cfg = CLI.load_config(None, {"datadir": str(datadir),
                                 "native_kv": native})
    chain = CLI.open_chain_for_maintenance(cfg)
    try:
        return chain.head_number, chain.current_header().hash()
    finally:
        chain.db.close()


@pytest.mark.parametrize("mode", ("revert", "snapshot", "prune"))
def test_offline_maintenance_as_the_jax_package(chain_dir, tmp_path,
                                                capsys, mode):
    """Each package's binary on its own copy of one chain; the port's on
    its native KV, the JAX package's on its FileKV (one format)."""
    seen = {}
    for name, CLI, flags in (("jax", J_CLI, ["--no-native-kv"]),
                             ("port", T_CLI, [])):
        d = tmp_path / name
        shutil.copytree(chain_dir, d / "data")
        base = ["--datadir", str(d / "data"), *flags]
        if mode == "revert":
            lines = _run(CLI, base + ["--revert-to", "3"], capsys)
        elif mode == "snapshot":
            lines = _run(CLI, base + ["--snapshot-export",
                                      str(d / "head.snap")], capsys)
            lines += _run(CLI, base + ["--snapshot-import",
                                       str(d / "head.snap"),
                                       "--prune-states", "2"], capsys)
            lines = lines.replace(str(d), "<dir>")
            seen[name + " file"] = (d / "head.snap").read_bytes()
        else:
            lines = _run(CLI, base + ["--prune-states", "4"], capsys)
            lines += _run(CLI, base + ["--prune-states", "1"], capsys)
        seen[name] = (lines, _head(CLI, d / "data", name == "port"))
    assert seen["port"] == seen["jax"]
    lines, (head, _) = seen["port"]
    if mode == "revert":
        assert lines == "reverted 3 block(s); head is now 3\n" and head == 3
    elif mode == "snapshot":
        assert seen["port file"] == seen["jax file"]
        assert lines.startswith("snapshot of block 6 -> <dir>/head.snap\n"
                                "snapshot installed at block 6\npruned ")
    else:
        assert head == 6 and lines.count("pruned ") == 2
