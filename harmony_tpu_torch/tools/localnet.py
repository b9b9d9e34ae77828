"""Localnet launcher: N validator processes + a bootnode on one machine.

The role of the reference's test/deploy.sh + test/configs/ (the
localnet tier of SURVEY §4): spawn a bootnode and one process per
validator, wire discovery + sync peers, wait for blocks to flow, and
tear everything down on Ctrl-C or --blocks N.

Scenarios:
  --multikey M        first M nodes vote with TWO consecutive dev keys
                      (multi-BLS validators, reference: multibls)
  --kill-leader-at B  at shard-0 head B, SIGKILL node 0; the run then
                      requires the chain to keep committing through a
                      full leader-rotation cycle and at least one
                      "adopt new view" in a survivor's log (view change
                      completed)
  --shards S          S committees (S*nodes processes); with
                      --cross-shard a shard-0 -> shard-1 transfer is
                      submitted over RPC and must land as balance on
                      shard 1 (live CXReceiptsProof routing over TCP)

Durable operator runs: ``--data-dir PATH`` pins every
node's shard DB (NativeKV/FileKV) + tx journal + logs to a persistent
directory — Ctrl-C the net, relaunch with the same flag, and every
node reopens its chain from disk through crash recovery (torn batches
discarded, head verified, last-signed views reloaded) and resumes
committing where it stopped.

The processes are the port's: ``python -m harmony_tpu_torch.p2p.discovery``
(the bootnode) and ``python -m harmony_tpu_torch.cli`` (each validator).
Every node checks on the card (``--device-verify``, which fails at boot
without CUDA), and the run then requires every node's /metrics to show
device-path checks; ``--device-real`` also requires them to show no twin
answer and no host fallback.  The launcher needs CUDA unless it is given
``--cpu``, which runs host-verifying nodes (``--host-verify``) on a
machine without a card and checks no device metric.  ``--device-path``
is accepted, as the JAX package's launcher has it, and changes nothing:
the card is the default.  It uses fixed ports: RPC 9500+, p2p 9000+,
sync 9100+, metrics 9700+ and the bootnode's 9900.

Usage:
    python -m harmony_tpu_torch.tools.localnet --nodes 8 --blocks 6 --multikey 2
    python -m harmony_tpu_torch.tools.localnet --nodes 8 --blocks 5 --kill-leader-at 2
    python -m harmony_tpu_torch.tools.localnet --nodes 3 --shards 2 --cross-shard --blocks 8
    python -m harmony_tpu_torch.tools.localnet --nodes 4 --data-dir DIR
    python -m harmony_tpu_torch.tools.localnet --nodes 4 --blocks 3 --device-path --device-real

The port's copy of the JAX package's ``tools/localnet.py``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

from . import add_cpu_flag, card_or_raise

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _rpc(port: int, method: str, params=None, timeout: float = 5):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(
        "POST", "/",
        json.dumps({"jsonrpc": "2.0", "id": 1, "method": method,
                    "params": params or []}),
        {"Content-Type": "application/json"},
    )
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out.get("result")


class Net:
    """Process supervisor for one localnet run."""

    def __init__(self, args, workdir: pathlib.Path):
        self.args = args
        self.workdir = workdir
        self.procs: dict[tuple[int, int], subprocess.Popen] = {}
        self.boot: subprocess.Popen | None = None
        # key layout per shard: first --multikey nodes take 2 keys each
        self.spans = [
            2 if i < args.multikey else 1 for i in range(args.nodes)
        ]
        self.total_keys = sum(self.spans)

    def rpc_port(self, shard: int, i: int) -> int:
        return 9500 + shard * self.args.nodes + i

    def start(self):
        self.boot = subprocess.Popen(
            [sys.executable, "-m", "harmony_tpu_torch.p2p.discovery",
             "--port", "9900"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        print(f"bootnode :9900; {self.args.shards} shard(s) x "
              f"{self.args.nodes} nodes, {self.total_keys} keys/committee, "
              f"{self.args.multikey} multi-key validators")
        for s in range(self.args.shards):
            for i in range(self.args.nodes):
                self.spawn(s, i)

    def spawn(self, shard: int, i: int):
        g = shard * self.args.nodes + i
        key_index = sum(self.spans[:i])
        cmd = [
            sys.executable, "-m", "harmony_tpu_torch.cli",
            "--datadir", str(self.workdir / f"s{shard}n{i}"),
            "--rpc-port", str(9500 + g),
            "--p2p-port", str(9000 + g),
            "--sync-port", str(9100 + g),
            "--metrics-port", str(9700 + g),
            "--bootnode", "127.0.0.1:9900",
            "--shard-id", str(shard),
            "--shard-count", str(self.args.shards),
            "--dev-key-index", str(key_index),
            "--dev-key-span", str(self.spans[i]),
            "--dev-keys", str(self.total_keys),
            "--block-time", str(self.args.block_time),
            "--phase-timeout", str(self.args.phase_timeout),
            "--skip-ntp-check",
        ]
        if self.args.trace or self.args.trace_dir:
            # round tracing on every node: each serves its own
            # /debug/trace; one round's spans share one trace_id
            # across processes (correlate by trace_id in Perfetto)
            cmd += ["--trace"]
        if self.args.trace_dir:
            # durable span export: every node writes rotating JSONL
            # into the shared dir (spans_<node>.jsonl — the node tag
            # disambiguates); feed the files to
            # harmony_tpu_torch.tools.round_forensics for cross-node
            # phase attribution
            trace_dir = pathlib.Path(self.args.trace_dir)
            trace_dir.mkdir(parents=True, exist_ok=True)
            cmd += ["--span-sink-dir", str(trace_dir)]
        if self.args.cpu:
            cmd += ["--host-verify"]
        else:
            # live consensus THROUGH the device path — device.py forced
            # on, every quorum check routed through CommitteeTable +
            # agg_verify_on_device (+ COUNTERS), on the card (the node
            # fails at boot without CUDA, never answers on the host)
            cmd += ["--device-verify"]
        # every node can pull from a neighbour — node 0 included: a
        # node that misses a COMMITTED message recovers via the
        # consensus-timeout sync path, which needs a stream peer
        peer = (i + 1) % self.args.nodes
        cmd += ["--sync-peer",
                f"127.0.0.1:{9100 + shard * self.args.nodes + peer}"]
        if shard > 0:
            cmd += ["--beacon-sync-peer", "127.0.0.1:9100"]
        with open(self.workdir / f"s{shard}n{i}.log", "w") as log:
            self.procs[(shard, i)] = subprocess.Popen(
                cmd, cwd=ROOT, stdout=log, stderr=log,
            )
        print(f"  shard {shard} node {i}: rpc :{9500 + g} "
              f"keys {key_index}..{key_index + self.spans[i] - 1}")

    def kill(self, shard: int, i: int):
        proc = self.procs.pop((shard, i))
        proc.kill()
        proc.wait(5)
        print(f"  KILLED shard {shard} node {i} (pid {proc.pid})")

    def alive_rpc_ports(self, shard: int):
        return [self.rpc_port(s, i) for (s, i) in self.procs
                if s == shard]

    def head(self, shard: int):
        """Network head = max over responding nodes (a lagging or
        resyncing node must not mask the committee's progress)."""
        best = None
        for port in self.alive_rpc_ports(shard):
            try:
                h = _rpc(port, "hmyv2_blockNumber")
            except OSError:
                continue
            if h is not None and (best is None or h > best):
                best = h
        return best

    def check_alive(self):
        for (s, i), proc in self.procs.items():
            if proc.poll() is not None:
                raise RuntimeError(
                    f"shard {s} node {i} exited rc={proc.returncode}; "
                    f"logs in {self.workdir}"
                )

    def grep_logs(self, needle: str, shard: int = 0) -> int:
        hits = 0
        for (s, i) in self.procs:
            if s != shard:
                continue
            path = self.workdir / f"s{s}n{i}.log"
            try:
                hits += open(path, errors="replace").read().count(needle)
            except OSError:
                pass
        return hits

    def stop(self):
        for proc in self.procs.values():
            proc.send_signal(signal.SIGTERM)
        if self.boot is not None:
            self.boot.send_signal(signal.SIGTERM)
        for proc in list(self.procs.values()) + (
                [self.boot] if self.boot is not None else []):
            try:
                proc.wait(5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(5)


def _submit_cross_shard_tx(net: Net, value: int) -> bytes:
    """Build + sign a shard-0 -> shard-1 transfer with dev account 0
    and push it through shard 0's RPC; returns the destination addr."""
    from ..core import rawdb
    from ..core.genesis import dev_genesis
    from ..core.types import Transaction

    _, ecdsa_keys, _ = dev_genesis(n_keys=net.total_keys, shard_id=0)
    sender_key = ecdsa_keys[0]
    dest = b"\x2c" * 20
    port = net.alive_rpc_ports(0)[0]
    nonce = _rpc(port, "hmyv2_getTransactionCount",
                 ["0x" + sender_key.address().hex(), "latest"]) or 0
    tx = Transaction(
        nonce=int(nonce), gas_price=1, gas_limit=30_000, shard_id=0,
        to_shard=1, to=dest, value=value,
    ).sign(sender_key, 2)
    blob = rawdb.encode_tx(tx, 2)
    _rpc(port, "hmyv2_sendRawTransaction", ["0x" + blob.hex()])
    print(f"  cross-shard tx submitted: {value} to 0x{dest.hex()[:12]}.. "
          f"on shard 1")
    return dest


def main(argv=None):
    p = argparse.ArgumentParser(
        description="harmony_tpu_torch localnet")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--multikey", type=int, default=0,
                   help="first M nodes vote with 2 dev keys each")
    p.add_argument("--blocks", type=int, default=0,
                   help="stop after N blocks (0 = run until Ctrl-C)")
    p.add_argument("--kill-leader-at", type=int, default=0,
                   help="kill node 0 at this shard-0 height; require a "
                        "completed view change + continued commits")
    p.add_argument("--cross-shard", action="store_true",
                   help="submit a shard-0->1 transfer; require arrival")
    p.add_argument("--block-time", type=float, default=2.0)
    p.add_argument("--phase-timeout", type=float, default=27.0,
                   help="per-node consensus phase timeout; raise on "
                        "oversubscribed boxes (N nodes share the core)")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--keep-data", action="store_true")
    p.add_argument("--data-dir", default=None,
                   help="persistent data directory: nodes open their "
                        "shard DBs (NativeKV/FileKV) here and a "
                        "relaunch with the same dir RESUMES the chain "
                        "from disk (crash recovery + tx journals); "
                        "implies --keep-data.  Default: a throwaway "
                        "tempdir")
    p.add_argument("--device-path", action="store_true",
                   help="accepted for the JAX launcher's flags; every "
                        "node checks on the card unless --cpu is given")
    p.add_argument("--device-real", action="store_true",
                   help="on the card: also require every node's "
                        "/metrics to show no kernel-twin answer and no "
                        "host fallback (the real kernels)")
    p.add_argument("--trace", action="store_true",
                   help="arm round tracing + flight recorder on every "
                        "node (GET /debug/trace on each metrics port)")
    p.add_argument("--trace-dir", default=None,
                   help="durable span export: arm tracing (implies "
                        "--trace) and have every node write rotating "
                        "JSONL span files into this directory; analyze "
                        "them with harmony_tpu_torch.tools."
                        "round_forensics")
    add_cpu_flag(p)
    args = p.parse_args(argv)
    if args.cross_shard and args.shards < 2:
        args.shards = 2
    card_or_raise(args.cpu)

    if args.data_dir:
        # durable operator localnet: survives Ctrl-C + relaunch (each
        # node reopens its shard DB through crash recovery)
        workdir = pathlib.Path(args.data_dir).absolute()
        workdir.mkdir(parents=True, exist_ok=True)
        args.keep_data = True
    else:
        workdir = pathlib.Path(
            tempfile.mkdtemp(prefix="harmony-tpu-localnet-")
        )
    net = Net(args, workdir)
    t_first_block = None
    killed_at = None
    cx_dest = None
    cx_value = 31337
    try:
        net.start()
        print("waiting for blocks...")
        last = {s: -1 for s in range(args.shards)}
        deadline = time.monotonic() + args.timeout
        while time.monotonic() < deadline:
            time.sleep(2)
            net.check_alive()
            heads = {}
            for s in range(args.shards):
                h = net.head(s)
                heads[s] = h
                if h is not None and h != last[s]:
                    print(f"  shard {s} head = {h}")
                    last[s] = h
                    if s == 0 and h >= 1 and t_first_block is None:
                        t_first_block = time.monotonic()
            h0 = heads.get(0) or 0

            if (args.kill_leader_at and killed_at is None
                    and h0 >= args.kill_leader_at):
                net.kill(0, 0)
                killed_at = h0
                print(f"  leader-kill scenario armed at head {h0}: chain "
                      f"must advance {args.nodes} more blocks (a full "
                      f"rotation past the dead node's slot)")

            if args.cross_shard and cx_dest is None and h0 >= 2 and (
                    heads.get(1) or 0) >= 1:
                cx_dest = _submit_cross_shard_tx(net, cx_value)

            # completion: every requested criterion must hold; with no
            # criteria (pure watch mode) run until Ctrl-C
            criteria = []
            if args.blocks:
                criteria.append(h0 >= args.blocks)
            if args.kill_leader_at:
                criteria.append(
                    killed_at is not None and h0 >= killed_at + args.nodes
                )
            if args.cross_shard:
                arrived = False
                if cx_dest is not None:
                    try:
                        bal = _rpc(net.alive_rpc_ports(1)[0],
                                   "hmyv2_getBalance",
                                   ["0x" + cx_dest.hex(), "latest"])
                    except OSError:
                        bal = None  # transient RPC stall: retry next tick
                    arrived = int(bal or 0) >= cx_value
                    if arrived and not getattr(net, "_cx_done", False):
                        net._cx_done = True
                        print(f"  cross-shard transfer ARRIVED on shard 1 "
                              f"(balance {bal})")
                criteria.append(arrived)

            if criteria and all(criteria):
                if not args.cpu:
                    # the flagship path must have carried the run:
                    # every live node reports device-path checks > 0
                    checks = {}
                    for (s, i) in net.procs:
                        port = 9700 + s * args.nodes + i
                        try:
                            conn = http.client.HTTPConnection(
                                "127.0.0.1", port, timeout=5
                            )
                            conn.request("GET", "/metrics")
                            text = conn.getresponse().read().decode()
                            conn.close()
                        except OSError:
                            continue
                        total = sum(
                            int(line.rsplit(" ", 1)[1])
                            for line in text.splitlines()
                            if line.startswith(
                                "harmony_device_checks_total{"
                            )
                        )
                        checks[(s, i)] = total
                        lines = set(text.splitlines())
                        if args.device_real and not {
                            "harmony_device_kernel_twin 0",
                            'harmony_device_checks_total{kind='
                            '"ref_fallback"} 0',
                        } <= lines:
                            raise RuntimeError(
                                f"--device-real run but shard {s} node "
                                f"{i} answered by a twin or on the host"
                            )
                    if not checks or not all(
                        v > 0 for v in checks.values()
                    ):
                        raise RuntimeError(
                            f"card run but device counters "
                            f"are not live on every node: {checks}"
                        )
                    print(f"  device-path checks per node: "
                          f"{sorted(checks.values())}")
                if killed_at is not None:
                    vcs = net.grep_logs("adopt new view", shard=0)
                    if not vcs:
                        raise RuntimeError(
                            "chain advanced but no survivor logged a "
                            "completed view change"
                        )
                    print(f"  view change completed ({vcs} 'adopt new "
                          f"view' log lines among survivors)")
                rate = None
                if t_first_block is not None and h0 > 1:
                    rate = (h0 - 1) / (time.monotonic() - t_first_block)
                print(
                    f"localnet OK: shard heads "
                    f"{ {s: net.head(s) for s in range(args.shards)} }"
                    + (f", commit rate {rate:.2f} blocks/s" if rate else "")
                )
                return 0
        if not (args.blocks or args.kill_leader_at or args.cross_shard):
            return 0  # watch mode: the timeout just bounds the run
        raise RuntimeError(f"scenario incomplete after {args.timeout}s; "
                           f"logs in {workdir}")
    except KeyboardInterrupt:
        return 0
    except Exception:
        args.keep_data = True  # failure evidence must survive teardown
        raise
    finally:
        net.stop()
        if args.keep_data:
            print(f"data kept in {workdir}")
        else:
            shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
