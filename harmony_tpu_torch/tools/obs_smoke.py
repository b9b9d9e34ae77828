"""Observability smoke: one localnet FBFT round, then validate the
debug surfaces over HTTP.

check.sh's observability stage: drives one in-process round under the
forced device path (on the card, or with ``--cpu`` the twin kernels on
the CPU: the same layer split a live ``--device-path`` localnet runs),
with every chain verifying its seals through a real verification
sidecar, then scrapes

    GET /metrics       — validated against the Prometheus text
                         exposition grammar (every line must parse)
    GET /debug/trace   — validated as Chrome trace-event JSON
                         (names/ts/dur/pid/tid present, every span's
                         parent resolves, children never start before
                         their parent)

and asserts the round produced ONE trace whose spans cover >= 4
components (consensus, device, sidecar, chain).  Exit 0 on success;
any violation prints the offending line/event and exits 1.

Usage: python -m harmony_tpu_torch.tools.obs_smoke [--cpu]

The port's copy of the JAX package's ``tools/obs_smoke.py``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import re
import sys

from . import add_cpu_flag, device_checks

CHAIN_ID = 2

# -- Prometheus text exposition grammar (one line at a time) -----------------

_METRIC = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_HELP_RE = re.compile(rf"^# HELP {_METRIC} .*$")
_TYPE_RE = re.compile(
    rf"^# TYPE {_METRIC} (counter|gauge|histogram|summary|untyped)$"
)
_LABELS = r'\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\}'
_NUMBER = r"[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|[0-9]+)"
_SAMPLE_RE = re.compile(rf"^{_METRIC}({_LABELS})? {_NUMBER}$")
# OpenMetrics exemplar suffix (``?exemplars=1`` scrape): only _bucket
# samples may carry ``# {trace_id="…"} value``
_SAMPLE_EX_RE = re.compile(
    rf"^{_METRIC}_bucket({_LABELS})? {_NUMBER}"
    rf'( # \{{trace_id="[0-9a-f]+"\}} {_NUMBER})?$'
)


def validate_prometheus(text: str, exemplars: bool = False) -> list:
    """Offending lines (empty = valid exposition).  ``exemplars``
    additionally admits the OpenMetrics trace-id suffix on _bucket
    sample lines — the grammar of a ``/metrics?exemplars=1`` scrape."""
    bad = []
    for line in text.splitlines():
        if not line:
            continue
        if line.startswith("# HELP"):
            ok = _HELP_RE.match(line)
        elif line.startswith("# TYPE"):
            ok = _TYPE_RE.match(line)
        elif line.startswith("#"):
            ok = True  # free-form comment
        else:
            ok = _SAMPLE_RE.match(line) or (
                exemplars and _SAMPLE_EX_RE.match(line)
            )
        if not ok:
            bad.append(line)
    return bad


def validate_trace_events(doc: dict) -> list:
    """Offending findings for a Chrome trace-event export."""
    bad = []
    if "traceEvents" not in doc:
        return ["missing traceEvents key"]
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    by_id = {}
    for e in events:
        for field in ("name", "cat", "ts", "dur", "pid", "tid"):
            if field not in e:
                bad.append(f"event missing {field}: {e}")
        span_id = e.get("args", {}).get("span_id")
        if not span_id:
            bad.append(f"event missing args.span_id: {e.get('name')}")
        by_id[span_id] = e
    for e in events:
        parent = e.get("args", {}).get("parent_id")
        if parent is None:
            continue
        if parent not in by_id:
            bad.append(f"orphan span {e['name']}: parent {parent} "
                       "not in export")
        elif by_id[parent]["ts"] > e["ts"] + 1e-3:
            bad.append(f"span {e['name']} starts before its parent")
    return bad


# -- the one-round localnet --------------------------------------------------


def run_round(metrics_registry):
    """One committed block across 4 in-process nodes; returns the
    round's trace id.  The caller has put the node's checks on the
    device path (``device_checks``)."""
    from .. import trace
    from ..chain.engine import Engine, EpochContext
    from ..core.blockchain import Blockchain
    from ..core.genesis import dev_genesis
    from ..core.kv import MemKV
    from ..core.tx_pool import TxPool
    from ..multibls import PrivateKeys
    from ..node.node import Node
    from ..node.registry import Registry
    from ..p2p import InProcessNetwork
    from ..sidecar.client import SidecarClient
    from ..sidecar.server import SidecarServer

    trace.configure(enabled=True)

    sidecar = SidecarServer().start()
    genesis, _, bls_keys = dev_genesis(n_keys=4)
    committee = [k.pub.bytes for k in bls_keys]
    net = InProcessNetwork()
    nodes, clients = [], []
    for i in range(4):
        client = SidecarClient(sidecar.address)
        clients.append(client)
        engine = Engine(lambda s, e, c=committee: EpochContext(c),
                        device=False, backend=client)
        chain = Blockchain(MemKV(), genesis, engine=engine,
                           blocks_per_epoch=16)
        pool = TxPool(CHAIN_ID, 0, chain.state)
        reg = Registry(blockchain=chain, txpool=pool,
                       host=net.host(f"node{i}"))
        reg.set("metrics", metrics_registry)  # round histogram target
        nodes.append(Node(reg, PrivateKeys.from_keys([bls_keys[i]])))
    try:
        leader = next(n for n in nodes if n.is_leader)
        leader.start_round_if_leader()
        for _ in range(50):
            if not any(n.process_pending() for n in nodes):
                break
        heads = [n.chain.head_number for n in nodes]
        if heads != [1, 1, 1, 1]:
            raise SystemExit(f"round did not commit on every node: "
                             f"heads={heads}")
        rounds = [s for s in trace.spans() if s.name == "consensus.round"]
        if len(rounds) != 1:
            raise SystemExit(
                f"expected ONE round root span, got {len(rounds)}"
            )
        trace_id = rounds[0].trace_id
        comps = {s.component for s in trace.spans(trace_id)}
        need = {"consensus", "device", "sidecar", "chain"}
        if not need <= comps:
            raise SystemExit(
                f"round trace covers {sorted(comps)}, needs {sorted(need)}"
            )
        return trace_id
    finally:
        for c in clients:
            c.close()
        for n in nodes:
            n.stop()
        sidecar.stop()


def scrape(port: int, path: str) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    if resp.status != 200:
        raise SystemExit(f"GET {path} -> {resp.status}")
    return body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    from ..metrics import MetricsServer, Registry

    metrics_registry = Registry()
    with device_checks(args.cpu):
        trace_id = run_round(metrics_registry)
    print(f"obs_smoke: round committed, trace {trace_id}")

    srv = MetricsServer(metrics_registry, port=0).start()
    try:
        metrics_text = scrape(srv.port, "/metrics").decode()
        exemplar_text = scrape(srv.port, "/metrics?exemplars=1").decode()
        trace_doc = json.loads(
            scrape(srv.port, f"/debug/trace?trace_id={trace_id}")
        )
    finally:
        srv.stop()

    bad = validate_prometheus(metrics_text)
    if bad:
        print("obs_smoke: INVALID prometheus exposition lines:")
        for line in bad[:20]:
            print(f"  {line!r}")
        return 1
    for family in ("harmony_device_checks_total",
                   "harmony_device_dispatch_seconds",
                   "harmony_consensus_round_seconds",
                   "harmony_device_transfer_bytes_total",
                   "harmony_replay_stage_seconds",
                   "harmony_round_phase_seconds"):
        if family not in metrics_text:
            print(f"obs_smoke: /metrics missing family {family}")
            return 1
    print(f"obs_smoke: /metrics OK "
          f"({len(metrics_text.splitlines())} lines, grammar-valid)")

    bad = validate_prometheus(exemplar_text, exemplars=True)
    if bad:
        print("obs_smoke: INVALID exemplar exposition lines:")
        for line in bad[:20]:
            print(f"  {line!r}")
        return 1
    if ' # {trace_id="' not in exemplar_text:
        print("obs_smoke: ?exemplars=1 carried no trace-id exemplar "
              "despite a traced round")
        return 1
    print("obs_smoke: /metrics?exemplars=1 OK (grammar-valid, "
          "trace-linked)")

    bad = validate_trace_events(trace_doc)
    if bad:
        print("obs_smoke: INVALID trace export:")
        for b in bad[:20]:
            print(f"  {b}")
        return 1
    n = len([e for e in trace_doc["traceEvents"] if e.get("ph") == "X"])
    if n < 8:
        print(f"obs_smoke: suspiciously few spans in the round: {n}")
        return 1
    print(f"obs_smoke: /debug/trace OK ({n} spans, schema-valid, "
          "properly parented)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
