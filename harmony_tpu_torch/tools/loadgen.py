"""Sustained-traffic load generator: latency under load, measured.

The node's latency-under-load harness (arXiv:2302.00418 is the
yardstick: committee consensus is gated by verification latency UNDER
LOAD, not by peak kernel throughput; Handel, arXiv:1906.05132, sets the
committee-scale load shape).  A 4-node threaded localnet commits FBFT rounds while

  * plain-transfer floods hit tx-pool admission at a paced, configurable
    tx/s rate (the RPC-submit shape; senders pre-recovered exactly as
    the gossip pre-filter hands them over — the pure-Python secp256k1
    stand-in must not be what the node's load harness measures),
  * staking submissions carrying BLS proofs-of-possession verify on the
    scheduler's INGRESS lane,
  * replay workers re-verify the committed chain down the SYNC lane,

and the REPORTED numbers come straight from the observability
surfaces: round p50/p99 from the tracer's ``consensus.round`` spans
(cross-checked against the ``harmony_consensus_round_seconds``
histogram via ``Histogram.quantile``) and ingress latency from the
``harmony_sched_wait_seconds{lane="ingress"}`` histogram.  No
hand-parsed bucket counts, no synthetic timers around the thing being
measured.

``--check`` (check.sh's perf stage) asserts the floors: the Prometheus
exposition parses, every scheduler lane carried traffic, ZERO
consensus-lane sheds, the submitted rate holds its floor, and the
latency grammar is sane (0 < p50 <= p99).  Every metric in the output
line is tagged ``source: measured``.

The node's checks run on the card; ``--cpu`` runs them on the CPU
through the twin kernels.

Usage:
    python -m harmony_tpu_torch.tools.loadgen                 # report
    python -m harmony_tpu_torch.tools.loadgen --duration 5 --check

The port's copy of the JAX package's ``tools/loadgen.py``.
"""

from __future__ import annotations

import argparse
import http.client
import json
import sys
import threading
import time

from . import add_cpu_flag, device_checks
from .obs_smoke import validate_prometheus

CHAIN_ID = 2


def _m(value, unit: str, **fields) -> dict:
    out = {"value": value, "unit": unit, "source": "measured"}
    out.update(fields)
    return out


def _quantiles(values: list) -> tuple:
    """Exact (p50, p99) of raw samples."""
    if not values:
        return None, None
    s = sorted(values)
    return (s[len(s) // 2],
            s[min(len(s) - 1, int(len(s) * 0.99))])


class _StubState:
    """Balance/nonce view for the side pools — admission sees funded,
    fresh senders without a chain behind them."""

    def nonce(self, addr) -> int:
        return 0

    def balance(self, addr) -> int:
        return 10**30


class LoadRun:
    def __init__(self, args, registry):
        self.args = args
        self.registry = registry
        self.errors: list = []
        # one (category, count, elapsed_s) record PER flood thread,
        # appended under the lock: the submitted rate is computed over
        # the window each flood actually RAN, never over the post-flood
        # wait for rounds to commit, and never through a racy shared
        # read-modify-write counter
        self.floods_done: list = []
        self._floods_lock = threading.Lock()
        self.round_durs: dict = {}  # span_id -> dur_s (tracer-derived)
        self._stop = threading.Event()
        self._ready = threading.Event()

    # -- fixture builders (untimed) ------------------------------------------

    def _plain_txs(self, count: int, tag: int):
        """Unsigned transfers + synthetic pre-recovered senders: the
        shape admission sees after signature recovery, which is what
        this harness paces (the recover itself is the stand-in's cost,
        not the system's)."""
        from ..core.types import Transaction

        out = []
        per_sender = 16  # ACCOUNT_SLOTS: stay in the executable tier
        n_senders = (count + per_sender - 1) // per_sender
        for s in range(n_senders):
            sender = bytes([0x4c, tag, s // 256, s % 256]) + b"\x00" * 16
            for n in range(min(per_sender, count - s * per_sender)):
                out.append((Transaction(
                    nonce=n, gas_price=1, gas_limit=21_000, shard_id=0,
                    to_shard=0, to=b"\x2d" * 20, value=1,
                ), sender))
        return out

    def _pop_txs(self, count: int, tag: int):
        """CREATE_VALIDATOR submissions whose BLS proofs-of-possession
        verify on the INGRESS lane (2 keys each — one fused 2-wide
        check per admission).  Same shape as the plain flood: one
        sender per 16 txs with contiguous nonces, so every submission
        lands in the executable tier."""
        from .. import bls as B
        from ..core.types import Directive, StakingTransaction

        out = []
        for i in range(count):
            group = i // 16
            sender = bytes([0x50, tag, group // 256, group % 256]
                           ) + b"\x00" * 16
            bks = [B.PrivateKey.generate(bytes([tag, i % 251, j]))
                   for j in range(2)]
            out.append((StakingTransaction(
                nonce=i % 16, gas_price=1, gas_limit=50_000,
                directive=Directive.CREATE_VALIDATOR,
                fields={
                    "amount": 10**20, "min_self_delegation": 10**18,
                    "bls_keys": b"".join(k.pub.bytes for k in bks),
                    "bls_key_sigs": b"".join(
                        B.proof_of_possession(k) for k in bks
                    ),
                },
            ), sender))
        return out

    # -- workers -------------------------------------------------------------

    def _paced_flood(self, txs, rate: float, is_staking: bool,
                     category: str):
        """Token-bucket paced pool.add flood; records (count, window)."""
        from ..core.tx_pool import PoolError, TxPool

        try:
            pool = TxPool(CHAIN_ID, 0, _StubState, cap=len(txs) + 64)
            self._ready.wait()
            start = time.monotonic()
            n = 0
            for i, (tx, sender) in enumerate(txs):
                if self._stop.is_set():
                    break
                target = start + i / rate
                now = time.monotonic()
                if now < target:
                    time.sleep(min(target - now, 0.05))
                try:
                    pool.add(tx, is_staking=is_staking, sender=sender)
                except PoolError:
                    pass  # replacement/caps: still a submission
                n += 1
            elapsed = time.monotonic() - start
            with self._floods_lock:
                self.floods_done.append((category, n, elapsed))
        except Exception as e:  # noqa: BLE001 — fail the harness loudly
            self.errors.append(f"{category} flood: {e!r}")

    def _replay_worker(self, nodes, mk_chain):
        """Re-verify the committed chain into fresh replicas — the
        SYNC-lane seal batches concurrent with live rounds."""
        try:
            while not self._stop.is_set():
                head = nodes[0].chain.head_number
                if head < 1:
                    time.sleep(0.01)
                    continue
                replica = mk_chain()
                blocks, proofs = [], []
                for n in range(1, head + 1):
                    blk = nodes[0].chain.block_by_number(n)
                    proof = nodes[0].chain.read_commit_sig(n)
                    if blk is None or proof is None:
                        break
                    blocks.append(blk)
                    proofs.append(proof)
                if blocks:
                    replica.insert_chain(blocks, commit_sigs=proofs,
                                         verify_seals=True)
        except Exception as e:  # noqa: BLE001
            self.errors.append(f"replay worker: {e!r}")

    def _sweep_round_spans(self):
        from .. import trace

        for s in trace.spans():
            if s.name == "consensus.round" and s.dur_s is not None:
                self.round_durs[s.span_id] = s.dur_s

    def _round_collector(self):
        """Poll the tracer for finished consensus.round spans — the
        bounded span store must not age them out before we read them."""
        while not self._stop.is_set():
            self._sweep_round_spans()
            time.sleep(0.25)

    # -- the run -------------------------------------------------------------

    def run(self) -> None:
        from .. import sched, trace
        from ..chain.engine import Engine, EpochContext
        from ..core.blockchain import Blockchain
        from ..core.genesis import dev_genesis
        from ..core.kv import MemKV
        from ..core.tx_pool import TxPool
        from ..multibls import PrivateKeys
        from ..node.node import Node
        from ..node.registry import Registry
        from ..p2p import InProcessNetwork

        args = self.args
        trace.configure(enabled=True)
        sched.reset()
        sched.configure(flush_window_s=0.01)

        genesis, _, bls_keys = dev_genesis(n_keys=args.nodes)
        committee = [k.pub.bytes for k in bls_keys]
        shared_ctx = EpochContext(committee)

        def mk_chain():
            return Blockchain(
                MemKV(), genesis,
                engine=Engine(lambda s, e: shared_ctx, device=True),
                blocks_per_epoch=16,
            )

        net = InProcessNetwork()
        nodes = []
        for i in range(args.nodes):
            chain = mk_chain()
            pool = TxPool(CHAIN_ID, 0, chain.state)
            reg = Registry(blockchain=chain, txpool=pool,
                           host=net.host(f"node{i}"))
            reg.set("metrics", self.registry)
            nodes.append(Node(reg, PrivateKeys.from_keys([bls_keys[i]])))

        # fixtures before the clock starts
        plain_target = int(args.rate * args.duration * 1.25)
        pop_target = max(8, int(args.pop_rate * args.duration))
        half = (plain_target + 1) // 2
        floods = [
            (self._plain_txs(half, 1), args.rate / 2, False, "plain"),
            (self._plain_txs(plain_target - half, 2), args.rate / 2,
             False, "plain"),
            (self._pop_txs(pop_target, 3), args.pop_rate, True, "pop"),
        ]
        workers = [
            threading.Thread(target=self._paced_flood, args=f,
                             daemon=True)
            for f in floods
        ]
        workers += [
            threading.Thread(target=self._replay_worker,
                             args=(nodes, mk_chain), daemon=True)
            for _ in range(2)
        ]
        collector = threading.Thread(target=self._round_collector,
                                     daemon=True)

        pumps = []
        try:
            for w in workers:
                w.start()
            collector.start()
            pumps = [
                n.run_forever(poll_interval=0.002, block_time=0.2,
                              phase_timeout=120.0)
                for n in nodes
            ]
            self._ready.set()
            deadline = time.monotonic() + args.timeout
            while time.monotonic() < deadline:
                if self.errors:
                    # a dead worker never reaches floods_done — fail
                    # NOW with its exception, not a 240s stall message
                    raise SystemExit(
                        "worker errors: " + "; ".join(self.errors)
                    )
                rounds_ok = all(
                    n.chain.head_number >= args.rounds for n in nodes
                )
                with self._floods_lock:
                    floods_ok = len(self.floods_done) == len(floods)
                if rounds_ok and floods_ok:
                    break
                time.sleep(0.05)
            else:
                raise SystemExit(
                    "loadgen localnet stalled: heads="
                    f"{[n.chain.head_number for n in nodes]}, "
                    f"floods done {len(self.floods_done)}/{len(floods)}"
                )
        finally:
            self._stop.set()
            for w in workers:
                w.join(timeout=60)
            collector.join(timeout=10)
            for n in nodes:
                n.stop()
            for p in pumps:
                p.join(timeout=10)
            # the round that satisfied --rounds often finishes after
            # the collector's last poll — sweep once more before the
            # store is read (a missed tail round skews p99 low, and a
            # --rounds 1 run could report no spans at all)
            self._sweep_round_spans()
        if self.errors:
            raise SystemExit("worker errors: " + "; ".join(self.errors))


def scrape(port: int, path: str) -> bytes:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    if resp.status != 200:
        raise SystemExit(f"GET {path} -> {resp.status}")
    return body


def _metric_sum(text: str, name: str, **labels) -> float:
    import re

    total = 0.0
    for line in text.splitlines():
        m = re.match(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? (.+)$", line
        )
        if m is None or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(3) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(4))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rate", type=float, default=1500.0,
                    help="plain-submission pace, tx/s (default 1500)")
    ap.add_argument("--rate-floor", type=float, default=1000.0,
                    help="--check fails below this submitted tx/s")
    ap.add_argument("--pop-rate", type=float, default=20.0,
                    help="staking-POP submissions/s on the INGRESS lane")
    ap.add_argument("--duration", type=float, default=6.0,
                    help="flood window, seconds")
    ap.add_argument("--rounds", type=int, default=2,
                    help="minimum FBFT rounds that must commit")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--check", action="store_true",
                    help="assert the floors; exit 1 on violation")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)

    from ..metrics import MetricsServer, Registry
    from ..sched.scheduler import WAIT_SECONDS, Lane

    registry = Registry()
    run = LoadRun(args, registry)
    with device_checks(args.cpu):
        run.run()

    srv = MetricsServer(registry, port=0).start()
    try:
        text = scrape(srv.port, "/metrics").decode()
    finally:
        srv.stop()

    # -- collect the report numbers ------------------------------------------
    # rate per category over the window that category's floods RAN
    # (concurrent same-pace threads: the slowest sibling's window),
    # summed — the post-flood wait for rounds never dilutes it
    def _cat_rate(cat):
        recs = [(n, e) for c, n, e in run.floods_done if c == cat]
        if not recs:
            return 0, 0.0, 0.0
        window = max(e for _, e in recs)
        total = sum(n for n, _ in recs)
        return total, (total / window if window else 0.0), window

    n_plain, plain_rate, plain_window = _cat_rate("plain")
    n_pop, pop_rate, pop_window = _cat_rate("pop")
    submitted = n_plain + n_pop
    rate = plain_rate + pop_rate
    span_p50, span_p99 = _quantiles(list(run.round_durs.values()))
    round_hist = registry.histogram("harmony_consensus_round_seconds")
    ingress_hist = WAIT_SECONDS[Lane.INGRESS]
    sheds = _metric_sum(text, "harmony_sched_shed_total",
                        lane="consensus")
    lanes = {
        lane for lane in ("consensus", "sync", "ingress")
        if _metric_sum(text, "harmony_sched_items_total", lane=lane)
    }

    extra = {
        # rate = Σ per-category count/window — the windows are stamped
        # per category so the record is self-consistent (the slow POP
        # flood's window must not be divided into the plain count)
        "submitted_tx_per_s": _m(round(rate, 1), "tx/s",
                                 floor=args.rate_floor,
                                 plain_rate=round(plain_rate, 1),
                                 plain_window_s=round(plain_window, 2),
                                 pop_rate=round(pop_rate, 1),
                                 pop_window_s=round(pop_window, 2)),
        "submitted_total": _m(submitted, "txs",
                              plain=n_plain, pop=n_pop),
        "round_p50_s": _m(span_p50 and round(span_p50, 4), "s",
                          derived_from="tracer_spans",
                          rounds=len(run.round_durs)),
        "round_p99_s": _m(span_p99 and round(span_p99, 4), "s",
                          derived_from="tracer_spans",
                          rounds=len(run.round_durs)),
        "round_hist_p50_s": _m(
            _r(round_hist.quantile(0.5)), "s",
            derived_from="metrics_histogram"),
        "round_hist_p99_s": _m(
            _r(round_hist.quantile(0.99)), "s",
            derived_from="metrics_histogram"),
        "ingress_wait_p50_s": _m(
            _r(ingress_hist.quantile(0.5)), "s",
            derived_from="metrics_histogram"),
        "ingress_wait_p99_s": _m(
            _r(ingress_hist.quantile(0.99)), "s",
            derived_from="metrics_histogram"),
        "consensus_lane_sheds": _m(sheds, "sheds"),
    }
    checks = [
        ("prometheus_grammar", not validate_prometheus(text)),
        ("all_lanes_active",
         lanes == {"consensus", "sync", "ingress"}),
        ("zero_consensus_sheds", sheds == 0),
        ("rate_floor", rate >= args.rate_floor),
        ("round_latency_grammar",
         span_p50 is not None and span_p99 is not None
         and 0 < span_p50 <= span_p99),
        ("ingress_latency_grammar",
         ingress_hist.quantile(0.5) is not None
         and ingress_hist.quantile(0.5)
         <= (ingress_hist.quantile(0.99) or 0)),
    ]
    out = {
        "metric": "loadgen_submitted_tx_per_s",
        "value": round(rate, 1),
        "unit": "tx/s",
        "source": "measured",
        "extra": extra,
        "meta": {
            "nodes": args.nodes,
            "lanes_active": sorted(lanes),
            "checks": {name: ok for name, ok in checks},
        },
    }
    print(json.dumps(out), flush=True)
    failed = [name for name, ok in checks if not ok]
    if failed:
        print(f"loadgen: FAILED checks: {failed}", file=sys.stderr)
        if args.check:
            return 1
    return 0


def _r(v, digits: int = 5):
    return None if v is None else round(v, digits)


if __name__ == "__main__":
    sys.exit(main())
