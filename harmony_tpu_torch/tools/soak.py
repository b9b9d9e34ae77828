"""Sustained-load soak harness: resource STATIONARITY, measured.

The node's long-run leg: every chaos scenario finishes in under two
minutes, so a leak that costs 100 KiB/s — fatal within a day on a real
validator — has never been observable.  This harness runs a 4-node
localnet committing FBFT rounds under steady mixed traffic (paced
transfers into the REAL node pools so admission/commit/evict churn is
included, staking POPs on the scheduler's INGRESS lane, a replay
worker on SYNC) for a wall-clock window, samples process resources the
whole time (RSS / open fds / threads from /proc via
``metrics.process_sample``, scheduler queue depth, pool occupancy),
and fits a least-squares REGRESSION SLOPE per signal over the
post-warmup samples.

``--check`` asserts stationarity: each slope inside its bound, net
thread/fd growth bounded, the chain alive, ZERO consensus-lane sheds.
A node that serves the window but climbs monotonically fails — that is
the point.

Slopes are reported per MINUTE (``soak_rss_slope_kib_per_min``, ...):
deliberately outside the ``_per_s`` names a bench file reads as
higher-is-better, since a slope has no goodness direction to flag on
(smaller-magnitude is better, sign flips legal).

The node's checks run on the card; ``--cpu`` runs them on the CPU
through the twin kernels.  ``--bench-out`` writes, and ``--bench-base``
reads, only the file the caller names.

Usage:
    python -m harmony_tpu_torch.tools.soak                 # 120 s report
    python -m harmony_tpu_torch.tools.soak --quick --check # check.sh
    python -m harmony_tpu_torch.tools.soak --quick --check \
        --bench-out OUT.json --bench-round NN [--bench-base PRIOR.json]

The port's copy of the JAX package's ``tools/soak.py``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

from . import add_cpu_flag, device_checks

CHAIN_ID = 2
WARMUP_FRACTION = 0.3  # samples in the first 30% of the window are
# warm-up (allocator arenas, jit caches, thread spawn) — stationarity
# is judged on the steady tail


def _m(value, unit: str, **fields) -> dict:
    out = {"value": value, "unit": unit, "source": "measured"}
    out.update(fields)
    return out


def slope_per_s(samples: list) -> float | None:
    """Least-squares slope of (t_seconds, value) pairs, per second."""
    pts = [(t, v) for t, v in samples if v is not None]
    if len(pts) < 3:
        return None
    n = len(pts)
    mean_t = sum(t for t, _ in pts) / n
    mean_v = sum(v for _, v in pts) / n
    var_t = sum((t - mean_t) ** 2 for t, _ in pts)
    if var_t == 0:
        return 0.0
    cov = sum((t - mean_t) * (v - mean_v) for t, v in pts)
    return cov / var_t


class SoakRun:
    """Build the localnet, pour steady traffic, sample resources."""

    def __init__(self, args):
        self.args = args
        self.errors: list = []
        self.samples: list = []  # (t, {signal: value})
        self.submitted = 0
        self._stop = threading.Event()
        self._ready = threading.Event()

    # -- traffic -------------------------------------------------------------

    def _overload_txs(self, ecdsa_keys):
        """Funded-sender transfers — the SAME cycling flood fixture
        the overload_storm scenario pours (chaostest.fixtures), so the
        soak and the storm cannot silently diverge in load shape."""
        from ..chaostest import fixtures as FX

        return FX.overload_transfers(ecdsa_keys, to_byte=0x2f)

    def _pool_flood(self, pools, txs, rate: float, window_s: float):
        """Round-robin paced submission into the REAL node pools for
        the whole window; rejections (caps, replacement) are routine —
        steady churn is the point, not acceptance."""
        from ..chaostest import fixtures as FX
        from ..core.tx_pool import PoolError

        try:
            n = 0
            for i in FX.paced_ticks(rate, self._stop, window_s,
                                    ready=self._ready):
                tx, sender = txs[i % len(txs)]
                try:
                    pools[i % len(pools)].add(tx, sender=sender)
                except PoolError:
                    pass
                n += 1
            self.submitted = n
        except Exception as e:  # noqa: BLE001 — fail the soak loudly
            self.errors.append(f"pool flood: {e!r}")

    def _pop_flood(self, rate: float, window_s: float):
        """Steady staking-POP admissions on the INGRESS lane (a side
        pool: the POP pairing work is the load, not pool state)."""
        from .. import bls as B
        from ..core.tx_pool import PoolError, TxPool
        from ..core.types import Directive, StakingTransaction

        class _Stub:
            def nonce(self, addr):
                return 0

            def balance(self, addr):
                return 10**30

        from ..chaostest import fixtures as FX

        try:
            pool = TxPool(CHAIN_ID, 0, _Stub, cap=1 << 16)
            for n in FX.paced_ticks(rate, self._stop, window_s,
                                    ready=self._ready):
                i = n % 64
                bk = B.PrivateKey.generate(bytes([9, i, 1]))
                try:
                    pool.add(StakingTransaction(
                        nonce=n % 16, gas_price=1, gas_limit=50_000,
                        directive=Directive.CREATE_VALIDATOR,
                        fields={
                            "amount": 10**20,
                            "min_self_delegation": 10**18,
                            "bls_keys": bk.pub.bytes,
                            "bls_key_sigs": B.proof_of_possession(bk),
                        },
                    ), is_staking=True,
                        sender=bytes([0x51, i]) + b"\x00" * 18)
                except PoolError:
                    pass
        except Exception as e:  # noqa: BLE001
            self.errors.append(f"pop flood: {e!r}")

    def _replay_worker(self, nodes, mk_chain):
        try:
            while not self._stop.is_set():
                head = nodes[0].chain.head_number
                if head < 1:
                    time.sleep(0.05)
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

    # -- sampling ------------------------------------------------------------

    def _sampler(self, pools, interval_s: float):
        from ..metrics import process_sample
        from ..sched.scheduler import max_queue_depth

        self._ready.wait()
        start = time.monotonic()
        while not self._stop.is_set():
            s = process_sample()
            s["queue_depth"] = max_queue_depth()
            s["pool_txs"] = sum(len(p) for p in pools)
            self.samples.append((time.monotonic() - start, s))
            self._stop.wait(interval_s)

    # -- the run -------------------------------------------------------------

    def run(self) -> dict:
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

        genesis, ecdsa_keys, bls_keys = dev_genesis(
            n_accounts=32, n_keys=args.nodes,
        )
        committee = [k.pub.bytes for k in bls_keys]
        shared_ctx = EpochContext(committee)

        def mk_chain():
            return Blockchain(
                MemKV(), genesis,
                engine=Engine(lambda s, e: shared_ctx, device=True),
                blocks_per_epoch=16,
            )

        net = InProcessNetwork()
        nodes, pools = [], []
        for i in range(args.nodes):
            chain = mk_chain()
            pool = TxPool(CHAIN_ID, 0, chain.state)
            reg = Registry(blockchain=chain, txpool=pool,
                           host=net.host(f"soak{i}"))
            nodes.append(Node(reg, PrivateKeys.from_keys([bls_keys[i]])))
            pools.append(pool)

        txs = self._overload_txs(ecdsa_keys)
        workers = [
            threading.Thread(
                target=self._pool_flood,
                args=(pools, txs, args.rate, args.window), daemon=True,
            ),
            threading.Thread(
                target=self._pop_flood,
                args=(args.pop_rate, args.window), daemon=True,
            ),
            threading.Thread(
                target=self._replay_worker, args=(nodes, mk_chain),
                daemon=True,
            ),
            threading.Thread(
                target=self._sampler,
                args=(pools, args.sample_interval), daemon=True,
            ),
        ]
        pumps = []
        t0 = time.monotonic()
        try:
            for w in workers:
                w.start()
            pumps = [
                n.run_forever(poll_interval=0.002, block_time=0.25,
                              phase_timeout=120.0)
                for n in nodes
            ]
            # short maintenance period so evict_stale churn is part of
            # what the soak measures
            for n in nodes:
                n.maintenance_interval_s = 5.0
            self._ready.set()
            deadline = t0 + args.window + args.timeout
            while time.monotonic() < deadline:
                if self.errors:
                    raise SystemExit(
                        "soak worker errors: " + "; ".join(self.errors)
                    )
                if time.monotonic() - t0 >= args.window and all(
                    n.chain.head_number >= args.rounds for n in nodes
                ):
                    break
                time.sleep(0.1)
            else:
                raise SystemExit(
                    "soak stalled: heads="
                    f"{[n.chain.head_number for n in nodes]} after "
                    f"{args.window + args.timeout:.0f}s"
                )
        finally:
            # the measured window ENDS when the drive loop exits —
            # worker/pump join latency below must not inflate the
            # denominator of soak_submitted_tx_per_s
            # (a slow teardown would read as a phantom throughput
            # regression)
            window_s = time.monotonic() - t0
            self._stop.set()
            for w in workers:
                w.join(timeout=30)
            for n in nodes:
                n.stop()
            for p in pumps:
                p.join(timeout=10)
        if self.errors:
            raise SystemExit(
                "soak worker errors: " + "; ".join(self.errors)
            )
        return {
            "heads": [n.chain.head_number for n in nodes],
            "window_s": window_s,
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--window", type=float, default=120.0,
                    help="soak window, seconds (default 120)")
    ap.add_argument("--rate", type=float, default=800.0,
                    help="steady pool-submission pace, tx/s")
    ap.add_argument("--pop-rate", type=float, default=8.0,
                    help="staking-POP admissions/s (INGRESS lane)")
    ap.add_argument("--rounds", type=int, default=8,
                    help="minimum FBFT rounds that must commit")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--sample-interval", type=float, default=0.5)
    ap.add_argument("--timeout", type=float, default=240.0,
                    help="grace past the window before declaring a "
                         "stall")
    ap.add_argument("--quick", action="store_true",
                    help="CI-budget window (check.sh's overload stage)")
    ap.add_argument("--check", action="store_true",
                    help="assert the stationarity bounds; exit 1 on "
                         "violation")
    ap.add_argument("--rss-slope-max-kib-s", type=float, default=512.0,
                    help="max steady-state RSS slope, KiB/s")
    ap.add_argument("--thread-slope-max-s", type=float, default=0.25,
                    help="max thread-count slope, threads/s")
    ap.add_argument("--fd-slope-max-s", type=float, default=1.0,
                    help="max open-fd slope, fds/s")
    ap.add_argument("--queue-slope-max-s", type=float, default=4.0,
                    help="max scheduler queue-depth slope, items/s")
    ap.add_argument("--bench-out", default=None,
                    help="write a BENCH round file (ledger schema)")
    ap.add_argument("--bench-round", type=int, default=9)
    ap.add_argument("--bench-base", default=None,
                    help="existing bench JSON whose metrics ride "
                         "alongside in --bench-out")
    add_cpu_flag(ap)
    args = ap.parse_args(argv)
    if args.quick:
        args.window = min(args.window, 22.0)
        args.rate = min(args.rate, 300.0)
        args.rounds = min(args.rounds, 4)

    run = SoakRun(args)
    with device_checks(args.cpu):
        outcome = run.run()

    # -- stationarity fit ----------------------------------------------------
    warm_t = args.window * WARMUP_FRACTION
    tail = [(t, s) for t, s in run.samples if t >= warm_t]

    def sig(name):
        return slope_per_s([(t, s.get(name)) for t, s in tail])

    rss_slope = sig("rss_bytes")
    fd_slope = sig("open_fds")
    thread_slope = sig("threads")
    queue_slope = sig("queue_depth")
    pool_slope = sig("pool_txs")
    last = run.samples[-1][1] if run.samples else {}
    net = {}
    if tail:
        first = tail[0][1]
        for key in ("open_fds", "threads"):
            a, b = first.get(key), last.get(key)
            net[key] = (b - a) if (a is not None and b is not None) \
                else None

    from ..sched.scheduler import SHED

    sheds = sum(
        SHED.value(lane="consensus", reason=r)
        for r in ("breaker_open", "queue_full", "deadline", "expired",
                  "governor")
    )

    def _kib_min(v):
        return None if v is None else round(v * 60 / 1024, 2)

    def _per_min(v):
        return None if v is None else round(v * 60, 3)

    extra = {
        "soak_rss_slope_kib_per_min": _m(
            _kib_min(rss_slope), "KiB/min",
            bound_kib_per_min=round(args.rss_slope_max_kib_s * 60, 1),
        ),
        "soak_fd_slope_per_min": _m(
            _per_min(fd_slope), "fds/min",
            net_growth=net.get("open_fds"),
        ),
        "soak_thread_slope_per_min": _m(
            _per_min(thread_slope), "threads/min",
            net_growth=net.get("threads"),
        ),
        "soak_queue_slope_per_min": _m(
            _per_min(queue_slope), "items/min",
        ),
        "soak_pool_slope_per_min": _m(_per_min(pool_slope), "txs/min"),
        "soak_rss_final_mib": _m(
            round((last.get("rss_bytes") or 0) / (1 << 20), 1), "MiB",
        ),
        "soak_threads_final": _m(last.get("threads"), "threads"),
        "soak_fds_final": _m(last.get("open_fds"), "fds"),
        "soak_submitted_tx_per_s": _m(
            round(run.submitted / outcome["window_s"], 1), "tx/s",
        ),
        "soak_blocks_min": _m(min(outcome["heads"]), "blocks",
                              floor=args.rounds),
        "soak_samples": _m(len(run.samples), "samples",
                           window_s=round(outcome["window_s"], 1)),
    }
    checks = [
        ("samples_collected", len(tail) >= 8),
        ("rss_stationary",
         rss_slope is not None
         and rss_slope <= args.rss_slope_max_kib_s * 1024),
        ("threads_stationary",
         thread_slope is not None
         and thread_slope <= args.thread_slope_max_s
         and (net.get("threads") is None or net["threads"] <= 8)),
        ("fds_stationary",
         fd_slope is not None and fd_slope <= args.fd_slope_max_s
         and (net.get("open_fds") is None or net["open_fds"] <= 16)),
        ("queue_stationary",
         queue_slope is None or queue_slope <= args.queue_slope_max_s),
        ("liveness", min(outcome["heads"]) >= args.rounds),
        ("zero_consensus_sheds", sheds == 0),
    ]
    doc = {
        "metric": "soak_rss_slope_kib_per_min",
        "value": _kib_min(rss_slope),
        "unit": "KiB/min",
        "source": "measured",
        "extra": extra,
        "meta": {
            "window_s": round(outcome["window_s"], 1),
            "heads": outcome["heads"],
            "quick": args.quick,
            "checks": {name: ok for name, ok in checks},
        },
    }
    print(json.dumps(doc), flush=True)

    if args.bench_out:
        parsed = doc
        if args.bench_base:
            with open(args.bench_base) as f:
                base = json.load(f)
            base_parsed = base.get("parsed", base)
            merged = dict(base_parsed)
            merged.setdefault("extra", {})
            merged["extra"] = dict(merged["extra"])
            merged["extra"].update(extra)
            parsed = merged
        with open(args.bench_out, "w") as f:
            json.dump({
                "n": args.bench_round,
                "cmd": "python -m harmony_tpu_torch.tools.soak"
                       + (" --quick" if args.quick else ""),
                "parsed": parsed,
            }, f, indent=2)
            f.write("\n")
        print(f"soak: wrote {args.bench_out} "
              f"(round {args.bench_round})", file=sys.stderr)

    failed = [name for name, ok in checks if not ok]
    if failed:
        print(f"soak: FAILED checks: {failed}", file=sys.stderr)
        if args.check:
            return 1
    return 0


if __name__ == "__main__":
    rc = main()
    # hard exit, like chaos_sweep: daemon pump/scheduler threads racing
    # CPython teardown can abort AFTER the verdict is decided
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
