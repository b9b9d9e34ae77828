"""Scheduler smoke: concurrent FBFT rounds + sync replay + an ingress
burst through ONE shared verification queue, asserted over /metrics.

check.sh's scheduler stage: a 4-node in-process localnet under the
forced device path (on the card, or with ``--cpu`` the twin kernels)
commits two blocks while

  * a replay worker re-verifies the committed chain into fresh replica
    chains (engine seal batches -> the scheduler's SYNC lane), and
  * an ingress worker floods staking-tx submissions whose BLS
    proofs-of-possession verify on the INGRESS lane,

then scrapes GET /metrics over HTTP and asserts

  * the exposition parses (Prometheus text grammar),
  * harmony_sched_batch_fill_ratio  >  FILL_FLOOR  (continuous
    batching actually coalesced: well above the 1/8 a lone check gets
    on the smallest pinned bucket),
  * ZERO consensus-lane sheds (the priority lane never overflowed or
    hit an open breaker),
  * the sched families are present and flushes happened.

Exit 0 on success; any violation prints the offending value and exits 1.

Usage: python -m harmony_tpu_torch.tools.sched_smoke [--cpu]

The port's copy of the JAX package's ``tools/sched_smoke.py``.
"""

from __future__ import annotations

import argparse
import http.client
import re
import sys
import threading

from . import add_cpu_flag, device_checks
from .obs_smoke import validate_prometheus

CHAIN_ID = 2
ROUNDS = 2
FILL_FLOOR = 0.2


def _metric_value(text: str, name: str, **labels) -> float | None:
    """First sample of ``name`` whose label set CONTAINS ``labels``."""
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? (.+)$",
                     line)
        if m is None or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(3) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            return float(m.group(4))
    return None


def _metric_sum(text: str, name: str, **labels) -> float:
    total = 0.0
    for line in text.splitlines():
        if not line.startswith(name):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^}]*)\})? (.+)$",
                     line)
        if m is None or m.group(1) != name:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(3) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(4))
    return total


def run_localnet(metrics_registry):
    """The caller has put the node's checks on the device path
    (``device_checks``)."""
    from .. import bls as B
    from .. import sched
    from ..chain.engine import Engine, EpochContext
    from ..core.blockchain import Blockchain
    from ..core.genesis import dev_genesis
    from ..core.kv import MemKV
    from ..core.tx_pool import TxPool
    from ..core.types import Directive, StakingTransaction
    from ..crypto_ecdsa import ECDSAKey
    from ..multibls import PrivateKeys
    from ..node.node import Node
    from ..node.registry import Registry
    from ..p2p import InProcessNetwork

    sched.reset()
    # throughput-leaning flush window (the operator knob a replay-heavy
    # deployment turns): 10 ms of extra batching latency is noise
    # against block time, and lets concurrent bursts actually coalesce
    sched.configure(flush_window_s=0.01)

    genesis, ecdsa_keys, bls_keys = dev_genesis(n_keys=4)
    committee = [k.pub.bytes for k in bls_keys]

    # ONE shared epoch context = ONE device-resident committee table
    # across every engine (nodes + replay replicas): same-committee
    # seal checks from different chains coalesce into shared fused
    # batches — the deployment shape (committee tables are per-epoch
    # state, not per-caller state)
    shared_ctx = EpochContext(committee)

    def provider(shard_id, epoch):
        return shared_ctx

    def mk_chain():
        return Blockchain(
            MemKV(), genesis, engine=Engine(provider, device=True),
            blocks_per_epoch=16,
        )

    net = InProcessNetwork()
    nodes = []
    for i in range(4):
        chain = mk_chain()
        pool = TxPool(CHAIN_ID, 0, chain.state)
        reg = Registry(blockchain=chain, txpool=pool,
                       host=net.host(f"node{i}"))
        reg.set("metrics", metrics_registry)
        nodes.append(Node(reg, PrivateKeys.from_keys([bls_keys[i]])))

    stop = threading.Event()
    ready = threading.Event()  # gates the ingress floods until the
    # localnet is live, so the bursts overlap real round traffic
    errors: list = []

    def replay_worker():
        """Re-verify whatever the localnet has committed, repeatedly,
        into fresh replica chains — sustained SYNC-lane seal batches
        concurrent with the live rounds."""
        try:
            import time as _time

            while not stop.is_set():
                head = nodes[0].chain.head_number
                if head < 1:
                    _time.sleep(0.01)
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
        except Exception as e:  # noqa: BLE001 — fail the smoke loudly
            errors.append(f"replay worker: {e!r}")

    def ingress_worker(seed: int):
        """Staking-tx POP floods: multi-key registrations whose BLS
        proofs-of-possession verify on the ingress lane — concurrent
        bursts that must coalesce (and never outrank consensus)."""
        try:
            state = type("S", (), {"nonce": lambda s, a: 0,
                                   "balance": lambda s, a: 10**30})()
            pool = TxPool(CHAIN_ID, 0, lambda: state)
            staker = ECDSAKey.from_seed(b"smoke-%d" % seed)
            # build every tx up front: the submit loop below is a TIGHT
            # flood (the burst shape RPC admission sees), not paced by
            # key generation
            txs = []
            for i in range(6):
                bks = [B.PrivateKey.generate(bytes([seed, i, j]))
                       for j in range(3)]
                txs.append(StakingTransaction(
                    nonce=i, gas_price=1, gas_limit=50_000,
                    directive=Directive.CREATE_VALIDATOR,
                    fields={
                        "amount": 10**20, "min_self_delegation": 10**18,
                        "bls_keys": b"".join(k.pub.bytes for k in bks),
                        "bls_key_sigs": b"".join(
                            B.proof_of_possession(k) for k in bks
                        ),
                    },
                ).sign(staker, CHAIN_ID))
            ready.wait()
            for tx in txs:
                if stop.is_set():
                    return
                pool.add(tx, is_staking=True)
        except Exception as e:  # noqa: BLE001
            errors.append(f"ingress worker {seed}: {e!r}")

    workers = [threading.Thread(target=replay_worker, daemon=True)
               for _ in range(2)]
    workers += [
        threading.Thread(target=ingress_worker, args=(s,), daemon=True)
        for s in (1, 2, 3, 4, 5, 6)
    ]
    import time as _time

    pumps: list = []
    try:
        # every node pumps on ITS OWN thread (run_forever): sender-sig
        # checks, proof verifies and seal batches from four nodes plus
        # the workers genuinely overlap on the one shared queue — the
        # concurrency continuous batching exists to exploit
        for w in workers:
            w.start()
        pumps = [
            n.run_forever(poll_interval=0.002, block_time=0.2,
                          phase_timeout=120.0)
            for n in nodes
        ]
        ready.set()
        deadline = _time.monotonic() + 240
        while _time.monotonic() < deadline:
            if all(n.chain.head_number >= ROUNDS for n in nodes):
                break
            _time.sleep(0.05)
        else:
            raise SystemExit(
                "localnet stalled: heads="
                f"{[n.chain.head_number for n in nodes]}"
            )
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=60)
        for n in nodes:
            n.stop()
        for p in pumps:
            p.join(timeout=10)
    if errors:
        raise SystemExit("worker errors: " + "; ".join(errors))


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

    registry = Registry()
    with device_checks(args.cpu):
        run_localnet(registry)
    print(f"sched_smoke: {ROUNDS} rounds committed under concurrent "
          "replay + ingress load")

    srv = MetricsServer(registry, port=0).start()
    try:
        text = scrape(srv.port, "/metrics").decode()
    finally:
        srv.stop()

    bad = validate_prometheus(text)
    if bad:
        print("sched_smoke: INVALID prometheus exposition lines:")
        for line in bad[:20]:
            print(f"  {line!r}")
        return 1
    for family in ("harmony_sched_queue_depth", "harmony_sched_wait_seconds",
                   "harmony_sched_flushes_total",
                   "harmony_sched_items_total",
                   "harmony_sched_batch_fill_ratio"):
        if family not in text:
            print(f"sched_smoke: /metrics missing family {family}")
            return 1

    fill = _metric_value(text, "harmony_sched_batch_fill_ratio")
    if fill is None or fill <= FILL_FLOOR:
        print(f"sched_smoke: batch fill ratio {fill} <= floor "
              f"{FILL_FLOOR} — continuous batching did not coalesce")
        return 1
    consensus_sheds = _metric_sum(text, "harmony_sched_shed_total",
                                  lane="consensus")
    if consensus_sheds:
        print(f"sched_smoke: {consensus_sheds:g} consensus-lane sheds "
              "(priority lane must never shed in a healthy localnet)")
        return 1
    flushes = _metric_sum(text, "harmony_sched_flushes_total")
    items = _metric_sum(text, "harmony_sched_items_total")
    lanes_seen = {
        lane for lane in ("consensus", "sync", "ingress")
        if _metric_value(text, "harmony_sched_items_total", lane=lane)
    }
    if not flushes or not items or len(lanes_seen) < 3:
        print(f"sched_smoke: thin traffic — flushes={flushes:g} "
              f"items={items:g} lanes={sorted(lanes_seen)}")
        return 1
    print(f"sched_smoke: /metrics OK — fill ratio {fill:.3f} "
          f"(floor {FILL_FLOOR}), {items:g} items over {flushes:g} "
          f"flushes across lanes {sorted(lanes_seen)}, "
          "0 consensus-lane sheds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
