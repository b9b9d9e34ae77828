"""The node binary: config, wiring, service lifecycle.

The role of the reference's cmd/harmony (reference:
cmd/harmony/main.go:106-1107 — config load, chain setup, consensus +
node wiring, service registration, RPC startup; TOML config tree
internal/configs/harmony/harmony.go:18-44).  Stdlib-only: argparse +
tomllib; every subsystem built here exists as a library object, so
this file is wiring, not logic.

Run: python -m harmony_tpu_torch.cli --config node.toml  (or flags only).

The port's copy of the JAX package's ``cli.py``.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

try:
    import tomllib
except ImportError:  # Python < 3.11: tomli is the same parser
    import tomli as tomllib

from .chain.engine import Engine, EpochContext
from .config.chain import ChainConfig
from .core.blockchain import Blockchain
from .core.genesis import Genesis, dev_genesis
from .log import get_logger, init_logging
from .core.kv import FileKV, MemKV
from .core.tx_pool import TxPool
from .hmy import Harmony
from .keystore import load_keys
from .metrics import MetricsServer, Registry as MetricsRegistry
from .multibls import PrivateKeys
from .node.node import Node
from .node.registry import Registry
from .node.services import Manager, Service, ServiceType
from .p2p import TCPHost
from .p2p.stream import SyncClient, SyncServer
from .rpc import RPCServer
from .sync import Downloader

DEFAULTS = {
    "network": "localnet",
    "shard_id": 0,
    "shard_count": 1,  # >1 arms live cross-shard receipt routing
    "datadir": "./harmony_tpu_data",
    "blocks_per_epoch": 32768,
    "rpc_port": 9500,
    "metrics_port": 9900,
    "p2p_port": 9000,
    "sync_port": 9001,
    "peers": [],          # "host:port" gossip peers (static)
    "bootnodes": [],      # "host:port" bootnodes for PEX discovery
    # a BEACON-shard node's sync stream; non-beacon shards follow
    # beacon committee rotation through it (sync/epoch_feed.py)
    "beacon_sync_peer": None,
    "sync_peers": [],     # "host:port" sync stream servers
    "bls_keys": [],       # [{"path": ..., "passphrase_file": ...}]
    # dev-genesis knobs (python -m harmony_tpu_torch.tools.localnet):
    # committee size + which single dev key THIS process holds (None =
    # all of them)
    "dev_keys": None,
    "dev_key_index": None,
    "in_memory": False,
    # storage durability: fsync policy of the shard DB ("none" = OS-
    # buffered, "batch" = fsync every atomic block-commit batch —
    # a committed block survives power loss, "always" = every write)
    "fsync": "batch",
    "log_level": "info",
    "log_path": None,
    # None = auto (the card's kernels when CUDA is available);
    # True/False force the verification path (True without CUDA fails
    # at boot: a check bound for the card is never answered on the host)
    "device_verify": None,
    # seal verification in the live node (reference nodes always
    # verify; False only for throwaway dev chains)
    "verify_seals": True,
    # quorum-check backend: "in-process" (default) runs the card/host
    # paths in this process; "sidecar" ships checks to the
    # verification sidecar at sidecar_addr (SURVEY §7.3; served by
    # sidecar/server.py / native/sidecar_client.cpp)
    "verify_backend": "in-process",
    "sidecar_addr": "127.0.0.1:9600",
    # optional HTTP services (None = disabled; 0 = ephemeral port)
    "explorer_port": None,
    "rosetta_port": None,
    "ws_port": None,  # WebSocket JSON-RPC + eth_subscribe push
    # round tracing + flight recorder (trace.py): OFF by
    # default (disabled cost is one comparison per instrumented site);
    # when on, /debug/trace serves the round timelines and anomalies
    # (breaker open, view change, sidecar desync, round > trace_slo)
    # dump correlated snapshots to trace_dir
    "trace": False,
    "trace_sample": 1.0,   # root-span sampling rate [0, 1]
    "trace_slo": None,     # round-latency SLO seconds (None = off)
    "trace_dir": None,     # dump dir ($HARMONY_TPU_TRACE_DIR/<tmp>)
    "span_sink_dir": None,  # durable JSONL span export (implies trace;
    # merge the per-node files with
    # python -m harmony_tpu_torch.tools.round_forensics)
    # startup AOT warmup: run every compile-manifest program once on
    # the card (aot.py's pinned shape set) before the node serves, so
    # no serving path ever pays a kernel's first launch.  False only for
    # throwaway dev runs that accept first-use stalls
    "aot_warmup": True,
}


def load_config(path: str | None, overrides: dict) -> dict:
    cfg = dict(DEFAULTS)
    if path:
        with open(path, "rb") as f:
            cfg.update(tomllib.load(f))
    cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg


class _CallbackService(Service):
    def __init__(self, start_fn, stop_fn):
        self._start, self._stop = start_fn, stop_fn

    def start(self):
        self._start()

    def stop(self):
        self._stop()


def _open_genesis(cfg: dict):
    """(genesis, dev_bls_or_None) from config."""
    if cfg.get("genesis") is not None:
        return cfg["genesis"], None  # tests inject a Genesis object
    genesis, _, dev_bls = dev_genesis(
        n_keys=int(cfg.get("dev_keys") or 4),
        shard_id=cfg["shard_id"],
    )
    if cfg.get("dev_key_index") is not None:
        # multi-process localnet: this node votes with a SPAN of
        # consecutive dev keys (span > 1 = a multi-BLS validator,
        # reference: multibls/multibls.go)
        i = int(cfg["dev_key_index"])
        span = int(cfg.get("dev_key_span") or 1)
        if i < 0 or span < 1 or i + span > len(dev_bls):
            raise SystemExit(
                f"dev key span [{i}, {i + span}) out of range for "
                f"{len(dev_bls)} dev keys"
            )
        dev_bls = dev_bls[i:i + span]
    return genesis, dev_bls


def _open_db(cfg: dict):
    if cfg["in_memory"]:
        return MemKV()
    db_path = os.path.join(cfg["datadir"], f"shard{cfg['shard_id']}.db")
    fsync = cfg.get("fsync", "batch")
    if cfg.get("native_kv", True):
        # ANY native failure (missing toolchain, corrupt file ->
        # kv_open nullptr, ...) falls back to the Python twin —
        # same on-disk format, so the fallback opens the same DB
        try:
            from .core.kv_native import NativeKV

            return NativeKV(db_path, fsync=fsync)
        except Exception as e:  # documented above: ANY native failure
            get_logger("cli").warn(
                "native kv unavailable, using FileKV twin",
                path=db_path, error=str(e),
            )
    return FileKV(db_path, fsync=fsync)


def open_chain_for_maintenance(cfg: dict) -> Blockchain:
    """The DB + chain WITHOUT hosts/peers/services — offline tooling
    (--revert-to et al.) must not dial anything or bind ports."""
    os.makedirs(cfg["datadir"], exist_ok=True)
    genesis, _ = _open_genesis(cfg)
    return Blockchain(
        _open_db(cfg), genesis,
        blocks_per_epoch=cfg["blocks_per_epoch"],
    )


def load_node_bls_keys(cfg: dict, dev_bls=None):
    """Resolve the node's BLS signing keys from config (reference:
    internal/blsgen — passphrase file/env/console prompt sources,
    KMS envelopes, --bls.dir multikey directories) or the dev
    genesis keys."""
    # BLS keys: encrypted keyfiles (passphrase from file/env/console),
    # KMS envelopes, a multibls key directory — or dev keys on the dev
    # genesis (reference: internal/blsgen config.go passphrase sources
    # + kms.go + the --bls.dir multikey mode)
    entries = list(cfg["bls_keys"] or [])
    if cfg.get("bls_dir"):
        import glob as _glob

        for path in sorted(
            _glob.glob(os.path.join(cfg["bls_dir"], "*.key"))
        ):
            entries.append({
                "path": path,
                "passphrase_file": cfg.get("bls_dir_passphrase_file"),
                "passphrase_env": cfg.get("bls_dir_passphrase_env"),
            })
    if entries:
        loaded = []
        kms_provider = None
        for entry in entries:
            if entry.get("kms"):
                if kms_provider is None:
                    from .blsgen_kms import LocalKMSProvider

                    master = cfg.get("kms_master_key")
                    if not master:
                        raise ValueError(
                            "kms_master_key required for kms bls keys"
                        )
                    kms_provider = LocalKMSProvider(master)
                from . import bls as _bls
                from .blsgen_kms import load_kms_key

                loaded.append(_bls.PrivateKey.from_bytes(
                    load_kms_key(entry["path"], kms_provider)
                ))
                continue
            if entry.get("passphrase_file"):
                with open(entry["passphrase_file"]) as f:
                    passphrase = f.read().strip()
            elif entry.get("passphrase_env"):
                passphrase = os.environ.get(entry["passphrase_env"])
                if passphrase is None:
                    raise ValueError(
                        f"passphrase env {entry['passphrase_env']!r} "
                        f"unset for {entry['path']}"
                    )
            else:
                # operator console (reference: blsgen prompts when no
                # pass source is configured; non-interactive runs must
                # configure one instead)
                if not sys.stdin.isatty():
                    raise ValueError(
                        f"no passphrase source for {entry['path']} and "
                        "stdin is not a terminal"
                    )
                import getpass

                passphrase = getpass.getpass(
                    f"Enter the BLS key passphrase for {entry['path']}: "
                )
            loaded.extend(load_keys([(entry["path"], passphrase)]))
        keys = PrivateKeys.from_keys(loaded)
    elif dev_bls is not None:
        keys = PrivateKeys.from_keys(dev_bls)
    else:
        raise ValueError(
            "bls_keys required when a custom genesis is supplied"
        )
    return keys


def build_node(cfg: dict):
    """Wire every subsystem; returns (node, services, registry)."""
    os.makedirs(cfg["datadir"], exist_ok=True)

    span_sink = None
    if cfg.get("trace") or cfg.get("span_sink_dir"):
        from . import trace as TR

        # explicit None checks: --trace-sample 0 is a valid rate
        # ("arm the recorder, sample no local roots") and must not be
        # swallowed by a falsy-or into the 1.0 default
        sample = cfg.get("trace_sample")
        TR.configure(
            enabled=True,
            sample_rate=None if sample is None else float(sample),
            round_slo_s=cfg.get("trace_slo"),
            dump_dir=cfg.get("trace_dir"),
        )
        # one real node per process: every span this process creates is
        # attributable when sink files from several nodes merge (the
        # TCPHost naming convention, unique across a localnet)
        node_label = f"shard{cfg['shard_id']}-{os.getpid()}"
        TR.set_node(node_label)
        if cfg.get("span_sink_dir"):
            from .obs import SpanSink

            span_sink = SpanSink(
                cfg["span_sink_dir"], node=node_label
            ).arm()

    genesis, dev_bls = _open_genesis(cfg)
    db = _open_db(cfg)

    # the consensus engine — seal checks + the card's verification path
    # (the node refuses unsigned chains unless verify_seals=False).
    # Late-bound committee provider: reads the chain wired just below.
    chain_cell: list = []
    epoch_chain_cell: list = []

    def _committee_provider(shard_id: int, epoch: int) -> EpochContext:
        chain_ = chain_cell[0]
        keys = None
        if shard_id == chain_.shard_id:
            keys = chain_.committee_for_epoch(epoch)
        else:
            state = chain_.shard_state_for_epoch(epoch)
            com = state.find_committee(shard_id) if state else None
            if com is not None and com.slots:
                keys = com.bls_pubkeys()
            elif epoch_chain_cell:
                # foreign shard: resolve through the beacon epoch light
                # chain (core/epochchain.py — the reference's
                # EpochChain); [] when it hasn't seen the epoch
                keys = epoch_chain_cell[0].committee_for(shard_id, epoch)
            else:
                # no resolvable committee for a FOREIGN shard: fail
                # closed with an empty context (rejects every proof) —
                # falling back to the local genesis committee would
                # verify cross-shard seals against the wrong key set
                # and accept headers sealed by the local keys
                keys = []
        return EpochContext(keys)

    if cfg.get("device_verify") is not None:
        from . import device as DV

        DV.use_device(cfg["device_verify"])
        if cfg["device_verify"]:
            # forced onto the card: without CUDA this raises here, at
            # boot, instead of answering the node's checks on the host
            DV.resolve_device()
    backend = None
    if cfg.get("verify_backend") == "sidecar":
        from .sidecar.client import SidecarClient

        addr = cfg.get("sidecar_addr", "127.0.0.1:9600")
        if ":" in addr:  # host:port, else a unix socket path
            host_part, _, port_part = addr.rpartition(":")
            backend = SidecarClient(
                (host_part or "127.0.0.1", int(port_part))
            )
        else:
            backend = SidecarClient(addr)
    engine = (
        Engine(_committee_provider, backend=backend)
        if cfg.get("verify_seals", True) else None
    )
    chain = Blockchain(db, genesis, engine=engine,
                       blocks_per_epoch=cfg["blocks_per_epoch"],
                       state_retention=cfg.get("state_retention"))
    chain_cell.append(chain)
    if cfg["shard_id"] != 0:
        # non-beacon shards follow beacon committee rotation through
        # the epoch light chain (core/epochchain.py; populated by the
        # beacon-epoch sync feed)
        from .core.epochchain import EpochChain

        epoch_chain_cell.append(EpochChain(
            db, lambda s: list(chain.genesis.committee), engine=engine,
        ))
        reg_epoch_chain = epoch_chain_cell[0]
    else:
        reg_epoch_chain = None
    pool = TxPool(genesis.config.chain_id, cfg["shard_id"], chain.state)
    if not cfg["in_memory"]:
        # locally submitted txs survive restarts (reference:
        # tx_journal.go; rotated at every commit boundary)
        restored = pool.open_journal(os.path.join(
            cfg["datadir"], f"shard{cfg['shard_id']}.txjournal"
        ))
        if restored:
            log = get_logger("pool", shard=cfg["shard_id"])
            log.info("tx journal replayed", restored=restored)

    keys = load_node_bls_keys(cfg, dev_bls)

    host = TCPHost(name=f"shard{cfg['shard_id']}-{os.getpid()}",
                   listen_port=cfg["p2p_port"])
    for peer in cfg["peers"]:
        addr, _, port = peer.rpartition(":")
        host.connect(int(port), addr or "127.0.0.1")
    discovery = None
    if cfg.get("bootnodes"):
        from .p2p.discovery import Discovery

        discovery = Discovery(host, bootnodes=cfg["bootnodes"]).start()

    reg = Registry(blockchain=chain, txpool=pool, host=host)
    if discovery is not None:
        reg.set("discovery", discovery)
    if reg_epoch_chain is not None:
        reg.set("beaconchain", reg_epoch_chain)
    reg.set("shard_count", int(cfg.get("shard_count") or 1))
    # the metrics registry must exist BEFORE the Node: its constructor
    # wires the per-round latency histogram from registry.get("metrics")
    metrics_reg = MetricsRegistry()
    reg.set("metrics", metrics_reg)
    node = Node(reg, keys, network=cfg["network"])
    hmy = Harmony(chain, pool, node)

    manager = Manager()

    rpc = RPCServer(hmy, port=cfg["rpc_port"])
    manager.register(
        ServiceType.CLIENT_SUPPORT,
        _CallbackService(rpc.start, rpc.stop),
    )

    if cfg.get("ws_port") is not None:
        from .rpc.ws import WSServer

        ws = WSServer(rpc, port=cfg["ws_port"])
        manager.register(
            ServiceType.WEBSOCKET,
            _CallbackService(ws.start, ws.stop),
        )

    metrics = MetricsServer(metrics_reg, port=cfg["metrics_port"])
    manager.register(
        ServiceType.PROMETHEUS,
        _CallbackService(metrics.start, metrics.stop),
    )

    if span_sink is not None:
        # armed eagerly above (boot spans export too); the service
        # slot flushes and unhooks it on shutdown
        manager.register(
            ServiceType.SPAN_SINK,
            _CallbackService(lambda: None, span_sink.close),
        )

    if cfg.get("pprof_port") is not None:
        # reference: api/service/pprof behind cmd/harmony --pprof
        from .pprof import PprofServer

        pprof = PprofServer(port=int(cfg["pprof_port"]))
        manager.register(
            ServiceType.PPROF,
            _CallbackService(pprof.start, pprof.stop),
        )

    sync_srv = SyncServer(chain, listen_port=cfg["sync_port"])
    manager.register(
        ServiceType.SYNCHRONIZE,
        _CallbackService(lambda: None, sync_srv.close),
    )

    if discovery is not None:
        manager.register(
            ServiceType.NETWORK_INFO,
            _CallbackService(lambda: None, discovery.stop),
        )

    if reg_epoch_chain is not None and cfg.get("beacon_sync_peer"):
        import threading as _threading

        from .sync.epoch_feed import EpochFeed

        addr, sep, bport = cfg["beacon_sync_peer"].rpartition(":")
        if not sep or not bport.isdigit():
            raise ValueError(
                f"beacon_sync_peer must be host:port, got "
                f"{cfg['beacon_sync_peer']!r}"
            )
        bport_num = int(bport)
        feed_stop = _threading.Event()
        feed_log = get_logger("epoch-feed")

        def _feed_loop():
            from .p2p.stream import SyncClient as _SC

            client = None
            while not feed_stop.is_set():
                try:
                    if client is None:
                        client = _SC(bport_num, addr or "127.0.0.1")
                    feed = EpochFeed(
                        reg_epoch_chain, client, cfg["blocks_per_epoch"]
                    )
                    feed.feed_once()
                except (OSError, ConnectionError, ValueError) as e:
                    feed_log.warn(
                        "beacon feed retry", peer=cfg["beacon_sync_peer"],
                        err=str(e),
                    )
                    client = None  # beacon peer away: retry next tick
                feed_stop.wait(30.0)

        feed_thread = _threading.Thread(
            target=_feed_loop, daemon=True,
        )  # graftlint: thread-role=serving — devnet feed, /readyz covers it
        manager.register(
            ServiceType.CROSSLINK_SENDING,  # beacon-follow service slot
            _CallbackService(feed_thread.start, feed_stop.set),
        )

    if cfg.get("explorer_port") is not None:
        from .explorer import ExplorerServer

        explorer = ExplorerServer(chain, port=cfg["explorer_port"])
        reg.set("explorer", explorer)
        manager.register(
            ServiceType.SUPPORT_EXPLORER,
            _CallbackService(explorer.start, explorer.stop),
        )

    if cfg.get("rosetta_port") is not None:
        from .rosetta import RosettaServer

        rosetta = RosettaServer(hmy, port=cfg["rosetta_port"])
        reg.set("rosetta", rosetta)
        manager.register(
            ServiceType.ROSETTA,
            _CallbackService(rosetta.start, rosetta.stop),
        )

    if cfg["sync_peers"]:
        clients = []
        for peer in cfg["sync_peers"]:
            addr, _, port = peer.rpartition(":")
            clients.append(SyncClient(int(port), addr or "127.0.0.1"))
        downloader = Downloader(chain, clients,
                                verify_seals=chain.engine is not None)
        downloader.sync_once()  # catch up before consensus starts
        # the node spins this up again if consensus detects it fell
        # behind (node.py _spin_up_sync — consensus/downloader.go analog)
        reg.set("downloader", downloader)

    consensus_thread: list = []
    manager.register(
        ServiceType.CONSENSUS,
        _CallbackService(
            lambda: consensus_thread.append(node.run_forever(
                block_time=float(cfg.get("block_time") or 2.0),
                phase_timeout=cfg.get("phase_timeout"),
            )),
            node.stop,
        ),
    )

    # overload survival: a node-wide resource governor
    # sampling RSS / fds / threads / scheduler queue depth / pool fill
    # into the NORMAL->PRESSURED->CRITICAL tiers that drive the
    # tx-pool floor, RPC 429s, scheduler sheds and the sync window;
    # /healthz + /readyz on the MetricsServer report its verdicts.
    # Operator knobs: `governor = false` disarms it, `governor_limits`
    # (a table of governor.Limits field overrides, e.g.
    # rss_pressured_bytes) retunes the thresholds for a node whose
    # healthy steady-state sits above the defaults,
    # `governor_interval` / `governor_ingress_rate` tune the sampling
    # cadence and the PRESSURED-tier per-client admission budget
    if cfg.get("governor", True):
        from . import governor as GV

        limit_overrides = cfg.get("governor_limits") or {}
        gov = GV.ResourceGovernor(
            limits=(GV.Limits(**limit_overrides)
                    if limit_overrides else None),
            interval_s=float(cfg.get("governor_interval", 1.0)),
            pressured_ingress_rate=float(
                cfg.get("governor_ingress_rate", 100.0)
            ),
        )
        gov.attach_pool(pool)

        def _stop_governor():
            gov.stop()
            GV.uninstall()

        manager.register(
            ServiceType.MAINTENANCE,
            _CallbackService(
                lambda: GV.install(gov).start(), _stop_governor,
            ),
        )
    return node, manager, reg, rpc, metrics


def main(argv=None):
    p = argparse.ArgumentParser(prog="harmony-tpu")
    p.add_argument("--config", help="TOML config file")
    p.add_argument("--network")
    p.add_argument("--shard-id", type=int, dest="shard_id")
    p.add_argument("--shard-count", type=int, dest="shard_count")
    p.add_argument("--block-time", type=float, dest="block_time")
    p.add_argument("--phase-timeout", type=float, dest="phase_timeout",
                   help="consensus phase timeout before view change "
                        "(default: the reference's 27 s)")
    p.add_argument("--dev-key-span", type=int, dest="dev_key_span",
                   help="number of consecutive dev keys this node votes "
                        "with (multi-BLS validator)")
    p.add_argument("--datadir")
    p.add_argument("--rpc-port", type=int, dest="rpc_port")
    p.add_argument("--metrics-port", type=int, dest="metrics_port")
    p.add_argument("--pprof-port", type=int, dest="pprof_port",
                   help="serve /debug/pprof profiles on localhost "
                        "(off unless given)")
    p.add_argument("--p2p-port", type=int, dest="p2p_port")
    p.add_argument("--sync-port", type=int, dest="sync_port")
    p.add_argument("--peer", action="append", dest="peers")
    p.add_argument("--bootnode", action="append", dest="bootnodes")
    p.add_argument("--sync-peer", action="append", dest="sync_peers")
    p.add_argument("--beacon-sync-peer", dest="beacon_sync_peer")
    p.add_argument("--dev-keys", type=int, dest="dev_keys")
    p.add_argument("--dev-key-index", type=int, dest="dev_key_index")
    p.add_argument("--verify-backend", dest="verify_backend",
                   choices=["in-process", "sidecar"])
    p.add_argument("--sidecar-addr", dest="sidecar_addr")
    p.add_argument("--no-native-kv", action="store_const", const=False,
                   default=None, dest="native_kv")
    p.add_argument("--fsync", dest="fsync",
                   choices=["none", "batch", "always"],
                   help="shard-DB durability: fsync every atomic "
                        "block-commit batch (default), every write, "
                        "or never (OS-buffered)")
    p.add_argument("--skip-ntp-check", action="store_const", const=False,
                   default=None, dest="ntp_check")
    p.add_argument("--log-level", dest="log_level",
                   choices=["debug", "info", "warn", "error"])
    p.add_argument("--log-path", dest="log_path")
    p.add_argument("--trace", dest="trace", action="store_const",
                   const=True, default=None,
                   help="arm round tracing + the flight recorder "
                        "(/debug/trace on the metrics port)")
    p.add_argument("--trace-sample", type=float, dest="trace_sample",
                   help="root-span sampling rate in [0,1] (default 1)")
    p.add_argument("--trace-slo", type=float, dest="trace_slo",
                   help="round-latency SLO seconds; a slower round "
                        "dumps a flight-recorder snapshot")
    p.add_argument("--trace-dir", dest="trace_dir",
                   help="flight-recorder dump directory")
    p.add_argument("--span-sink-dir", dest="span_sink_dir",
                   help="durable span export: write every finished "
                        "span as JSONL under this directory (implies "
                        "--trace; analyze with python -m "
                        "harmony_tpu_torch.tools.round_forensics)")
    p.add_argument("--device-verify", dest="device_verify",
                   action="store_const", const=True, default=None,
                   help="force the card's verification path (fails "
                        "at boot without CUDA)")
    p.add_argument("--host-verify", dest="device_verify",
                   action="store_const", const=False,
                   help="force the host bigint verification path")
    p.add_argument("--no-verify-seals", dest="verify_seals",
                   action="store_const", const=False, default=None)
    p.add_argument("--revert-to", type=int, dest="revert_to",
                   help="roll the chain back to this block and exit "
                        "(the reference's revert tooling)")
    p.add_argument("--state-retention", type=int, dest="state_retention",
                   help="keep only the last N block states (pruned "
                        "node; default: archive, keep all)")
    p.add_argument("--prune-states", type=int, dest="prune_states",
                   help="offline: delete state blobs older than "
                        "head-N, then exit (blockchain_pruner role)")
    p.add_argument("--snapshot-export", dest="snapshot_export",
                   help="offline: write the head state snapshot to "
                        "this file, then exit")
    p.add_argument("--snapshot-import", dest="snapshot_import",
                   help="offline: install a snapshot file, then exit")
    p.add_argument("--snapshot-trust", action="store_true",
                   dest="snapshot_trust",
                   help="allow --snapshot-import into a chain that "
                        "does not yet have the snapshot's header")
    args = p.parse_args(argv)
    cfg = load_config(args.config, vars(args))
    init_logging(cfg.get("log_level"), cfg.get("log_path"))

    if cfg.get("revert_to") is not None:
        # maintenance mode: open the DB + chain DIRECTLY, roll back,
        # exit — no peers dialed, no ports bound, no sync run
        # (cmd/harmony revert semantics)
        chain = open_chain_for_maintenance(cfg)
        n = chain.revert_to(int(cfg["revert_to"]))
        print(
            f"reverted {n} block(s); head is now {chain.head_number}",
            flush=True,
        )
        return 0

    if (cfg.get("prune_states") is not None
            or cfg.get("snapshot_export") or cfg.get("snapshot_import")):
        # offline state maintenance (core/snapshot.py)
        from .core import snapshot as SN

        chain = open_chain_for_maintenance(cfg)
        if cfg.get("snapshot_import"):
            num = SN.import_snapshot(
                chain, cfg["snapshot_import"],
                trust=bool(cfg.get("snapshot_trust")),
            )
            print(f"snapshot installed at block {num}", flush=True)
        if cfg.get("prune_states") is not None:
            n = SN.prune_states(chain, int(cfg["prune_states"]))
            print(f"pruned {n} historical state(s)", flush=True)
        if cfg.get("snapshot_export"):
            num = SN.export_snapshot(chain, cfg["snapshot_export"])
            print(
                f"snapshot of block {num} -> {cfg['snapshot_export']}",
                flush=True,
            )
        return 0

    # clock sanity before consensus (reference: common/ntp at startup):
    # refuse on MEASURED excessive drift; unreachable NTP only warns
    if cfg.get("ntp_check", True):
        from .ntp import check_clock

        ok, offset = check_clock()
        if not ok:
            print(
                f"FATAL: local clock drifts {offset:+.1f}s from NTP — "
                "a validator this far off misses view windows "
                "(--skip-ntp-check to override)",
                flush=True,
            )
            return 1
        if offset is None:
            print("warning: NTP unreachable, clock check skipped",
                  flush=True)

    # warm the card BEFORE any service thread can reach a device
    # dispatch: after this, every manifest program has run once and the
    # consensus pump never blocks on a kernel's first launch
    if cfg.get("aot_warmup", True):
        from . import aot

        aot.startup_warmup()

    node, manager, reg, rpc, metrics = build_node(cfg)
    manager.start_services()
    from . import device as DV

    get_logger("node").info(
        "harmony-tpu node up", shard=cfg["shard_id"], rpc=rpc.port,
        metrics=metrics.port, p2p=node.host.port,
        seal_verify=node.chain.engine is not None,
        device_path=DV.device_enabled(),
    )
    print(
        f"harmony-tpu node up: shard {cfg['shard_id']} "
        f"rpc :{rpc.port} metrics :{metrics.port} "
        f"p2p :{node.host.port}",
        flush=True,
    )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
    finally:
        manager.stop_services()
    return 0


if __name__ == "__main__":
    sys.exit(main())
