"""Chaos scenario executor: build the topology, pour the traffic, run
the fault script, check the invariants, dump evidence on violation.

One :func:`run` call executes one :class:`~.scenario.Scenario` against
an in-process localnet (threaded nodes over the InProcessNetwork hub,
per-node sync servers + downloaders over real TCP streams, optional
sidecar-backed engines) with the full production verification stack
armed: forced device path (the kernels on the card; off it the twins,
and ``HARMONY_CHAOS_REAL_KERNELS=1`` without CUDA raises instead of
answering on the host), the shared verification scheduler,
round tracing + flight recorder, deterministic fault injection seeded
from the scenario.

Invariants are evaluated AFTER teardown over the run's own
observability surfaces — tracer round spans (abandoned rounds
excluded from latency quantiles), the scheduler's shed counters, the
chains themselves for liveness and fork checks.  Every violation
produces exactly ONE correlated flight-recorder dump: the violation
kind is unique per (scenario, invariant) and carries the last round's
trace id, so ``trace.anomaly``'s (kind, trace_id) dedup makes the
"exactly one" machine-enforced, not convention.

The port's copy of the JAX package's ``chaostest/runner.py``.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field

from .. import faultinject as FI
from .. import health as HL
from .. import trace
from ..log import get_logger
from .scenario import Scenario

CHAIN_ID = 2
_log = get_logger("chaostest")

_SHED_REASONS = ("breaker_open", "queue_full", "deadline", "expired")


def _consensus_sheds() -> float:
    from ..sched.scheduler import SHED

    return sum(
        SHED.value(lane="consensus", reason=r) for r in _SHED_REASONS
    )


def _m(value, unit: str, **fields) -> dict:
    out = {"value": value, "unit": unit, "source": "measured"}
    out.update(fields)
    return out


def _quantiles(values: list) -> tuple:
    if not values:
        return None, None
    s = sorted(values)
    return (s[len(s) // 2], s[min(len(s) - 1, int(len(s) * 0.99))])


@dataclass
class NodeHandle:
    name: str
    shard: int
    index: int
    node: object = None
    chain: object = None
    pool: object = None
    sync_server: object = None
    sync_clients: list = field(default_factory=list)
    sidecar_client: object = None
    pump: object = None
    host: object = None
    data_path: str = None      # durable topologies: this node's FileKV
    sync_port: int = 0         # stable across restarts (peers repoint
    #                            lazily to the same port)
    keys: list = None          # BLS keys, kept for restart wiring
    killed_at: float = None    # monotonic time of the last hard kill
    restarts: int = 0
    byz: bool = False          # an ACTIVE adversary (ByzantineNode):
    #                            excluded from liveness/fork invariants
    dark: bool = False         # a late_join member not yet joined:
    #                            node is None until a Phase joins it
    joined_at: float = None    # monotonic time the member came online


@dataclass
class RunEnv:
    """Everything a custom invariant (or the drive loop) can see."""

    scenario: Scenario
    net: object
    handles: list
    registry: object
    ecdsa_keys: list
    ext_keys: list
    data: dict = field(default_factory=dict)  # scenario scratch (cx...)
    round_durs: dict = field(default_factory=dict)
    errors: list = field(default_factory=list)
    sidecar_server: object = None

    def by_shard(self, shard: int) -> list:
        return [h for h in self.handles if h.shard == shard]

    def honest(self, shard: int) -> list:
        """The shard's honest LIVE nodes — what the liveness / fork
        invariants judge.  An adversary's own chain is its problem; a
        dark late_join member has no node yet (once joined it is held
        to the same invariants as everyone else)."""
        return [
            h for h in self.by_shard(shard)
            if not h.byz and h.node is not None
        ]

    def shard_head(self, shard: int) -> int:
        """Network head: max over the shard's HONEST nodes (a
        partitioned, lagging or lying node must not mask — or fake —
        the committee's progress)."""
        return max(
            (h.node.chain.head_number for h in self.honest(shard)),
            default=0,
        )


@dataclass
class ScenarioResult:
    name: str
    passed: bool
    violations: list
    metrics: dict
    violation_dumps: list
    all_dumps: list
    heads: dict


# -- build -------------------------------------------------------------------


def _build(scenario: Scenario, registry, built: list | None = None
           ) -> RunEnv:
    from ..chain.engine import Engine, EpochContext
    from ..core.blockchain import Blockchain
    from ..core.genesis import Genesis, dev_genesis
    from ..core.kv import FileKV, MemKV
    from ..core.tx_pool import TxPool
    from ..multibls import PrivateKeys
    from ..node.node import Node
    from ..node.registry import Registry
    from ..p2p import InProcessNetwork
    from ..p2p.stream import SyncClient, SyncServer
    from ..sync import Downloader
    from . import fixtures as FX

    top = scenario.topology
    if top.committee_size:
        # mainnet-shape committee: distribute the slots round-robin
        # across the nodes (64 over 4 = 16 keys/node)
        base, rem = divmod(top.committee_size, top.nodes)
        spans = [base + (1 if i < rem else 0) for i in range(top.nodes)]
    else:
        spans = [2 if i < top.multikey else 1 for i in range(top.nodes)]
    n_keys = sum(spans)
    # the overload flood needs enough FUNDED senders to genuinely fill
    # a pool (per-sender slots bound what one account can hold): widen
    # the dev alloc, committee unchanged
    n_accounts = n_keys
    if scenario.traffic.node_pool_rate > 0:
        n_accounts = max(n_keys, 64)
    if top.n_accounts:
        # mainnet-shaped allocation: the rehearsal's state
        # is large on purpose — genesis build, per-block serialization
        # and the snapshot bootstrap all pay for it
        n_accounts = max(n_accounts, top.n_accounts)
    genesis0, ecdsa_keys, bls_keys = dev_genesis(
        n_accounts=n_accounts, n_keys=n_keys, shard_id=0,
        flat_root=top.flat_root,
    )
    shard_genesis = {0: genesis0}
    for s in range(1, top.shards):
        shard_genesis[s] = Genesis(
            config=genesis0.config, shard_id=s,
            alloc=dict(genesis0.alloc),
            committee=list(genesis0.committee),
        )
    ext_keys = [
        FX.external_bls_key(scenario.seed, i)
        for i in range(top.external_validators)
    ]

    env = RunEnv(
        scenario=scenario, net=InProcessNetwork(), handles=[],
        registry=registry, ecdsa_keys=ecdsa_keys, ext_keys=ext_keys,
    )
    # every run carries a link conditioner seeded from the scenario:
    # disarmed (no rules) it costs one attribute check per delivery;
    # Phase.partition / Phase.links install rules through it
    from .netem import NetEm

    env.net.netem = NetEm(seed=scenario.seed)
    if built is not None:
        # expose the env to the caller BEFORE any resource (server
        # socket, sidecar dial) is opened: a build that raises partway
        # must still be tear-downable
        built.append(env)

    if top.sidecar:
        from ..sidecar.server import SidecarServer

        env.sidecar_server = SidecarServer().start()

    # ONE EpochContext per distinct committee across every chain in
    # the run (nodes + replay replicas): same-committee checks share a
    # device-resident table and coalesce in the scheduler's buckets —
    # the deployment shape (committee tables are per-epoch state)
    ctx_cache: dict = {}
    ctx_lock = threading.Lock()

    def shared_ctx(committee: list) -> EpochContext:
        key = tuple(committee)
        with ctx_lock:
            ctx = ctx_cache.get(key)
            if ctx is None:
                ctx = EpochContext(list(key))
                ctx_cache[key] = ctx
            return ctx

    def mk_chain(shard: int, data_path: str | None = None,
                 label: str = "replica"):
        """A full chain for ``shard``: trustless committee provider
        (each chain answers epochs from ITS OWN persisted elections),
        optional finalizer, optional sidecar-backed engine.
        ``data_path`` makes it durable (FileKV — reopening the same
        path runs recovery-on-open).  ``label`` names the sidecar
        client's watchdog participant.  Returns
        (chain, sidecar_client_or_None)."""
        client = None
        if env.sidecar_server is not None:
            from ..sidecar.client import SidecarClient

            client = SidecarClient(env.sidecar_server.address,
                                   label=label)
        holder: dict = {}

        def provider(s, epoch):
            return shared_ctx(
                holder["chain"].committee_for_epoch(epoch)
            )

        chain = Blockchain(
            FileKV(data_path) if data_path else MemKV(),
            shard_genesis[shard],
            engine=Engine(provider, device=True, backend=client),
            blocks_per_epoch=top.blocks_per_epoch,
            finalizer=(
                FX.staking_finalizer(
                    genesis0, ecdsa_keys, shard_count=top.shards
                ) if top.staking else None
            ),
        )
        holder["chain"] = chain
        return chain, client

    env.data["mk_chain"] = mk_chain

    def wire_node(handle: NodeHandle):
        """(Re)build one node onto its handle: chain (durable when the
        topology is), pool, registry, gossip host, sync server on the
        handle's stable port, Node.  Shared by the initial build and
        the kill/restart path — a restarted node goes through exactly
        the wiring a fresh one does, on the same data dir."""
        handle.chain, handle.sidecar_client = mk_chain(
            handle.shard, handle.data_path, label=handle.name
        )
        handle.pool = TxPool(CHAIN_ID, handle.shard, handle.chain.state)
        handle.host = env.net.host(handle.name)
        reg = Registry(
            blockchain=handle.chain, txpool=handle.pool,
            host=handle.host,
        )
        reg.set("metrics", registry)
        if top.shards > 1:
            reg.set("shard_count", top.shards)
        if top.aggregation != "direct":
            reg.set("aggregation", top.aggregation)
        handle.sync_server = SyncServer(
            handle.chain, listen_port=handle.sync_port
        )
        handle.sync_port = handle.sync_server.port
        byz_map = dict(top.byzantine)
        if handle.name in byz_map:
            from .byzantine import ByzantineNode

            behaviors = byz_map[handle.name].split("+")
            # double-voters sign their conflicting ballots with the
            # staked external key (when the topology seats one): the
            # offense must be attributable to a slashable validator
            adversary = None
            if "double_vote" in behaviors and env.ext_keys:
                adversary = {env.ext_keys[0].pub.bytes}
            handle.byz = True
            handle.node = ByzantineNode(
                reg, PrivateKeys.from_keys(handle.keys),
                behaviors=behaviors, adversary_keys=adversary,
                seed=scenario.seed,
            )
        else:
            handle.node = Node(reg, PrivateKeys.from_keys(handle.keys))
        handle._registry = reg

    def wire_sync(handle: NodeHandle):
        """Point the handle's downloader at its current shard peers
        (their ports are stable across restarts; SyncClient dials
        lazily, so a peer being down is a per-call error)."""
        peers = [p for p in env.by_shard(handle.shard) if p is not handle]
        handle.sync_clients = [
            SyncClient(p.sync_port, timeout=5.0) for p in peers
        ]
        if handle.sync_clients:
            handle._registry.set("downloader", Downloader(
                handle.chain, handle.sync_clients, verify_seals=True,
                request_deadline_s=2.0,
                snapshot_threshold=top.snapshot_threshold,
            ))

    env.data["wire_node"] = wire_node
    env.data["wire_sync"] = wire_sync

    if top.durable:
        import tempfile

        env.data["data_dir"] = tempfile.mkdtemp(prefix="harmony-chaos-")

    for s in range(top.shards):
        for i in range(top.nodes + top.late_join):
            # the handle registers BEFORE its resources are allocated:
            # if any later step raises (port bind on a loaded box, a
            # wedged sidecar dial), run()'s teardown still closes
            # whatever this partial handle already owns
            handle = NodeHandle(name=f"s{s}n{i}", shard=s, index=i)
            env.handles.append(handle)
            if top.durable:
                handle.data_path = os.path.join(
                    env.data["data_dir"], f"{handle.name}.kv"
                )
            if i >= top.nodes:
                # a late_join member starts DARK: keys assigned (a
                # non-committee observer key), everything else waits
                # for its Phase.joins trigger — until then the member
                # has no host, server, downloader, node or pump
                handle.dark = True
                handle.keys = [
                    FX.observer_bls_key(scenario.seed, i - top.nodes)
                ]
                continue
            key_index = sum(spans[:i])
            keys = list(bls_keys[key_index:key_index + spans[i]])
            if s == 0 and i < len(ext_keys):
                # the external validator's key rides node i as an
                # extra (multi-key) slot key: once the election seats
                # it, the node votes with both
                keys.append(ext_keys[i])
            handle.keys = keys
            wire_node(handle)

    # sync mesh per shard: every node can pull from every other —
    # consensus-timeout sync and post-heal rejoin both need a peer
    # (dark members wire at join time)
    for h in env.handles:
        if not h.dark:
            wire_sync(h)

    # resource baseline for the overload invariants: what the process
    # held BEFORE any traffic — the bounded-resources check diffs the
    # post-run sample against this
    from ..metrics import process_sample

    env.data["res_t0"] = process_sample()

    # staking topologies: register the external validators up front so
    # epoch 0's election block seats them (POPs verify on the INGRESS
    # lane like any live registration)
    for i, ext in enumerate(ext_keys):
        stx = FX.external_validator_stake(
            ecdsa_keys[i], ext, chain_id=CHAIN_ID
        )
        for h in env.by_shard(0):
            if h.pool is None:
                continue  # a dark late_join member has no pool yet
            try:
                h.pool.add(stx, is_staking=True)
            except Exception as e:  # noqa: BLE001 — a rejected stake
                # breaks the scenario's premise: surface it
                env.errors.append(f"stake submit {h.name}: {e!r}")
    return env


# -- traffic -----------------------------------------------------------------


def _paced_flood(env: RunEnv, txs, rate: float, is_staking: bool,
                 category: str, ready, stop, done: list):
    from ..core.tx_pool import PoolError, TxPool

    class _StubState:
        def nonce(self, addr):
            return 0

        def balance(self, addr):
            return 10**30

    from . import fixtures as FX

    try:
        pool = TxPool(CHAIN_ID, 0, _StubState, cap=len(txs) + 64)
        ready.wait()
        start = time.monotonic()
        n = 0
        for _, (tx, sender) in zip(FX.paced_ticks(rate, stop), txs):
            try:
                pool.add(tx, is_staking=is_staking, sender=sender)
            except PoolError:
                pass  # replacement/caps: still a submission
            n += 1
        done.append((category, n, time.monotonic() - start))
    except Exception as e:  # noqa: BLE001 — fail the scenario loudly
        env.errors.append(f"{category} flood: {e!r}")
        done.append((category, 0, 0.0))


def _node_pool_flood(env: RunEnv, txs, rate: float, duration_s: float,
                     ready, stop, done: list):
    """Overload flood: paced submission ATTEMPTS into the
    real shard-0 node pools, round-robin, cycling a bounded fixture
    for the whole window.  At 10x rated most attempts are REJECTED
    (overload floor, caps, same-nonce replacement) — which is the
    scenario's premise: the node must refuse work cheaply and keep
    committing, not wedge or balloon.  Pool/admission errors are the
    expected outcome; only unexpected exceptions fail the scenario."""
    from ..core.tx_pool import PoolError
    from . import fixtures as FX

    try:
        ready.wait()
        pools = [h.pool for h in env.by_shard(0) if h.pool is not None]
        start = time.monotonic()
        n = 0
        for i in FX.paced_ticks(rate, stop, duration_s):
            tx, sender = txs[i % len(txs)]
            # every node sees every submission (the gossip-admission
            # shape): overload pressure is per-NODE, not per-network
            for pool in pools:
                try:
                    pool.add(tx, sender=sender)
                except PoolError:
                    pass  # refused = governed; the invariant counts it
            n += 1
        done.append(("node_pool", n, time.monotonic() - start))
        env.data["node_pool_submitted"] = n
    except Exception as e:  # noqa: BLE001 — fail the scenario loudly
        env.errors.append(f"node_pool flood: {e!r}")
        done.append(("node_pool", 0, 0.0))


def _replay_worker(env: RunEnv, stop):
    """Re-verify the committed shard-0 chain into fresh replicas — the
    SYNC-lane seal batches concurrent with live rounds (and, in the
    staking topology, across the election boundary)."""
    from ..core.blockchain import ChainError

    mk_chain = env.data["mk_chain"]
    try:
        while not stop.is_set():
            try:
                # re-resolve the source each pass: a restarted node
                # swaps its chain object, and the stale one stops at
                # the head it died with
                src = env.by_shard(0)[0].chain
                head = src.head_number
                if head < 1:
                    time.sleep(0.01)
                    continue
                replica, client = mk_chain(0)
                try:
                    blocks, proofs = [], []
                    for n in range(1, head + 1):
                        blk = src.block_by_number(n)
                        proof = src.read_commit_sig(n)
                        if blk is None or proof is None:
                            break
                        blocks.append(blk)
                        proofs.append(proof)
                    if blocks:
                        replica.insert_chain(blocks, commit_sigs=proofs,
                                             verify_seals=True)
                finally:
                    if client is not None:
                        # per-iteration replica clients must not
                        # accumulate sockets + reader threads across a
                        # long flap run
                        try:
                            client.close()
                        except OSError:
                            pass
            except ChainError:
                raise  # a real replay failure IS the finding
            except (ValueError, OSError):
                # a scripted kill/restart closed the source store out
                # from under this pass: benign, retry on the new chain
                time.sleep(0.05)
    except Exception as e:  # noqa: BLE001
        env.errors.append(f"replay worker: {e!r}")


def _cx_submitter(env: RunEnv, stop):
    """Shard-0 -> shard-1 transfers from dev account 0, submitted into
    every shard-0 pool once both shards are live; the arrival of the
    credited balance on shard 1 is the scenario's custom invariant."""
    from ..core.types import Transaction

    n = env.scenario.traffic.cross_shard_transfers
    sender_key = env.ecdsa_keys[0]
    sender = sender_key.address()
    dest = b"\x2c" * 20
    env.data["cx_dest"] = dest
    env.data["cx_expected"] = 0
    try:
        deadline = time.monotonic() + env.scenario.window_s
        while time.monotonic() < deadline and not stop.is_set():
            if env.shard_head(0) >= 1 and env.shard_head(1) >= 1:
                break
            time.sleep(0.05)
        total = 0
        for t in range(n):
            if stop.is_set():
                break
            value = 1000 + t
            tx = Transaction(
                nonce=t, gas_price=1, gas_limit=30_000, shard_id=0,
                to_shard=1, to=dest, value=value,
            ).sign(sender_key, CHAIN_ID)
            for h in env.by_shard(0):
                if h.pool is None:
                    continue  # dark late_join member
                try:
                    h.pool.add(tx, sender=sender)
                except Exception:  # noqa: BLE001 — pool dedup/caps
                    pass
            total += value
            time.sleep(0.2)
        env.data["cx_expected"] = total
    except Exception as e:  # noqa: BLE001
        env.errors.append(f"cx submitter: {e!r}")


# -- kill / restart ----------------------------------------------------------


def _kill_node(env: RunEnv, handle, torn_tail: bool = False) -> None:
    """Hard-kill one node: stop its threads, drop its gossip host off
    the hub, close its sync server socket.  NOTHING is flushed or
    closed cleanly — FileKV writes are unbuffered, so exactly the
    bytes a SIGKILLed process would leave in the OS page cache are
    what the restart reopens.  ``torn_tail`` additionally stamps an
    un-committed batch fragment onto the dead node's log (BEGIN marker
    + a half-written record): the live commit path self-heals its own
    injected failures by truncating, so a kill-during-write's torn
    bytes must be laid down here for the restart to REALLY exercise
    replay discard on a node data dir."""
    h = handle
    if h.node is None:
        return
    # snapshot equivocation evidence BEFORE the node object is
    # replaced: the no_double_sign invariant must see what a later-
    # killed leader had collected, not just the survivors' lists
    if h.node.pending_double_signs:
        env.data.setdefault("double_signs", []).extend(
            h.node.pending_double_signs
        )
    h.killed_at = time.monotonic()
    h.node.stop()
    if h.pump is not None:
        h.pump.join(timeout=10)
    # the background downloader also writes the chain store: it must
    # be DEAD before a restart opens a second writer on the same file
    # (the loop checks node._stop, so this join is bounded by one
    # sync_once pass)
    sync_thread = getattr(h.node, "_sync_thread", None)
    if sync_thread is not None:
        sync_thread.join(timeout=10)
    if h.host is not None:
        env.net.remove(h.host)
    if h.sync_server is not None:
        h.sync_server.close()
    for c in h.sync_clients:
        try:
            c.close()
        except OSError:
            pass
    h.sync_clients = []
    if torn_tail and h.data_path is not None:
        import struct as _struct

        with open(h.data_path, "ab") as f:
            # BEGIN claiming 3 records, then one record cut mid-value:
            # the shape a kill mid-batch leaves on disk
            f.write(_struct.pack("<II", 0xFFFFFFFE, 3)
                    + _struct.pack("<II", 4, 100) + b"torn" + b"par")
    _log.warn("chaos node killed", node=h.name,
              head=h.chain.head_number, torn_tail=torn_tail)


def _restart_node(env: RunEnv, handle) -> None:
    """Reopen a killed node from its data dir: FileKV replay discards
    any torn batch, Blockchain recovery-on-open verifies the head, the
    SafetyStore reloads the durable last-signed views, and the node
    rejoins consensus via the sync mesh (same port as before — peers'
    lazy clients reconnect by themselves)."""
    h = handle
    # belt and braces against any straggler writer: close the dead
    # node's store handle before the new one opens the file — a racer
    # then fails loudly on a closed file instead of corrupting the log
    # (everything written pre-kill is already with the OS; FileKV is
    # unbuffered)
    if h.chain is not None:
        try:
            h.chain.db.close()
        except (OSError, ValueError):
            pass
    if h.sidecar_client is not None:
        # wire_node dials a fresh client: the dead node's socket +
        # reader thread must not accumulate across a rolling run
        try:
            h.sidecar_client.close()
        except OSError:
            pass
    env.data["wire_node"](h)
    env.data["wire_sync"](h)
    h.restarts += 1
    top = env.scenario.topology
    h.pump = h.node.run_forever(
        poll_interval=0.002,
        block_time=top.block_time_s,
        phase_timeout=top.phase_timeout_s,
    )
    _log.warn(
        "chaos node restarted", node=h.name,
        recovered_head=h.chain.head_number,
        rolled_back=h.chain.recovered_blocks,
        restarts=h.restarts,
    )


def _join_node(env: RunEnv, handle) -> None:
    """Bring a dark ``late_join`` member online mid-run:
    first wiring of its node (gossip host joins the hub, sync server
    binds a fresh port) and its downloader — built with the topology's
    ``snapshot_threshold``, so a joiner far enough behind bootstraps
    from a peer-served snapshot before tail replay.  Peers are NOT
    rewired: the joiner PULLS through its own clients (serving the
    joiner is not load-bearing for the bootstrap; a peer's lazy client
    picks the fresh port up only through its own restart path)."""
    h = handle
    h.dark = False
    env.data["wire_node"](h)
    env.data["wire_sync"](h)
    h.joined_at = time.monotonic()
    behind = env.shard_head(h.shard) - h.chain.head_number
    env.data["join_lag"] = max(env.data.get("join_lag", 0), behind)
    top = env.scenario.topology
    h.pump = h.node.run_forever(
        poll_interval=0.002,
        block_time=top.block_time_s,
        phase_timeout=top.phase_timeout_s,
    )
    _log.warn("chaos node joined", node=h.name, behind=behind)


# -- the fault-script timeline -----------------------------------------------


def _resolve_partition(env: RunEnv, spec: str) -> list:
    """``"s0n1"`` literal; ``"leader[:shard]"`` whoever reports
    is_leader at trigger time; ``"round_leader[:shard]"`` the holder of
    the IN-FLIGHT round's leader slot (head view + 1) — the node whose
    absence wedges the current round, forcing a real view change
    (plain "leader" races the commit: with per-block rotation it can
    name the PREVIOUS round's proposer, which nobody misses)."""
    shard = int(spec.split(":")[1]) if ":" in spec else 0
    hs = env.by_shard(shard)
    if spec.startswith("round_leader"):
        ref = hs[0].node
        view = ref.chain.current_header().view_id + 1
        key = ref.leader_key(view)
        return [
            h.name for h in hs
            if any(k.pub.bytes == key for k in h.node.keys)
        ]
    if spec.startswith("leader"):
        return [h.name for h in hs if h.node.is_leader]
    return [spec]


def _resolve_endpoint(env: RunEnv, spec: str) -> list:
    """A netem link endpoint: ``"*"`` stays a wildcard; anything else
    goes through the partition grammar (literal name, ``"leader"``,
    ``"round_leader[:shard]"``)."""
    if spec == "*":
        return ["*"]
    return _resolve_partition(env, spec)


def _phase_rules(env: RunEnv, phase) -> tuple:
    """Resolve one phase's fault topology into concrete netem rules:
    ``partition`` names become total-loss rules in both directions
    (the old binary black-hole as a loss=1.0 special case), ``links``
    specs resolve their src/dst endpoints at trigger time.  Returns
    (rules, isolated_names) — the latter feed cut_sync/measure_heal."""
    from dataclasses import replace

    from . import netem as NE

    tag = f"phase:{phase.name}"
    names: list = []
    for spec in phase.partition:
        names.extend(_resolve_partition(env, spec))
    rules: list = []
    for nm in names:
        rules.extend(NE.partition_rules(nm, tag=tag))
    for spec in phase.links:
        base = NE.parse_link(spec, tag=tag)
        for src in _resolve_endpoint(env, base.src):
            for dst in _resolve_endpoint(env, base.dst):
                if src == dst and src != "*":
                    continue  # a host's self-link is never conditioned
                rules.append(replace(base, src=src, dst=dst))
    return rules, names


def _cut_sync(env: RunEnv, handle) -> None:
    """Sever one node's sync pull for a phase window: a gossip
    partition alone leaves the TCP sync mesh reachable, so a 'fully
    isolated' node would quietly keep up through it.  The in-flight
    downloader (if a spin-up holds it) is starved of clients, the
    registry slot is emptied (no new spin-up), and the clients are
    closed; ``wire_sync`` at heal rebuilds all of it."""
    dl = handle._registry.get("downloader")
    if dl is not None:
        dl.clients = []
    for c in handle.sync_clients:
        try:
            c.close()
        except OSError:
            pass
    handle.sync_clients = []
    handle._registry.set("downloader", None)


def _heal_phase(env: RunEnv, phase, names, by_name, heal_watch) -> None:
    """Close one fault window: remove its netem rules, stamp the heal
    head, rewire severed sync, and — for ``measure_heal`` phases —
    record each isolated node's blocks-behind lag and start its
    heal-to-caught-up timer."""
    netem = getattr(env.net, "netem", None)
    if netem is not None:
        netem.remove_tag(f"phase:{phase.name}")
    else:  # legacy binary transport (netem-less nets in unit stubs)
        for nm in names:
            env.net.partitioned.discard(nm)
    # NOTE: window stamps read shard 0 (every current netem scenario
    # is single-shard); a multi-shard gray-failure scenario's custom
    # invariant should read its target shard's chains directly
    ph = env.data.get("phase_heads", {}).get(phase.name)
    if ph is not None:
        ph[1] = env.shard_head(0)
    for nm in names:
        h = by_name.get(nm)
        if h is None or h.node is None:
            continue
        if phase.measure_heal:
            lag = env.shard_head(h.shard) - h.chain.head_number
            env.data["heal_lag"] = max(
                env.data.get("heal_lag", 0), lag
            )
            heal_watch.append({"h": h, "at": time.monotonic()})
        if phase.cut_sync:
            env.data["wire_sync"](h)


def _timeline(env: RunEnv, stop, t0: float, phases_done):
    """Execute the scenario's fault script: trigger each phase on its
    round/time condition, arm its faultinject rules with the window's
    expiry, black-hole its partitions, execute its kill specs (tear →
    kill → restart → measure recovery), heal at window end."""
    pending = list(env.scenario.phases)
    active: list = []  # (phase, end_monotonic_or_None, names)
    # kill tasks: {"h", "kill", "state", "deadline"/"restart_at"}
    # armed -> down -> recovering -> done
    kills: list = []
    # heal watches (measure_heal): {"h", "at"} — healed-isolate
    # catch-up timers, resolved when the node reaches the shard head
    heal_watch: list = []
    # join watches: late_join members brought online, resolved when
    # the joiner reaches the shard head (join-to-caught-up seconds)
    join_watch: list = []
    by_name = {h.name: h for h in env.handles}

    def kill_open(t):
        return t["state"] in ("armed", "down", "recovering")

    try:
        while not stop.is_set():
            finite = bool(
                pending or heal_watch or join_watch
                or any(kill_open(t) for t in kills)
                or any(end is not None for _, end, _, _ in active)
            )
            if not finite:
                # only whole-run windows (duration None, e.g. a WAN
                # matrix) remain: the SCRIPT is done — signal it so
                # the run can complete at its floors — but keep the
                # rules armed until scenario end (healing them now
                # would strip the conditioning the scenario is about)
                phases_done.set()
                if not active:
                    break
            now = time.monotonic()
            now_s = now - t0
            head = env.shard_head(0)
            for phase in pending[:]:
                hit = (
                    (phase.at_s is not None and now_s >= phase.at_s)
                    or (phase.at_round is not None
                        and head >= phase.at_round)
                )
                if not hit:
                    continue
                pending.remove(phase)
                # partition + degraded links both install as netem
                # rules (partition = loss 1.0 both ways), healed by
                # tag when the window closes; a netem-less net (unit
                # stubs) falls back to the binary partitioned set
                rules, names = _phase_rules(env, phase)
                netem = getattr(env.net, "netem", None)
                if netem is not None:
                    if rules:
                        netem.add(*rules)
                elif names:
                    for nm in names:
                        env.net.partitioned.add(nm)
                if phase.cut_sync:
                    for nm in names:
                        h = by_name.get(nm)
                        if h is not None and h.node is not None:
                            _cut_sync(env, h)
                # head stamps: custom invariants judge what the chain
                # did DURING the window (no-wedge, heal lag)
                env.data.setdefault("phase_heads", {})[phase.name] = [
                    head, None,
                ]
                for arm_kw in phase.arms:
                    kw = dict(arm_kw)
                    if phase.duration_s is not None:
                        kw.setdefault("t1", phase.duration_s)
                    FI.arm(**kw)
                for nm in phase.joins:
                    h = by_name.get(nm)
                    if h is None or not h.dark:
                        env.errors.append(
                            f"phase {phase.name}: join target {nm} is "
                            "not a dark late_join member"
                        )
                        continue
                    try:
                        _join_node(env, h)
                        join_watch.append({"h": h, "at": time.monotonic()})
                    except Exception as e:  # noqa: BLE001 — a member
                        # that cannot come online IS the finding
                        env.errors.append(f"join {nm}: {e!r}")
                for kill in phase.kills:
                    for nm in _resolve_partition(env, kill.target):
                        h = by_name.get(nm)
                        if h is None or h.node is None:
                            continue
                        task = {"h": h, "kill": kill, "state": "armed",
                                "deadline": now}
                        if (kill.mode == "mid_commit"
                                and h.data_path is not None):
                            # tear the target's NEXT block commit
                            # mid-batch, then kill it: the worst-case
                            # crash the batch layer must absorb.  The
                            # grace deadline covers a wedged round
                            # (no commit to tear) — kill anyway.
                            FI.arm("kv.commit", key=h.data_path,
                                   after=1, times=1)
                            task["deadline"] = now + max(
                                4 * env.scenario.topology.block_time_s,
                                2.0,
                            )
                        kills.append(task)
                end = (None if phase.duration_s is None
                       else time.monotonic() + phase.duration_s)
                cap = time.monotonic() + phase.hold_max_s
                active.append((phase, end, names, cap))
                _log.warn(
                    "chaos phase armed", phase=phase.name,
                    at_round=head, t_s=round(now_s, 2),
                    partitioned=",".join(names) or "-",
                    link_rules=len(rules), arms=len(phase.arms),
                    kills=len(phase.kills), cut_sync=phase.cut_sync,
                )
            for entry in active[:]:
                phase, end, names, cap = entry
                if end is None or time.monotonic() < end:
                    continue
                # load-relative close: past the nominal window, hold
                # the fault open until its job is provably done (or
                # the hard cap trips and the invariant judges it)
                if (phase.hold_until is not None
                        and time.monotonic() < cap):
                    try:
                        done = bool(phase.hold_until(env))
                    except Exception:
                        done = True  # a broken predicate must not wedge
                    if not done:
                        continue
                _heal_phase(env, phase, names, by_name, heal_watch)
                active.remove(entry)
                _log.warn("chaos phase healed", phase=phase.name)
            for task in kills:
                h, kill = task["h"], task["kill"]
                if task["state"] == "armed":
                    torn = (
                        kill.mode == "mid_commit"
                        and h.data_path is not None
                        and FI.fired("kv.commit", key=h.data_path) > 0
                    )
                    if torn or now >= task["deadline"]:
                        _kill_node(
                            env, h,
                            torn_tail=kill.mode == "mid_commit",
                        )
                        if kill.restart_after_s is None:
                            task["state"] = "done"
                        else:
                            task["state"] = "down"
                            task["restart_at"] = (
                                time.monotonic() + kill.restart_after_s
                            )
                elif task["state"] == "down":
                    if now >= task["restart_at"]:
                        _restart_node(env, h)
                        task["state"] = "recovering"
                elif task["state"] == "recovering":
                    # recovered = caught up to the live network head
                    if h.node.chain.head_number >= env.shard_head(h.shard):
                        env.data.setdefault("recovery_s", []).append(
                            time.monotonic() - h.killed_at
                        )
                        task["state"] = "done"
                        _log.warn(
                            "chaos node recovered", node=h.name,
                            head=h.node.chain.head_number,
                            kill_to_caught_up_s=round(
                                time.monotonic() - h.killed_at, 2
                            ),
                        )
            for w in heal_watch[:]:
                # measure_heal: the healed isolate has caught back up
                # to the live network head
                h = w["h"]
                if h.chain.head_number >= env.shard_head(h.shard):
                    catchup = time.monotonic() - w["at"]
                    env.data.setdefault(
                        "heal_catchup_s", []
                    ).append(catchup)
                    heal_watch.remove(w)
                    _log.warn(
                        "chaos healed node caught up", node=h.name,
                        head=h.chain.head_number,
                        heal_catchup_s=round(catchup, 2),
                    )
            for w in join_watch[:]:
                # late joiner has caught up to the live network head
                h = w["h"]
                if h.chain.head_number >= env.shard_head(h.shard):
                    catchup = time.monotonic() - w["at"]
                    env.data.setdefault(
                        "join_catchup_s", []
                    ).append(catchup)
                    join_watch.remove(w)
                    _log.warn(
                        "chaos joined node caught up", node=h.name,
                        head=h.chain.head_number,
                        join_catchup_s=round(catchup, 2),
                    )
            time.sleep(0.05)
    finally:
        # scenario end or abort: heal every link rule we installed
        # (armed rules expire by their own t1 windows) and rewire any
        # severed sync; a node still DOWN with a pending restart is
        # restarted so teardown and invariants see the recovered
        # shape, not a half-run script
        for phase, _, names, _ in active:
            try:
                _heal_phase(env, phase, names, by_name, heal_watch)
            except Exception as e:  # noqa: BLE001
                env.errors.append(f"heal {phase.name}: {e!r}")
        for task in kills:
            if task["state"] == "down" and not stop.is_set():
                try:
                    _restart_node(env, task["h"])
                except Exception as e:  # noqa: BLE001
                    env.errors.append(
                        f"restart {task['h'].name}: {e!r}"
                    )
        phases_done.set()


def _round_collector(env: RunEnv, stop):
    """Poll the bounded tracer store for finished consensus.round
    spans before they age out; abandoned rounds (view change / sync
    rejoin) are excluded from the latency quantiles — they measure a
    fault window, not a commit."""
    def sweep():
        for s in trace.spans():
            if (s.name == "consensus.round" and s.dur_s is not None
                    and not s.attrs.get("abandoned")):
                env.round_durs[s.span_id] = s.dur_s
    while not stop.is_set():
        sweep()
        time.sleep(0.25)
    sweep()


# -- invariants --------------------------------------------------------------


def _last_round_trace(env: RunEnv):
    last = None
    for s in trace.spans():
        if s.name == "consensus.round":
            if last is None or s.t0 > last.t0:
                last = s
    return None if last is None else last.trace_id


def _check_invariants(env: RunEnv, sheds: float) -> list:
    inv = env.scenario.invariants
    top = env.scenario.topology
    violations = []

    def violated(name: str, detail: str):
        violations.append({"invariant": name, "detail": detail})

    heads = {
        s: [h.node.chain.head_number for h in env.honest(s)]
        for s in range(top.shards)
    }
    if any(min(hs) < inv.min_blocks for hs in heads.values()):
        violated(
            "liveness",
            f"honest heads {heads} below min_blocks={inv.min_blocks}",
        )
    if inv.zero_consensus_sheds and sheds > 0:
        violated("zero_consensus_sheds",
                 f"{sheds:g} consensus-lane sheds")
    _, p99 = _quantiles(list(env.round_durs.values()))
    if not env.round_durs:
        violated("round_latency", "no committed round spans observed")
    elif p99 > inv.round_p99_s:
        violated(
            "round_latency",
            f"round p99 {p99:.3f}s > bound {inv.round_p99_s}s "
            f"({len(env.round_durs)} rounds)",
        )
    if inv.no_divergent_heads:
        for s in range(top.shards):
            hs = env.honest(s)
            common = min(h.node.chain.head_number for h in hs)
            if common < 1:
                continue
            hashes = {
                h.node.chain.block_by_number(common).hash()
                for h in hs
            }
            if len(hashes) != 1:
                violated(
                    "no_divergent_heads",
                    f"shard {s} forked at height {common}: "
                    f"{len(hashes)} distinct blocks among honest nodes",
                )
    if inv.min_view_changes:
        vcs = sum(
            h.node.new_views_adopted
            for h in env.handles if h.node is not None
        )
        if vcs < inv.min_view_changes:
            violated(
                "view_change_completed",
                f"{vcs} NEWVIEW adoptions < {inv.min_view_changes} "
                "(the storm never stormed or never recovered)",
            )
    if inv.min_epochs:
        epochs = min(
            h.node.chain.epoch_of(h.node.chain.head_number)
            for h in env.honest(0)
        )
        if epochs < inv.min_epochs:
            violated(
                "epoch_boundary_crossed",
                f"epoch {epochs} < required {inv.min_epochs}",
            )
    for name, fn in inv.custom:
        try:
            ok, detail = fn(env)
        except Exception as e:  # noqa: BLE001 — a broken check IS a
            # violation, not a crash of the sweep
            ok, detail = False, f"invariant check raised: {e!r}"
        if not ok:
            violated(name, detail)
    if env.errors:
        violated("no_worker_errors", "; ".join(env.errors[:4]))
    return violations


# -- run ---------------------------------------------------------------------


def run(scenario: Scenario, registry=None) -> ScenarioResult:
    """Execute one scenario end to end; always tears the localnet down,
    always evaluates invariants, never raises for a violation (the
    result carries them — the sweep CLI turns them into exit codes)."""
    import torch

    from .. import device as DV
    from .. import sched
    from ..metrics import Registry as MetricsRegistry

    registry = registry or MetricsRegistry()
    real = os.environ.get("HARMONY_CHAOS_REAL_KERNELS") == "1"
    # a caller's own forcing of the path (the operator tools' --cpu)
    # comes back after the run
    prev_path = (DV._FORCED, DV._NODE_DEVICE)
    if real:
        # the real kernels run on the card only: the node's device
        # resolves to CUDA, which raises without one, before anything
        # is built
        DV.use_device(None)
        DV.resolve_device()
    prev_twin = os.environ.get("HARMONY_KERNEL_TWIN")
    if not real:
        # twin kernels: every device-path layer (tables, bitmaps,
        # scheduler buckets, counters) at host speed, off the card
        # only (on CUDA the variable is ignored and the kernels run)
        os.environ["HARMONY_KERNEL_TWIN"] = "1"

    FI.reset()
    FI.set_seed(scenario.seed)
    # fresh watchdog state per scenario: counters zeroed (invariants
    # read them after teardown), detection thresholds per topology
    HL.reset()
    if scenario.topology.watchdog_max_age_s is not None:
        HL.configure(
            default_max_age_s=scenario.topology.watchdog_max_age_s,
            check_interval_s=min(
                0.25, scenario.topology.watchdog_max_age_s / 2
            ),
        )
    sched.reset()
    sched.configure(flush_window_s=0.01)
    trace.reset()
    trace.configure(
        enabled=True,
        dump_cooldown_s=2.0,  # distinct anomaly kinds per violation;
        # the cooldown only throttles repeats of one kind
    )
    # replay-stage histograms are process-cumulative; snapshot now so
    # the metric assembly below reports THIS run's delta
    from ..obs import replay as obs_replay

    replay_base = obs_replay.snapshot()
    # the node's checks run on the card where there is one, else on the
    # CPU through the twins; a caller that put them on the CPU keeps
    # them there
    caller_cpu = prev_path[1] is not None and prev_path[1].type == "cpu"
    on_card = real or (not caller_cpu and torch.cuda.is_available())
    DV.use_device(True, device=None if on_card else "cpu")
    sheds_before = _consensus_sheds()
    fi_points = ("device.dispatch", "sidecar.call", "sidecar.frame",
                 "p2p.stream", "webhook.post", "kv.commit")
    hits_before = {p: FI.hits(p) for p in fi_points}

    stop = threading.Event()
    ready = threading.Event()
    phases_done = threading.Event()
    floods_done: list = []
    env = None
    built: list = []
    threads: list = []
    pumps: list = []
    t0 = time.monotonic()
    gov = None
    try:
        env = _build(scenario, registry, built)
        tr = scenario.traffic
        if scenario.topology.governor:
            # a process-wide governor with CI-window limits: the pools
            # can actually fill inside the window, so the tier machine
            # (and every knob behind it) genuinely engages
            from .. import governor as GV

            gov = GV.ResourceGovernor(
                limits=GV.Limits(
                    queue_pressured=192, queue_critical=512,
                    pool_pressured=0.5, pool_critical=0.85,
                    dwell_s=1.0,
                ),
                interval_s=0.25,
                pressured_ingress_rate=50.0,
            )
            for h in env.by_shard(0):
                if h.pool is not None:  # dark members have no pool yet
                    gov.attach_pool(h.pool)
            GV.install(gov)
            gov.start()
            env.data["governor"] = gov
            env.data["gov_rejections_0"] = GV.rejections_total()
        from . import fixtures as FX

        flood_specs = []
        if tr.plain_rate > 0:
            count = int(tr.plain_rate * tr.flood_duration_s)
            flood_specs.append(
                (FX.plain_transfers(count, 1), tr.plain_rate, False,
                 "plain")
            )
        if tr.pop_rate > 0:
            count = max(4, int(tr.pop_rate * tr.flood_duration_s))
            flood_specs.append(
                (FX.pop_submissions(count, 2, scenario.seed),
                 tr.pop_rate, True, "pop")
            )
        n_floods = len(flood_specs)
        if tr.node_pool_rate > 0:
            overload_txs = FX.overload_transfers(env.ecdsa_keys)
            threads.append(threading.Thread(
                target=_node_pool_flood,
                args=(env, overload_txs, tr.node_pool_rate,
                      tr.flood_duration_s, ready, stop, floods_done),
                daemon=True,
            ))
            n_floods += 1
        for spec in flood_specs:
            threads.append(threading.Thread(
                target=_paced_flood,
                args=(env, *spec, ready, stop, floods_done),
                daemon=True,
            ))
        for _ in range(tr.replay_workers):
            threads.append(threading.Thread(
                # graftlint: thread-role=transient — scenario-scoped
                target=_replay_worker, args=(env, stop), daemon=True,
            ))
        if tr.cross_shard_transfers and scenario.topology.shards > 1:
            threads.append(threading.Thread(
                # graftlint: thread-role=transient — scenario-scoped
                target=_cx_submitter, args=(env, stop), daemon=True,
            ))
        threads.append(threading.Thread(
            # graftlint: thread-role=transient — scenario-scoped
            target=_round_collector, args=(env, stop), daemon=True,
        ))
        # the timeline rides the same joined pool: it must be DOWN
        # before teardown clears partitions and resets faultinject, or
        # a racing phase trigger could re-arm rules into the next
        # scenario of this process
        timeline = threading.Thread(
            # graftlint: thread-role=transient — scenario-scoped
            target=_timeline, args=(env, stop, t0, phases_done),
            daemon=True,
        )
        threads.append(timeline)

        for t in threads:
            t.start()
        for h in env.handles:
            if h.dark:
                continue  # late_join members pump at join time
            h.pump = h.node.run_forever(
                poll_interval=0.002,
                block_time=scenario.topology.block_time_s,
                phase_timeout=scenario.topology.phase_timeout_s,
            )
        pumps = [h.pump for h in env.handles if h.pump is not None]
        ready.set()

        deadline = t0 + scenario.window_s

        def customs_ok() -> bool:
            # scenario-specific goals gate COMPLETION too: a cross-
            # shard transfer still in flight (or an election not yet
            # persisted) must keep the run open until the window
            # expires — stopping at min_blocks alone flaked the
            # cx_arrived invariant on timing
            for _, fn in scenario.invariants.custom:
                try:
                    ok, _ = fn(env)
                except Exception:  # noqa: BLE001 — not ready yet
                    return False
                if not ok:
                    return False
            return True

        tick = 0
        while time.monotonic() < deadline:
            if env.errors:
                break  # a dead worker: stop early, report as violation
            heads_ok = all(
                h.node.chain.head_number
                >= scenario.invariants.min_blocks
                for h in env.handles
                if not h.byz and h.node is not None
            )
            tick += 1
            if (heads_ok and phases_done.is_set()
                    and len(floods_done) >= n_floods
                    and tick % 5 == 0 and customs_ok()):
                # customs polled every 5th tick: they read chain state
                # (balances, persisted elections) and need no 20 Hz
                break
            time.sleep(0.05)
    finally:
        stop.set()
        # sample fault-point hit counters BEFORE the registry reset
        fi_hits = {p: FI.hits(p) for p in fi_points}
        if env is None and built:
            env = built[0]  # _build raised partway: tear down what exists
        if env is not None:
            for t in threads:
                t.join(timeout=30)
            for h in env.handles:
                if h.node is not None:
                    h.node.stop()
            for p in pumps:
                p.join(timeout=10)
            for h in env.handles:
                # restarted nodes run on a fresh pump thread
                if h.pump is not None and h.pump not in pumps:
                    h.pump.join(timeout=10)
            # heal any leftover partition before invariant checks;
            # the conditioner's scheduler goes down WITH the net (a
            # daemon thread parked in a wait at interpreter exit is
            # the abort vector sched.reset() guards)
            env.net.partitioned.clear()
            if env.net.netem is not None:
                env.net.netem.clear()
                env.net.netem.close()
            for h in env.handles:
                for c in h.sync_clients:
                    try:
                        c.close()
                    except OSError:
                        pass
                if h.sync_server is not None:
                    h.sync_server.close()
                if h.sidecar_client is not None:
                    try:
                        h.sidecar_client.close()
                    except OSError:
                        pass
            if env.sidecar_server is not None:
                env.sidecar_server.stop()
        if gov is not None:
            from .. import governor as GV

            gov.stop()
            GV.uninstall()
        FI.reset()
        # stop the global scheduler flush thread too: a daemon thread
        # parked in a native wait at interpreter exit is the classic
        # "terminate called without an active exception" abort vector
        # for the host process (pytest or the sweep CLI); the next
        # scenario/caller re-creates it lazily
        sched.reset()
        DV.use_device(*prev_path)
        if prev_twin is None:
            os.environ.pop("HARMONY_KERNEL_TWIN", None)
        else:
            os.environ["HARMONY_KERNEL_TWIN"] = prev_twin

    run_s = time.monotonic() - t0
    sheds = _consensus_sheds() - sheds_before
    violations = _check_invariants(env, sheds)

    # evidence: exactly ONE correlated dump per violation — the kind
    # is unique per (scenario, invariant) and carries the last round's
    # trace, so trace.anomaly's dedup + cooldown make repeats no-ops
    last_trace = _last_round_trace(env)
    violation_dumps = []
    for v in violations:
        path = trace.anomaly(
            f"chaos.{scenario.name}.{v['invariant']}",
            trace_id=last_trace, detail=v["detail"],
            scenario=scenario.name, seed=scenario.seed,
        )
        v["dump"] = path
        if path:
            violation_dumps.append(path)

    # the invariants (including customs reading HL.EVENTS /
    # recovered_names) have all run: stop the watchdog daemon and
    # restore the process-global defaults NOW, not at the next run() —
    # a scenario's tightened config (0.25s sweeps, 2.5s max-age) must
    # not leak spurious stale flags into whatever the host process
    # does next, and a daemon thread parked in a native wait at
    # interpreter exit is the same abort vector sched.reset() guards
    HL.reset()

    # durable stores stay OPEN through invariant evaluation (the fork
    # and custom checks read blocks back); release them only now
    for h in env.handles:
        if h.chain is not None:
            try:
                h.chain.db.close()
            except OSError:
                pass
    data_dir = env.data.get("data_dir")
    if data_dir:
        # the on-disk evidence of a violation is the flight-recorder
        # dump, not the raw KV logs
        import shutil

        shutil.rmtree(data_dir, ignore_errors=True)

    p50, p99 = _quantiles(list(env.round_durs.values()))
    heads = {
        s: [
            h.node.chain.head_number
            for h in env.by_shard(s) if h.node is not None
        ]
        for s in range(scenario.topology.shards)
    }
    faults_fired = sum(
        fi_hits[p] - hits_before[p] for p in fi_points
    )
    metrics = {
        "blocks_min": _m(
            min(
                min(h.node.chain.head_number for h in env.honest(s))
                for s in range(scenario.topology.shards)
            ), "blocks",
            floor=scenario.invariants.min_blocks,
        ),
        "round_p99_s": _m(
            p99 and round(p99, 4), "s", bound=scenario.invariants.round_p99_s,
            rounds=len(env.round_durs),
            derived_from="tracer_spans",
        ),
        "round_p50_s": _m(
            p50 and round(p50, 4), "s", rounds=len(env.round_durs),
            derived_from="tracer_spans",
        ),
        "consensus_sheds": _m(sheds, "sheds"),
        "view_changes": _m(
            sum(h.node.view_changes for h in env.handles
                if h.node is not None), "votes",
        ),
        "new_views_adopted": _m(
            sum(h.node.new_views_adopted for h in env.handles
                if h.node is not None),
            "adoptions",
        ),
        "fault_point_hits": _m(faults_fired, "hits"),
        "run_s": _m(round(run_s, 2), "s",
                    window_s=scenario.window_s),
    }
    # per-phase round attribution: the run's spans are
    # still live in the store (reset happens at the NEXT run's start),
    # so stitch committed rounds into timelines here — a kernel or
    # aggregation change gets a before/after per phase, not just a p99
    from ..obs import build_timelines, observe_timelines

    tls = [t for t in build_timelines(trace.spans()) if t.committed]
    phase_summary = observe_timelines(tls)
    if tls:
        total_wall = sum(t.wall_s for t in tls)
        attributed = sum(sum(t.phases.values()) for t in tls)
        metrics["round_phase_attributed_ratio"] = _m(
            round(attributed / total_wall, 4) if total_wall else None,
            "ratio", rounds=len(tls), derived_from="round_timeline",
        )
        for phase, total_s in phase_summary["phase_seconds"].items():
            vals = sorted(t.phases[phase] for t in tls
                          if phase in t.phases)
            metrics[f"round_phase_{phase}_s"] = _m(
                round(vals[len(vals) // 2], 4), "s",
                rounds=len(vals), total_s=round(total_s, 3),
                derived_from="round_timeline",
            )
    # replay-stage burn-down: per-stage quantiles of THIS run's
    # observations (delta against the start-of-run snapshot)
    for stage_name, q in obs_replay.quantiles_since(replay_base).items():
        metrics[f"replay_stage_{stage_name}_s"] = _m(
            q.get("p50_s"), "s", count=q["count"],
            sum_s=q["sum_s"], p99_s=q.get("p99_s"),
            derived_from="stage_histogram",
        )
    netem = env.net.netem
    if netem is not None and netem.ever_armed:
        tot = netem.totals()
        for event in ("delayed", "dropped", "duplicated", "reordered"):
            metrics[f"netem_{event}"] = _m(
                tot.get(event, 0), "messages"
            )
    heal = env.data.get("heal_catchup_s")
    if heal:
        metrics["heal_catchup_seconds"] = _m(
            round(max(heal), 3), "s", heals=len(heal),
            derived_from="heal_to_caught_up",
        )
        metrics["heal_lag_blocks"] = _m(
            env.data.get("heal_lag", 0), "blocks",
        )
    # late-join bootstrap telemetry: any downloader that
    # installed a peer-served snapshot reports it here — the joiner's
    # meta-to-install seconds are the snapshot_bootstrap_seconds
    # yardstick
    boot_dls = []
    for h in env.handles:
        reg = getattr(h, "_registry", None)
        dl = reg.get("downloader") if reg is not None else None
        if dl is not None and getattr(dl, "snapshot_bootstraps", 0):
            boot_dls.append(dl)
    if boot_dls:
        metrics["snapshot_bootstraps"] = _m(
            sum(d.snapshot_bootstraps for d in boot_dls), "bootstraps",
        )
        metrics["snapshot_bootstrap_seconds"] = _m(
            round(max(d.last_snapshot_bootstrap_s for d in boot_dls), 3),
            "s", derived_from="meta_to_install",
            block=max(d.last_snapshot_block or 0 for d in boot_dls),
        )
    joins = env.data.get("join_catchup_s")
    if joins:
        metrics["join_catchup_seconds"] = _m(
            round(max(joins), 3), "s", joins=len(joins),
            derived_from="join_to_caught_up",
        )
        metrics["join_lag_blocks"] = _m(
            env.data.get("join_lag", 0), "blocks",
        )
    # leader-inbound accounting: the leader ingests two
    # kinds of vote-bearing traffic — leader-addressed BALLOTS (the
    # shared consensus topic delivers each to every host once, so the
    # busiest host's ballot count is the per-leader count) and
    # aggregation contributions on the leader SLOT's directed topic
    # (the ladder's hottest target).  Per-HOST aggregate totals would
    # bundle the ~50-slots-per-localnet-node intermediate rungs a
    # real committee spreads over one machine per slot, so the
    # per-slot split is read instead — THE number the Handel overlay
    # shrinks from O(N) toward O(log N)
    _hosts = [h.host for h in env.handles if h.host is not None]
    inbound_votes = max(
        (
            sum(
                v
                for (_phase, kind), v in getattr(
                    h, "inbound_votes", {}
                ).items()
                if kind == "ballot"
            )
            for h in _hosts
        ),
        default=0,
    ) + max(
        (
            c
            for h in _hosts
            for c in getattr(h, "inbound_agg_slots", {}).values()
        ),
        default=0,
    )
    if env.round_durs:
        metrics["leader_inbound_msgs_per_round"] = _m(
            round(inbound_votes / len(env.round_durs), 3), "messages",
            rounds=len(env.round_durs), total=inbound_votes,
            derived_from="host_inbound_votes",
        )
    # scenario-specific measured extras (the byzantine scenarios stash
    # their evidence-pipeline numbers here from custom invariants)
    for name, entry in (env.data.get("extra_metrics") or {}).items():
        metrics[name] = entry
    restarts = sum(h.restarts for h in env.handles)
    if restarts:
        recov = env.data.get("recovery_s", [])
        _, rec_p99 = _quantiles(recov)
        metrics["node_restarts"] = _m(restarts, "restarts",
                                      recovered=len(recov))
        metrics["restart_recovery_seconds_p99"] = _m(
            rec_p99 and round(rec_p99, 3), "s", restarts=restarts,
            derived_from="kill_to_caught_up",
        )
    return ScenarioResult(
        name=scenario.name,
        passed=not violations,
        violations=violations,
        metrics=metrics,
        violation_dumps=violation_dumps,
        all_dumps=trace.dumps(),
        heads=heads,
    )
