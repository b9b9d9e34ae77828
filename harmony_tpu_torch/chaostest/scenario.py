"""Declarative chaos scenarios: topology × traffic × faults × invariants.

The chaos framework's vocabulary.  A :class:`Scenario` composes

* a **topology** — how the in-process localnet is shaped: nodes per
  shard, shards, multi-key validators, epoch length, whether a real
  EPoS finalizer runs elections at the boundary, whether seal checks
  go through a verification sidecar;
* a **traffic profile** — the loadgen-style ingress/replay pressure
  running concurrently with the rounds: paced plain-transfer floods
  into tx-pool admission, staking submissions whose BLS
  proofs-of-possession verify on the scheduler's INGRESS lane, replay
  workers re-verifying the committed chain down the SYNC lane, and
  cross-shard transfers;
* a **fault script** — timed/round-triggered phases arming
  ``faultinject`` rules (now window-capable: ``t0``/``t1``/``when``),
  partitioning nodes out of the gossip hub ("black-hole the
  leader at round 3 for 10 s"), and — on a ``durable`` topology —
  hard-killing nodes (optionally tearing their in-flight storage
  batch first) and restarting them from disk;
* **invariants** — the machine-checked postconditions: liveness (the
  chain advances ≥ N blocks inside the window), ZERO consensus-lane
  sheds, a round-p99 bound, no divergent heads, plus scenario-specific
  custom checks (committee rotated, cross-shard value arrived, ...).

Everything here is data; ``runner.py`` executes it and ``scenarios.py``
names the scenarios.  Scenarios are seed-deterministic:
keys, fixtures and garble bytes all derive from ``Scenario.seed``
(wall-clock phase boundaries are scripted, so a run replays the same
fault SCRIPT even though thread interleavings differ).

The port's copy of the JAX package's ``chaostest/scenario.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Topology:
    """Shape of the in-process localnet."""

    nodes: int = 4             # validators per shard
    shards: int = 1
    multikey: int = 0          # first M nodes hold TWO committee keys
    # mainnet-shape committees: a non-zero committee_size
    # distributes that many committee keys round-robin across the
    # nodes (64 over 4 nodes = 16 keys/node — pushing toward the
    # reference's 200 slots/shard); overrides ``multikey``
    committee_size: int = 0
    blocks_per_epoch: int = 16
    staking: bool = False      # wire a Finalizer: real EPoS elections
    external_validators: int = 0  # staked external keys; key i rides
    #                               node i as an extra (multi-key) key
    sidecar: bool = False      # engines verify seals via a sidecar
    durable: bool = False      # per-node FileKV data dirs: nodes can be
    #                            hard-killed and reopened from disk
    block_time_s: float = 0.25
    phase_timeout_s: float = 8.0  # consensus timeout -> view change
    # ACTIVE adversaries: (node_name, "behavior[+behavior...]") pairs —
    # those nodes are built as chaostest.byzantine.ByzantineNode with
    # the named behaviors (equivocate / double_vote / invalid_proposal
    # / withhold / wire_spray).  Liveness/divergence invariants then
    # judge the HONEST nodes only; the adversary is the fault.
    byzantine: tuple = ()
    # arm a process-wide resource governor: tightened limits
    # suited to a CI-window localnet, attached to every node's pool —
    # the overload scenarios assert its tier transitions + rejections
    governor: bool = False
    # override the health watchdog's default participant max-age (and
    # tighten its check interval): the wedged-thread scenario needs
    # detection inside its fault window
    watchdog_max_age_s: float | None = None
    # late-join bootstrap: this many EXTRA nodes — named
    # ``s<shard>n<nodes+i>`` — are built DARK: a handle with keys and a
    # data dir but no gossip host, sync server, downloader or pump
    # until a Phase ``joins`` them mid-run.  A dark member holds a
    # NON-committee BLS key (deterministic from the seed), so it runs
    # as an observer once joined: it validates and follows the chain
    # but never votes — quorum arithmetic is untouched by its absence
    late_join: int = 0
    # snapshot-or-replay decision threshold wired into every node's
    # downloader: a node >= this many blocks behind the network head
    # bootstraps from a peer-served snapshot (verified against the
    # sealed state root) before tail replay.  None = always replay —
    # the default keeps every pre-existing scenario byte-identical
    snapshot_threshold: int | None = None
    # dev-genesis account scale: 0 derives the minimum (one funded
    # account per committee key, widened to 64 under an overload
    # flood); the dress rehearsal sets a mainnet-shaped allocation
    n_accounts: int = 0
    # gate the MPT root off (headers commit the flat sha3 root): the
    # only viable shape for a large-state scenario, where a
    # pure-python secure-trie seal would take minutes per block
    flat_root: bool = False
    # vote transport: "handel" routes prepare/commit votes
    # through the multi-level aggregation overlay
    # (consensus.aggregation); the "direct" default keeps every
    # pre-existing scenario's wire traffic byte-identical
    aggregation: str = "direct"


@dataclass(frozen=True)
class Traffic:
    """Concurrent load riding the scheduler lanes during the run."""

    plain_rate: float = 0.0    # paced tx/s into tx-pool admission
    pop_rate: float = 0.0      # staking BLS-POP submissions/s (INGRESS)
    replay_workers: int = 0    # chain re-verification loops (SYNC)
    cross_shard_transfers: int = 0  # shard-0 -> shard-1 transfers
    flood_duration_s: float = 6.0   # how long the paced floods run
    # overload flood: paced submission ATTEMPTS into the
    # REAL shard-0 node pools (round-robin), cycling a bounded fixture
    # — at 10x rated most attempts are rejections (floor / caps /
    # replacement), which is the point: rejected, counted, not crashed
    node_pool_rate: float = 0.0


@dataclass(frozen=True)
class Kill:
    """One hard node kill inside a phase (requires
    ``Topology(durable=True)`` — a restarted node reopens from disk).

    ``target`` uses the partition spec grammar (literal ``"s0n1"``,
    ``"leader"``, ``"round_leader[:shard]"``).  ``mode="mid_commit"``
    arms a one-shot ``kv.commit`` crash point on the target's store
    (killing its next block commit; the live commit path self-heals
    by truncating) AND stamps an un-committed batch fragment onto the
    dead node's log, so the restart genuinely exercises torn-batch
    replay discard — the worst-case kill the atomic batch layer must
    absorb; ``mode="clean"`` just kills (no flush, no close — writes
    already on disk survive, in-memory consensus state is lost).
    ``restart_after_s`` reopens the node from its data dir after the
    delay (None = stays down for the rest of the run); the runner
    measures kill-to-caught-up as ``restart_recovery_seconds``."""

    target: str
    mode: str = "clean"          # "clean" | "mid_commit"
    restart_after_s: float | None = None


@dataclass(frozen=True)
class Phase:
    """One scripted fault window.

    Triggered when the shard-0 network head reaches ``at_round`` OR
    ``at_s`` seconds elapse (whichever is given); lasts ``duration_s``
    (None = until scenario end).  ``arms`` are ``faultinject.arm``
    kwargs dicts — armed at trigger time with ``t1=duration_s`` so the
    rules expire with the window.  ``partition`` names nodes to
    black-hole out of the gossip hub for the window: literal host
    names (``"s0n1"``), ``"leader"`` (shard 0's leader at trigger
    time) or ``"leader:<shard>"``; they are healed when the window
    closes.

    ``hold_until`` makes the window's close LOAD-RELATIVE: a
    predicate ``fn(env) -> bool`` checked once
    ``duration_s`` elapses — the window stays open until it returns
    True (the fault has provably done its job, e.g. a NEWVIEW
    adopted), capped at ``hold_max_s`` after trigger so a scenario
    whose fault genuinely never bites still heals and fails its
    invariant instead of wedging the run.

    ``links`` are netem link-rule specs
    (:func:`..netem.parse_link` dict or string grammar) installed for
    the window and healed with it — per-DIRECTED-link latency /
    jitter / loss / duplication / reorder / bandwidth, with ``src`` /
    ``dst`` accepting the partition grammar (``"leader"``,
    ``"round_leader[:shard]"``, ``"*"``).  ``partition`` is now sugar
    for the special case ``loss=1.0`` in both directions.
    ``cut_sync`` additionally severs the partitioned/linked nodes'
    sync downloaders for the window (gossip partition alone leaves
    the TCP sync mesh reachable — a FULLY isolated node must not be
    able to quietly keep up through it); they are rewired at heal.
    ``measure_heal`` records, for each node the phase fully isolated,
    its blocks-behind lag at heal time (``env.data["heal_lag"]``) and
    the heal-to-caught-up seconds (``env.data["heal_catchup_s"]``,
    surfaced as the ``heal_catchup_seconds`` scenario metric).

    ``joins`` names dark ``Topology(late_join=...)`` members
    to bring online at trigger time: first wiring of the node (gossip
    host joins the hub, sync server binds, downloader built with the
    topology's ``snapshot_threshold``), pump started, and a join watch
    armed — the runner records the joiner's blocks-behind lag at join
    (``env.data["join_lag"]``) and its join-to-caught-up seconds
    (``env.data["join_catchup_s"]``, surfaced as the
    ``join_catchup_seconds`` scenario metric)."""

    name: str
    at_round: int | None = None
    at_s: float | None = None
    duration_s: float | None = None
    arms: tuple = ()
    partition: tuple = ()
    links: tuple = ()  # netem link-rule specs, healed with the window
    cut_sync: bool = False
    measure_heal: bool = False
    kills: tuple = ()  # Kill specs executed at trigger time
    joins: tuple = ()  # dark late_join member names brought online
    hold_until: object = None    # fn(env) -> bool, checked after duration_s
    hold_max_s: float = 30.0     # hard cap on a held window, from trigger


@dataclass(frozen=True)
class Invariants:
    """Machine-checked postconditions; every violation is a finding
    AND one correlated flight-recorder dump."""

    min_blocks: int = 2          # every node of every shard reaches this
    round_p99_s: float = 30.0    # committed-round p99 bound (tracer)
    zero_consensus_sheds: bool = True
    no_divergent_heads: bool = True
    min_view_changes: int = 0    # a storm scenario must actually storm
    min_epochs: int = 0          # election scenario must cross epochs
    custom: tuple = ()           # (name, fn(env) -> (ok, detail)) pairs


@dataclass(frozen=True)
class Scenario:
    name: str
    seed: int
    topology: Topology = field(default_factory=Topology)
    traffic: Traffic = field(default_factory=Traffic)
    phases: tuple = ()
    invariants: Invariants = field(default_factory=Invariants)
    window_s: float = 90.0       # hard wall for the whole run
