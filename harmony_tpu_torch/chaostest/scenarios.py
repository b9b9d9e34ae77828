"""The named adversarial scenarios: composed fault scenarios,
kill/restart-from-disk scenarios on durable topologies, byzantine
adversaries, overload and WAN/gray-failure scenarios.

Each scenario function returns a :class:`~.scenario.Scenario`;
``quick=True`` scales durations/targets down to a quick run's budget while
keeping every structural ingredient — the same topology shape, the
same fault script, the same invariants.  ``SCENARIOS`` is the sweep
registry.

Scenario × fault × invariant rationale lives in docs/ANALYSIS.md
("Scenario matrix" + "Crash-consistency invariants").

The port's copy of the JAX package's ``chaostest/scenarios.py``.
"""

from __future__ import annotations

from .scenario import Invariants, Kill, Phase, Scenario, Topology, Traffic


def _committee_rotated(env):
    """Election scenario: epoch 1's committee must differ from genesis
    and seat the staked external key."""
    chain = env.by_shard(0)[0].chain
    com1 = chain.committee_for_epoch(1)
    genesis_com = list(chain.genesis.committee)
    ext = env.ext_keys[0].pub.bytes if env.ext_keys else None
    if com1 == genesis_com:
        return False, "epoch-1 committee identical to genesis"
    if ext is not None and ext not in com1:
        return False, "staked external key missing from epoch-1 committee"
    return True, ""


def _cx_arrived(env):
    """Cross-shard scenario: the transferred value must be credited on
    shard 1 despite the partition window."""
    expected = env.data.get("cx_expected", 0)
    dest = env.data.get("cx_dest")
    if not expected or dest is None:
        return False, "no cross-shard transfers were submitted"
    best = max(
        h.node.chain.state().balance(dest) for h in env.by_shard(1)
    )
    if best < expected:
        return False, (
            f"shard-1 credit {best} < transferred {expected}"
        )
    return True, ""


def view_change_storm(quick: bool = False) -> Scenario:
    """Leader black-holed mid-round under an ingress flood: the
    committee must view-change to a live leader, keep committing, and
    the healed ex-leader must resync and rejoin.

    Timing margins are LOAD-TOLERANT by design (the quick run once
    flaked on a fully loaded box): the p99 bound covers a storm round
    that spans the black-hole window PLUS one escalated VC ladder step
    on an oversubscribed box, and the window leaves room for the post-heal resync — the
    SHARP assertions here are min_view_changes and liveness, not the
    latency of a deliberately wedged round.  The black-hole itself is
    LOAD-RELATIVE (``hold_until``): on an oversubscribed box the VC
    ladder (detect -> escalated timeouts -> M3 quorum -> NEWVIEW) can
    outlast any fixed wall-clock window, and healing early hands the
    round back to the original leader with ZERO adoptions — so the
    partition holds until one NEWVIEW has actually been adopted,
    capped so a genuinely broken VC path still heals and fails the
    invariant instead of wedging the run."""
    return Scenario(
        name="view_change_storm",
        seed=11,
        topology=Topology(
            nodes=4, block_time_s=0.2,
            phase_timeout_s=2.0 if quick else 4.0,
        ),
        traffic=Traffic(
            plain_rate=250.0 if quick else 800.0,
            pop_rate=8.0, replay_workers=1,
            flood_duration_s=5.0 if quick else 12.0,
        ),
        phases=(
            Phase(
                "blackhole-leader", at_round=2,
                duration_s=6.0 if quick else 12.0,
                partition=("round_leader",),
                hold_until=lambda env: sum(
                    h.node.new_views_adopted
                    for h in env.handles if h.node is not None
                ) >= 1,
                hold_max_s=45.0 if quick else 60.0,
            ),
        ),
        invariants=Invariants(
            min_blocks=4 if quick else 8,
            round_p99_s=45.0,
            min_view_changes=1,
        ),
        window_s=150.0 if quick else 240.0,
    )


def epoch_election_rotation(quick: bool = False) -> Scenario:
    """Epoch-boundary EPoS election + committee rotation (a staked
    external key joins a multi-key node) while replay saturates the
    SYNC lane, POP floods the INGRESS lane and the device backend
    flaps across the boundary."""
    return Scenario(
        name="epoch_election_rotation",
        seed=13,
        topology=Topology(
            nodes=4, staking=True, external_validators=1,
            blocks_per_epoch=4, block_time_s=0.2,
            phase_timeout_s=6.0 if quick else 9.0,
        ),
        traffic=Traffic(
            plain_rate=150.0 if quick else 500.0,
            pop_rate=12.0, replay_workers=2,
            flood_duration_s=6.0 if quick else 12.0,
        ),
        phases=(
            Phase(
                "device-flap-at-election", at_round=3,
                duration_s=4.0 if quick else 8.0,
                arms=(
                    {"point": "device.dispatch",
                     "exc": RuntimeError, "every": 3},
                ),
            ),
        ),
        invariants=Invariants(
            min_blocks=9 if quick else 13,
            round_p99_s=30.0,
            min_epochs=2 if quick else 3,
            custom=(("committee_rotated", _committee_rotated),),
        ),
        window_s=110.0 if quick else 220.0,
    )


def cross_shard_partition(quick: bool = False) -> Scenario:
    """Cross-shard receipt traffic while a destination-shard validator
    is partitioned and sync streams flap: the transfer must still land
    (leader-side export retries + destination CXPool dedup), both
    shards stay live, nobody forks."""
    return Scenario(
        name="cross_shard_partition",
        seed=17,
        topology=Topology(
            nodes=4, shards=2, block_time_s=0.4,
            phase_timeout_s=4.0 if quick else 6.0,
        ),
        traffic=Traffic(
            plain_rate=80.0 if quick else 300.0,
            replay_workers=1,
            cross_shard_transfers=2 if quick else 5,
            flood_duration_s=5.0 if quick else 10.0,
        ),
        phases=(
            Phase(
                "partition-dest-validator", at_round=2,
                duration_s=4.0 if quick else 8.0,
                partition=("s1n1",),
                arms=(
                    {"point": "p2p.stream",
                     "exc": ConnectionResetError, "every": 5},
                ),
            ),
        ),
        # the SHARP invariants here are cx_arrived (the transfer must
        # be included on shard 1 — ongoing destination liveness) and
        # no_divergent_heads; the block floor is deliberately modest
        # because 8 nodes + the source shard's churn share one vCPU
        # and a destination VC recovery can straddle the window tail
        invariants=Invariants(
            min_blocks=3 if quick else 6,
            round_p99_s=90.0,
            custom=(("cx_arrived", _cx_arrived),),
        ),
        window_s=150.0 if quick else 260.0,
    )


def validator_churn(quick: bool = False) -> Scenario:
    """Rolling connectivity churn across a committee with multi-key
    operators (6 keys over 4 nodes): single-slot validators drop out
    and return in sequence; the chain keeps committing at the quorum
    edge (5-of-6) and every returned node converges on one history."""
    return Scenario(
        name="validator_churn",
        seed=19,
        topology=Topology(
            nodes=4, multikey=2, block_time_s=0.25,
            phase_timeout_s=3.0 if quick else 5.0,
        ),
        traffic=Traffic(
            plain_rate=150.0 if quick else 400.0,
            pop_rate=6.0, replay_workers=1,
            flood_duration_s=5.0 if quick else 10.0,
        ),
        phases=(
            Phase(
                "churn-out-n3", at_round=1,
                duration_s=3.0 if quick else 6.0,
                partition=("s0n3",),
            ),
            Phase(
                "churn-out-n2", at_round=3,
                duration_s=3.0 if quick else 6.0,
                partition=("s0n2",),
                arms=(
                    {"point": "device.dispatch",
                     "exc": ConnectionResetError, "every": 4},
                ),
            ),
        ),
        invariants=Invariants(
            min_blocks=5 if quick else 9,
            round_p99_s=25.0,
        ),
        window_s=100.0 if quick else 200.0,
    )


def sidecar_flap(quick: bool = False) -> Scenario:
    """Sidecar-backed seal verification flapping during quorum
    assembly: slow calls and injected stream desyncs force reconnect +
    committee replay mid-round while replay traffic rides the same
    sidecar — rounds must keep finalizing with zero consensus sheds."""
    return Scenario(
        name="sidecar_flap",
        seed=23,
        topology=Topology(
            nodes=4, sidecar=True, block_time_s=0.25,
            phase_timeout_s=5.0 if quick else 8.0,
        ),
        traffic=Traffic(
            pop_rate=8.0, replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        phases=(
            Phase(
                "sidecar-flap", at_round=1,
                duration_s=6.0 if quick else 12.0,
                arms=(
                    {"point": "sidecar.call",
                     "delay_s": 0.05, "every": 2},
                    {"point": "sidecar.frame",
                     "exc": ValueError, "every": 9, "times": 2},
                ),
            ),
        ),
        invariants=Invariants(
            min_blocks=4 if quick else 8,
            round_p99_s=30.0,
        ),
        window_s=100.0 if quick else 200.0,
    )


def _kills_recovered(env):
    """Restart scenarios: every scripted kill with a restart must have
    actually restarted AND caught back up to the network head (the
    runner measures kill-to-caught-up per restart)."""
    planned = sum(
        1 for p in env.scenario.phases for k in p.kills
        if k.restart_after_s is not None
    )
    restarts = sum(h.restarts for h in env.handles)
    recovered = len(env.data.get("recovery_s", []))
    if restarts < planned:
        return False, f"only {restarts}/{planned} kills restarted"
    if recovered < planned:
        return False, (
            f"{recovered}/{planned} restarted nodes caught up to the "
            "network head"
        )
    return True, ""


def _no_double_sign(env):
    """A restarted validator must never emit a conflicting vote: the
    leaders' equivocation detectors (Node._check_double_sign) must
    have collected ZERO evidence records across the run — including
    evidence held by nodes that were themselves killed later (the
    runner snapshots it into env.data at kill time)."""
    evidence = sum(
        len(h.node.pending_double_signs)
        for h in env.handles if h.node is not None
    ) + len(env.data.get("double_signs", []))
    if evidence:
        return False, (
            f"{evidence} double-sign evidence record(s) collected by "
            "round leaders"
        )
    return True, ""


def leader_kill_restart(quick: bool = False) -> Scenario:
    """The production fault class no scenario had ever exercised: the
    round leader hard-killed MID-COMMIT (its in-flight storage batch
    torn at a kv.commit crash point) on a durable topology, then
    restarted from disk.  The committee must view-change past the
    dead leader and keep committing; the restarted node must reopen
    its FileKV (replay discards the torn batch), recover a consistent
    head, rejoin via the sync mesh, catch up — and, with its durable
    last-signed-view state, never emit a conflicting vote for the
    round it died in."""
    return Scenario(
        name="leader_kill_restart",
        seed=29,
        topology=Topology(
            nodes=4, durable=True, block_time_s=0.2,
            phase_timeout_s=2.0 if quick else 4.0,
        ),
        traffic=Traffic(
            plain_rate=150.0 if quick else 500.0,
            pop_rate=6.0, replay_workers=1,
            flood_duration_s=5.0 if quick else 10.0,
        ),
        phases=(
            Phase(
                "kill-leader-mid-commit", at_round=2,
                duration_s=1.0,  # kills manage their own lifecycle;
                # a finite window lets the run complete the moment the
                # restart recovers instead of idling out the scenario
                kills=(
                    Kill("round_leader", mode="mid_commit",
                         restart_after_s=4.0 if quick else 8.0),
                ),
            ),
        ),
        # the SHARP invariants are kills_recovered + no_double_sign +
        # no_divergent_heads: a kill/restart scenario's worst committed
        # round SPANS the kill -> view-change-storm -> recovery window
        # by design, and with few rounds p99 = max — so the latency
        # bound only guards against a full wedge
        invariants=Invariants(
            min_blocks=4 if quick else 8,
            round_p99_s=90.0,
            min_view_changes=1,
            custom=(
                ("kills_recovered", _kills_recovered),
                ("no_double_sign", _no_double_sign),
            ),
        ),
        window_s=110.0 if quick else 220.0,
    )


def rolling_restart(quick: bool = False) -> Scenario:
    """Rolling restarts of EVERY validator under sustained load (the
    operator's routine upgrade path): one node at a time is hard-
    killed and reopened from its data dir while floods + replay ride
    the lanes.  The committee never loses quorum (3-of-4 stays live),
    every restarted node recovers from disk and catches up, heads
    never diverge, and kill-to-caught-up p99 is reported as
    restart_recovery_seconds_p99."""
    restart_s = 2.0 if quick else 4.0
    return Scenario(
        name="rolling_restart",
        seed=31,
        topology=Topology(
            nodes=4, durable=True, block_time_s=0.25,
            # short VC timeout: each kill wedges the rounds whose
            # leader slot the dead node holds, and the wedge cost is
            # the escalating vc_timeout ladder — a tight base keeps
            # four consecutive wedges inside the window
            phase_timeout_s=2.0 if quick else 4.0,
        ),
        traffic=Traffic(
            plain_rate=150.0 if quick else 400.0,
            replay_workers=1,
            flood_duration_s=6.0 if quick else 12.0,
        ),
        # kills at rounds 1/3/5/7: the floor sits ABOVE the last kill
        # round, so passing proves the committee kept committing
        # through (and after) the full rolling cycle — and the tail of
        # the window belongs to the final recovery, not a fresh wedge
        phases=tuple(
            Phase(
                f"restart-n{3 - i}", at_round=1 + 2 * i,
                duration_s=1.0,  # see leader_kill_restart: kill tasks
                # outlive the phase window by design
                kills=(
                    Kill(f"s0n{3 - i}", restart_after_s=restart_s),
                ),
            )
            for i in range(4)
        ),
        # same p99 rationale as leader_kill_restart: rounds spanning a
        # kill window dominate a small-sample p99.  The window is
        # sized for the UNLUCKY interleaving (every kill landing on
        # the upcoming leader slot): the run completes early the
        # moment all floors + customs hold, so the slack only costs
        # wall-clock when it is actually needed
        invariants=Invariants(
            min_blocks=8 if quick else 12,
            round_p99_s=90.0,
            custom=(
                ("kills_recovered", _kills_recovered),
                ("no_double_sign", _no_double_sign),
            ),
        ),
        window_s=300.0 if quick else 480.0,
    )


# -- byzantine scenarios: ACTIVE adversaries ----------------------


def _byz_handles(env):
    return [h for h in env.handles if h.byz]


def _m(value, unit, **fields):
    from .runner import _m as m

    return m(value, unit, **fields)


def _byz_equivocation_survived(env):
    """The adversary must have actually equivocated (and withheld), and
    the honest committee must have stormed past its wedged rounds."""
    byz = _byz_handles(env)
    if not byz:
        return False, "no byzantine node was built"
    acts = byz[0].node.byz_actions
    if acts["equivocate"] < 2:
        # the orders alternate: the FIRST equivocation (twin second)
        # is absorbed by first-announce-wins, the SECOND (twin first)
        # splits the committee from the leader and wedges the round —
        # the run must stay open until both postures happened
        return False, (
            f"only {acts['equivocate']} equivocations (need both "
            "delivery postures)"
        )
    if acts["withhold"] < 1:
        return False, "the adversary never withheld a vote"
    if sum(h.node.new_views_adopted for h in env.honest(0)) < 1:
        return False, "the wedged round never view-changed"
    env.data.setdefault("extra_metrics", {}).update({
        "byz_equivocations": _m(acts["equivocate"], "announces"),
        "byz_votes_withheld": _m(acts["withhold"], "votes"),
    })
    return True, ""


def _byz_evidence_applied(env):
    """The whole slashing pipeline, end to end: the double vote was
    cast, DETECTED by an honest leader, block-INCLUDED (some honest
    header carries slash records), re-verified and APPLIED — offender's
    stake measurably reduced, reporter's balance measurably credited,
    offender banned and excluded from the next election."""
    from ..staking import slash as SL

    byz = _byz_handles(env)
    if not byz:
        return False, "no byzantine node was built"
    if byz[0].node.byz_actions["double_vote"] < 1:
        return False, "the adversary never double-voted"
    honest = env.honest(0)
    detected = sum(h.node.double_sign_events for h in honest)
    if detected < 1:
        return False, "no honest leader detected the double vote"
    offender = env.ecdsa_keys[0].address()  # the ext validator's staker
    chain = honest[0].node.chain
    w = chain.state().validator(offender)
    if w is None:
        return False, "external validator never registered"
    if w.status != 2:
        return False, "offender not banned (evidence never applied)"
    stake0 = 10**20  # fixtures.external_validator_stake amount
    slashed = stake0 - w.total_delegation()
    if slashed <= 0:
        return False, "offender stake not reduced"
    included_at = None
    reporter = None
    for n in range(1, chain.head_number + 1):
        hdr = chain.header_by_number(n)
        if hdr is not None and hdr.slashes:
            included_at = n
            reporter = SL.decode_records(hdr.slashes)[0].reporter
            break
    if included_at is None:
        return False, "no committed block carried a slash record"
    # the reporter is a dev-genesis account (alloc 10**24); gas spend
    # is ~1e5 atto while the reward is 1e18 — a credited reporter sits
    # measurably ABOVE its allocation
    reward_floor = 10**24 + 10**17
    if chain.state().balance(reporter) < reward_floor:
        return False, "reporter balance shows no slash reward"
    # the election AFTER the ban must drop the offender's key
    ext = env.ext_keys[0].pub.bytes
    top_epoch = chain.epoch_of(chain.head_number)
    if ext in chain.committee_for_epoch(top_epoch):
        return False, (
            f"slashed key still elected at epoch {top_epoch}"
        )
    env.data.setdefault("extra_metrics", {}).update({
        "byz_double_votes": _m(
            byz[0].node.byz_actions["double_vote"], "votes"
        ),
        "byz_evidence_detected": _m(detected, "records"),
        "byz_evidence_included_block": _m(included_at, "block"),
        "byz_offender_stake_slashed_atto": _m(slashed, "atto"),
        "byz_evidence_applied": _m(1, "records"),
    })
    return True, ""


def _byz_spray_defended(env):
    """The hostile-wire defense must have engaged: honest validators
    REJECTed the sprayed garbage (scored, throttled) and the hub
    ultimately muted the adversary — while every honest node kept
    committing (the liveness floor checks that part)."""
    byz = _byz_handles(env)
    if not byz:
        return False, "no byzantine node was built"
    acts = byz[0].node.byz_actions
    if acts["invalid_proposal"] < 1:
        return False, "the adversary never proposed an invalid block"
    if acts["wire_spray"] < 10:
        return False, f"only {acts['wire_spray']} wires sprayed"
    if env.net.invalid_total < 10:
        return False, (
            f"only {env.net.invalid_total} invalid-message verdicts "
            "observed (the spray was not rejected)"
        )
    if byz[0].name not in env.net.muted:
        return False, "the spraying peer was never muted"
    if sum(h.node.new_views_adopted for h in env.honest(0)) < 1:
        # the muted adversary's garbage (or silent) round must have
        # been routed around by a completed view change at least once
        return False, "no honest view change routed around the sprayer"
    env.data.setdefault("extra_metrics", {}).update({
        "byz_invalid_proposals": _m(acts["invalid_proposal"],
                                    "announces"),
        "byz_wires_sprayed": _m(acts["wire_spray"], "frames"),
        "byz_invalid_verdicts": _m(env.net.invalid_total, "rejects"),
        "byz_peers_muted": _m(len(env.net.muted), "peers"),
    })
    return True, ""


def byz_equivocating_leader(quick: bool = False) -> Scenario:
    """An ACTIVE adversary holding one of six committee keys
    equivocates whenever it leads (conflicting ANNOUNCEs for the same
    height/view — alternating delivery order, so half its rounds wedge
    into real view changes) and withholds its votes otherwise (the
    quorum-edge coalition: 5-of-6 keys must still commit).  Honest
    nodes must keep committing on ONE history."""
    return Scenario(
        name="byz_equivocating_leader",
        seed=37,
        topology=Topology(
            nodes=4, multikey=2, block_time_s=0.2,
            phase_timeout_s=2.0 if quick else 4.0,
            byzantine=(("s0n3", "equivocate+withhold"),),
        ),
        traffic=Traffic(
            plain_rate=100.0 if quick else 300.0,
            replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        invariants=Invariants(
            min_blocks=5 if quick else 9,
            round_p99_s=30.0,
            min_view_changes=1,
            custom=(
                ("byz_equivocation_survived",
                 _byz_equivocation_survived),
            ),
        ),
        window_s=110.0 if quick else 220.0,
    )


def byz_double_voter_slashed(quick: bool = False) -> Scenario:
    """The end-to-end slashing acceptance: a staked external validator
    (riding the byzantine node as a multi-key slot) double-votes in the
    commit phase every round once elected.  An honest leader must
    detect it, gossip + include the evidence in a proposal, every
    validator must re-verify it before voting, and finalization must
    apply it — offender slashed and banned, reporter rewarded, the
    slashed key excluded from the next election — while the committee
    (f=1 of 7 keys) keeps committing."""
    return Scenario(
        name="byz_double_voter_slashed",
        seed=41,
        topology=Topology(
            nodes=4, multikey=2, staking=True, external_validators=1,
            blocks_per_epoch=4, block_time_s=0.25,
            phase_timeout_s=6.0 if quick else 9.0,
            byzantine=(("s0n0", "double_vote"),),
        ),
        traffic=Traffic(
            plain_rate=80.0 if quick else 250.0,
            pop_rate=6.0, replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        invariants=Invariants(
            min_blocks=10 if quick else 14,
            round_p99_s=30.0,
            min_epochs=2 if quick else 3,
            custom=(
                ("byz_evidence_applied", _byz_evidence_applied),
            ),
        ),
        window_s=130.0 if quick else 260.0,
    )


def byz_invalid_proposal_flood(quick: bool = False) -> Scenario:
    """An adversary that proposes only invalid blocks (rotating bad
    state root / forged parent seal / wrong view / garbage slash
    payload) AND sprays malformed wires at the consensus + slash
    topics.  Honest validators must reject every proposal (losing only
    the adversary's own rounds to view changes), survive every
    malformed frame, and score-throttle-mute the spraying peer."""
    return Scenario(
        name="byz_invalid_proposal_flood",
        seed=43,
        topology=Topology(
            # f=1 key of 6: once the hub
            # mutes the sprayer, its leader slot is a PERMANENT dead
            # view — 1-in-6 rounds must view-change past it forever,
            # so the committee tolerates the hole, not a window
            nodes=4, multikey=2, block_time_s=0.2,
            phase_timeout_s=3.0 if quick else 5.0,
            byzantine=(("s0n3", "invalid_proposal+wire_spray"),),
        ),
        traffic=Traffic(
            plain_rate=100.0 if quick else 300.0,
            replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        # the p99 bound is storm-shaped, not commit-shaped: a round
        # whose initial views land on the muted adversary's slot SPANS
        # the escalating view-change ladder by design (same rationale
        # as leader_kill_restart) — the bound guards against a wedge
        invariants=Invariants(
            min_blocks=4 if quick else 8,
            round_p99_s=90.0,
            min_view_changes=1,
            custom=(
                ("byz_spray_defended", _byz_spray_defended),
            ),
        ),
        window_s=130.0 if quick else 260.0,
    )


# -- WAN / gray-failure scenarios: netem-conditioned links --------


def _handle_named(env, name: str):
    return next(h for h in env.handles if h.name == name)


def _adoptions(env):
    return sum(
        h.node.new_views_adopted
        for h in env.handles if h.node is not None
    )


def _no_wedge(env):
    """Gray leader: the committee must make progress THROUGH the
    degraded window — blocks committed while the rules were live, or a
    NEWVIEW routed around the gray leader.  A window that produced
    neither is the wedge this scenario exists to catch (a
    slow-but-not-dead leader is invisible to every binary fault)."""
    ph = env.data.get("phase_heads", {}).get("gray-leader")
    if ph is None:
        return False, "the gray-leader phase never armed"
    if ph[1] is None:
        return False, "the gray-leader phase never healed"
    committed = ph[1] - ph[0]
    adoptions = _adoptions(env)
    if committed < 1 and adoptions < 1:
        return False, (
            "WEDGE: zero blocks committed and zero NEWVIEW adoptions "
            "across the degraded window"
        )
    tot = env.net.netem.totals()
    if tot.get("delayed", 0) < 10:
        return False, (
            f"only {tot.get('delayed', 0)} messages conditioned — the "
            "gray links never engaged"
        )
    env.data.setdefault("extra_metrics", {}).update({
        "gray_window_blocks": _m(committed, "blocks"),
        "gray_window_adoptions": _m(adoptions, "adoptions"),
    })
    return True, ""


def gray_leader(quick: bool = False) -> Scenario:
    """The canonical gray failure: the round leader's links (BOTH
    directions) degraded to 300 ms base latency + jitter + 5 % loss —
    slow-but-not-dead, the failure mode no binary partition can
    express.  Rounds must either commit within the latency-inflated
    bound or view-change around the gray leader; never wedge, never
    fork, never shed consensus work."""
    return Scenario(
        name="gray_leader",
        seed=59,
        topology=Topology(
            nodes=4, block_time_s=0.25,
            phase_timeout_s=2.5 if quick else 4.0,
        ),
        traffic=Traffic(
            plain_rate=100.0 if quick else 300.0,
            replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        phases=(
            Phase(
                "gray-leader", at_round=2,
                duration_s=8.0 if quick else 16.0,
                links=(
                    {"src": "round_leader", "dst": "*",
                     "delay_ms": 300.0, "jitter_ms": 80.0,
                     "loss": 0.05},
                    {"src": "*", "dst": "round_leader",
                     "delay_ms": 300.0, "jitter_ms": 80.0,
                     "loss": 0.05},
                ),
            ),
        ),
        # p99 is gray-shaped: a round spanning the degraded window
        # carries 2-3 conditioned RTTs plus possible VC ladder steps —
        # the SHARP assertions are no_wedge + liveness + no fork
        invariants=Invariants(
            min_blocks=5 if quick else 9,
            round_p99_s=60.0,
            custom=(("no_wedge", _no_wedge),),
        ),
        window_s=120.0 if quick else 240.0,
    )


def _asymmetric_defended(env):
    """Half-duplex leader: inbound traffic to the leader was actually
    dropped, and the committee assembled a NEWVIEW WITHOUT the
    leader's cooperation (its VC vote and its collector are both
    unreachable — the quorum must form among the others)."""
    ph = env.data.get("phase_heads", {}).get("deaf-leader")
    if ph is None:
        return False, "the deaf-leader phase never armed"
    if ph[1] is None:
        return False, "the deaf-leader phase never healed"
    tot = env.net.netem.totals()
    if tot.get("dropped", 0) < 1:
        return False, "no inbound message was ever dropped"
    adoptions = _adoptions(env)
    if adoptions < 1:
        return False, (
            "no NEWVIEW assembled without the deaf leader's "
            "cooperation"
        )
    env.data.setdefault("extra_metrics", {}).update({
        "asym_inbound_dropped": _m(tot["dropped"], "messages"),
        "asym_adoptions": _m(adoptions, "adoptions"),
    })
    return True, ""


def asymmetric_partition(quick: bool = False) -> Scenario:
    """The classic half-duplex failure: the round leader SENDS fine
    but cannot RECEIVE (every link INTO it is total loss; its outbound
    links are untouched).  Validators get the ANNOUNCE, send votes the
    leader never hears, time out, and must assemble a NEWVIEW without
    the leader's cooperation — then the healed leader resyncs and
    rejoins.  Asymmetric rules are first-class: A->B and B->A
    condition independently."""
    return Scenario(
        name="asymmetric_partition",
        seed=61,
        topology=Topology(
            nodes=4, block_time_s=0.2,
            phase_timeout_s=2.0 if quick else 4.0,
        ),
        traffic=Traffic(
            plain_rate=100.0 if quick else 300.0,
            replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        phases=(
            Phase(
                "deaf-leader", at_round=2,
                duration_s=6.0 if quick else 12.0,
                links=(
                    {"src": "*", "dst": "round_leader", "loss": 1.0},
                ),
                # load-relative close (the storm's rationale): healing
                # before the VC ladder completes hands the round back
                # to the once-deaf leader with zero adoptions
                hold_until=lambda env: _adoptions(env) >= 1,
                hold_max_s=45.0 if quick else 60.0,
            ),
        ),
        invariants=Invariants(
            min_blocks=4 if quick else 8,
            round_p99_s=60.0,
            min_view_changes=1,
            custom=(
                ("asymmetric_defended", _asymmetric_defended),
            ),
        ),
        window_s=150.0 if quick else 240.0,
    )


def _minority_healed(env):
    """Partition heal: the isolated validator must have genuinely
    fallen >= 8 blocks behind (full isolation: gossip AND sync both
    cut) and, once healed, caught back up to the live head through
    the staged sync path while the chain kept advancing — measured as
    ``heal_catchup_seconds`` (the runner's heal watch)."""
    lag = env.data.get("heal_lag", 0)
    if lag < 8:
        return False, (
            f"isolated node was only {lag} blocks behind at heal "
            "(need >= 8: the partition never genuinely isolated it)"
        )
    heals = env.data.get("heal_catchup_s") or []
    if not heals:
        return False, "the healed node never caught back up"
    synced = _handle_named(env, "s0n3").node.sync_spinups
    if synced < 1:
        return False, (
            "the healed node never span up its downloader — it did "
            "not catch up through the sync path"
        )
    return True, ""


def minority_partition_heal(quick: bool = False) -> Scenario:
    """One validator FULLY cut off under load — gossip black-holed
    via loss=1.0 link rules AND its sync downloader severed (gossip
    partition alone leaves the TCP sync mesh reachable, so the
    'isolated' node would quietly keep up) — until it is >= 8 blocks
    behind, then healed.  The committee keeps committing throughout;
    the healed node must catch up through sync/staged.py within a
    measured ``heal_catchup_seconds`` bound with zero divergent
    heads.  The isolate is the SINGLE-slot node of a 7-key committee
    (committee_size=7 over 4 nodes: spans 2/2/2/1): 6 live keys
    against a quorum bar of 5 (2n/3+1) leaves ONE key of slack, so a
    straggling vote cannot wedge the survivors — the first two cuts
    of this scenario ran the live committee at the EXACT quorum edge
    (3-of-4 and 5-of-6) and a single de-synced validator wedged
    block production for most of the hold window, so the >= 8-block
    lag never accumulated.  A long member outage needs quorum slack;
    the exact-edge shapes belong to the churn/byzantine scenarios
    whose fault windows are adoption-relative, not lag-relative."""
    return Scenario(
        name="minority_partition_heal",
        seed=67,
        topology=Topology(
            nodes=4, committee_size=7, block_time_s=0.2,
            phase_timeout_s=2.0 if quick else 4.0,
        ),
        traffic=Traffic(
            plain_rate=120.0 if quick else 400.0,
            replay_workers=1,
            flood_duration_s=5.0 if quick else 10.0,
        ),
        phases=(
            Phase(
                "isolate-s0n3", at_round=2,
                duration_s=5.0 if quick else 10.0,
                partition=("s0n3",),
                cut_sync=True,
                measure_heal=True,
                # the window is LAG-relative, not wall-clock: it holds
                # until the isolate is genuinely >= 8 blocks behind the
                # committee (a loaded box commits slower, and healing
                # at a 3-block lag would test nothing)
                hold_until=lambda env: (
                    env.shard_head(0)
                    - _handle_named(env, "s0n3").chain.head_number
                    >= 8
                ),
                hold_max_s=100.0 if quick else 150.0,
            ),
        ),
        # p99 is wedge-ladder-shaped: the isolate's leader views run
        # the escalating VC ladder by design — SHARP assertions are
        # the heal arc (lag >= 8, catch-up via sync, measured
        # catch-up seconds), liveness and no_divergent_heads
        invariants=Invariants(
            min_blocks=10 if quick else 14,
            round_p99_s=90.0,
            custom=(("minority_healed", _minority_healed),),
        ),
        window_s=220.0 if quick else 360.0,
    )


def _wan_committee_live(env):
    """The mainnet-shape acceptance: the LIVE committee must carry
    >= 64 slots (the largest this repo has ever run), the WAN matrix
    must have actually conditioned traffic, and every node must hold
    its share of the multi-key slots."""
    chain = env.honest(0)[0].chain
    epoch = chain.epoch_of(chain.head_number)
    slots = len(chain.committee_for_epoch(epoch))
    if slots < 64:
        return False, f"live committee carries {slots} slots (< 64)"
    per_node = [
        len(h.node.keys) for h in env.honest(0) if h.node is not None
    ]
    if min(per_node) < 64 // len(env.honest(0)):
        return False, f"unbalanced multi-key spans {per_node}"
    tot = env.net.netem.totals()
    if tot.get("delayed", 0) < 50:
        return False, (
            f"only {tot.get('delayed', 0)} messages rode the WAN "
            "matrix — the conditioner never engaged"
        )
    env.data.setdefault("extra_metrics", {}).update({
        "wan_committee_slots": _m(slots, "slots"),
        "wan_delayed_messages": _m(tot["delayed"], "messages"),
    })
    return True, ""


def wan_committee(quick: bool = False) -> Scenario:
    """The first mainnet-shaped chaos run: a 4-node localnet whose
    nodes are 16-key operators carrying a 64-slot committee (pushing
    toward the reference's 200 slots/shard) under a WAN latency
    matrix — every directed pair draws a stable RTT from 50–150 ms
    (seed-keyed), 10 ms jitter, 0.5 % loss.  Liveness, round p99 and
    zero consensus-lane sheds must hold with every quorum proof
    aggregating 64 slots over conditioned links; the round p99 is
    the WAN-committee yardstick
    (arXiv:2302.00418: committee consensus latency is dominated by
    exactly this matrix)."""
    return Scenario(
        name="wan_committee",
        seed=71,
        topology=Topology(
            nodes=4, committee_size=64, block_time_s=0.5,
            phase_timeout_s=8.0 if quick else 12.0,
        ),
        traffic=Traffic(
            plain_rate=60.0 if quick else 200.0,
            pop_rate=4.0, replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        phases=(
            Phase(
                "wan-matrix", at_s=0.0, duration_s=None,
                # the whole run rides the matrix (duration None =
                # until scenario end); the string grammar is the
                # operator-facing spec, exercised here on purpose
                links=("*->* rtt=50..150ms jitter=10ms loss=0.5%",),
            ),
        ),
        invariants=Invariants(
            min_blocks=3 if quick else 6,
            round_p99_s=45.0,
            custom=(("wan_committee_live", _wan_committee_live),),
        ),
        window_s=150.0 if quick else 280.0,
    )


def _leader_inbound_per_round(env):
    """The rotating leaders' vote ingest per committed round.

    The leader receives exactly two kinds of vote-bearing traffic:
    direct/fallback BALLOTS (leader-addressed; they ride the shared
    consensus topic, so the busiest host's ballot count IS the
    per-leader count, every host hears each one once) and
    AGGREGATION contributions landing on the leader slot's directed
    topic — the ladder's convergence point, the hottest slot in the
    overlay.  A localnet host multiplexes ~50 committee slots, so
    per-HOST aggregate totals bundle intermediate-rung traffic a
    real committee spreads over one machine per slot; the per-slot
    split (``Host.inbound_agg_slots``) reads off the leader slot's
    actual ingest instead."""
    hosts = [h.host for h in env.handles if h.host is not None]
    ballots = max(
        (
            sum(
                v
                for (_phase, kind), v in getattr(
                    h, "inbound_votes", {}
                ).items()
                if kind == "ballot"
            )
            for h in hosts
        ),
        default=0,
    )
    agg_hot = max(
        (
            c
            for h in hosts
            for c in getattr(h, "inbound_agg_slots", {}).values()
        ),
        default=0,
    )
    rounds = len(env.round_durs)
    return ballots + agg_hot, rounds


def _wan200_overlay_quorum(env):
    """Acceptance: the live committee carries >= 200 slots
    (the reference's mainnet shard shape), quorum was assembled
    THROUGH the aggregation overlay (contributions merged, zero
    forged partials accepted), the WAN matrix actually conditioned
    traffic — and the rotating leaders' inbound vote traffic averaged
    <= committee_size/4 messages per committed round, the O(log N)
    assembly bound the overlay exists to buy (direct assembly would
    ingest ~N ballots per round)."""
    chain = env.honest(0)[0].chain
    epoch = chain.epoch_of(chain.head_number)
    slots = len(chain.committee_for_epoch(epoch))
    if slots < 200:
        return False, f"live committee carries {slots} slots (< 200)"
    stats = [
        h.node.aggregation_stats()
        for h in env.honest(0) if h.node is not None
    ]
    merged = sum(s["merged"] for s in stats)
    emissions = sum(s["emissions"] for s in stats)
    forged = sum(s["forged"] for s in stats)
    if merged < 1 or emissions < 1:
        return False, (
            f"overlay never engaged (merged={merged}, "
            f"emissions={emissions}) — votes took the direct path"
        )
    if forged:
        return False, f"{forged} forged partial(s) survived verification"
    tot = env.net.netem.totals()
    if tot.get("delayed", 0) < 50:
        return False, (
            f"only {tot.get('delayed', 0)} messages rode the WAN "
            "matrix — the conditioner never engaged"
        )
    inbound, rounds = _leader_inbound_per_round(env)
    if rounds < 1:
        return False, "no committed rounds were measured"
    per_round = inbound / rounds
    bound = slots / 4.0
    if per_round > bound:
        return False, (
            f"leader inbound {per_round:.1f} vote msgs/round exceeds "
            f"{bound:.0f} (= committee_size/4) — the overlay did not "
            "compress quorum assembly"
        )
    env.data.setdefault("extra_metrics", {}).update({
        "wan200_committee_slots": _m(slots, "slots"),
        "wan200_overlay_merged": _m(merged, "contributions"),
        "wan200_overlay_fallbacks": _m(
            sum(s["fallbacks"] for s in stats), "ballots"
        ),
        "wan200_leader_inbound_bound": _m(round(bound, 1), "messages"),
    })
    return True, ""


def wan_committee_200(quick: bool = False) -> Scenario:
    """The gating scenario: a LIVE 200-slot committee — the
    reference's mainnet shard shape, 50-key operators on a 4-node
    localnet — committing under the WAN latency matrix with
    prepare/commit votes routed through the Handel-style aggregation
    overlay.  Liveness, zero consensus-lane sheds and the round p99
    bound must hold while the rotating leaders ingest at most
    committee_size/4 vote-bearing messages per committed round
    (``leader_inbound_msgs_per_round`` is the overlay yardstick; ``wan_committee`` seed 71 is the 64-slot
    direct-path baseline)."""
    return Scenario(
        name="wan_committee_200",
        seed=79,
        # a 200-slot round costs ~5 s announce-to-vote per node on a
        # shared box (block verify + 50-key signing) before the WAN
        # RTTs stack on top: the phase timeout must clear a full
        # assemble-twice (prepare + commit) arc or every view wedges
        # into a VC storm before quorum can form
        topology=Topology(
            nodes=4, committee_size=200, block_time_s=1.0,
            phase_timeout_s=20.0 if quick else 25.0,
            aggregation="handel",
        ),
        traffic=Traffic(
            # light tx pressure only: this scenario measures VOTE
            # compression, and on a shared box heavy adversarial
            # traffic just starves the 200-slot crypto of CPU
            plain_rate=10.0 if quick else 60.0,
            pop_rate=1.0, replay_workers=1,
            flood_duration_s=2.0 if quick else 6.0,
        ),
        phases=(
            Phase(
                "wan-matrix", at_s=0.0, duration_s=None,
                links=("*->* rtt=50..150ms jitter=10ms loss=0.5%",),
            ),
        ),
        # p99 is 200-slot-shaped: every quorum proof aggregates 200
        # keys over conditioned links — the SHARP assertions are the
        # overlay custom (inbound compression + zero forged) plus
        # liveness and zero consensus sheds
        invariants=Invariants(
            min_blocks=3 if quick else 6,
            round_p99_s=90.0,
            custom=(("wan200_overlay_quorum", _wan200_overlay_quorum),),
        ),
        window_s=260.0 if quick else 420.0,
    )


def _gray_overlay_survived(env):
    """Gray aggregator: the overlay must have been exercised, and the
    committee must have made progress THROUGH the degraded window —
    either the ladder kept assembling despite the gray links, or the
    stall fallback shipped direct ballots (the loss-safety escape
    hatch), or a NEWVIEW routed around the gray leader.  A window
    with none of those is the wedge a degraded aggregator could
    newly introduce."""
    ph = env.data.get("phase_heads", {}).get("gray-aggregator")
    if ph is None:
        return False, "the gray-aggregator phase never armed"
    if ph[1] is None:
        return False, "the gray-aggregator phase never healed"
    stats = [
        h.node.aggregation_stats()
        for h in env.honest(0) if h.node is not None
    ]
    merged = sum(s["merged"] for s in stats)
    fallbacks = sum(s["fallbacks"] for s in stats)
    if merged < 1:
        return False, "overlay never engaged (zero merged contributions)"
    committed = ph[1] - ph[0]
    adoptions = _adoptions(env)
    if committed < 1 and fallbacks < 1 and adoptions < 1:
        return False, (
            "WEDGE: zero blocks, zero direct-ballot fallbacks and "
            "zero NEWVIEW adoptions across the degraded window"
        )
    tot = env.net.netem.totals()
    if tot.get("delayed", 0) < 10:
        return False, (
            f"only {tot.get('delayed', 0)} messages conditioned — the "
            "gray links never engaged"
        )
    env.data.setdefault("extra_metrics", {}).update({
        "gray_agg_window_blocks": _m(committed, "blocks"),
        "gray_agg_fallbacks": _m(fallbacks, "ballots"),
        "gray_agg_merged": _m(merged, "contributions"),
    })
    return True, ""


def gray_aggregator(quick: bool = False) -> Scenario:
    """The overlay's gray-failure variant (loss safety): the
    round leader — the ladder's FINAL aggregator, where every
    last-rung contribution lands — degraded to 300 ms + jitter + 5 %
    loss in both directions while votes ride the Handel overlay.
    Rounds must keep committing (re-emission absorbs the loss), or
    stalled phases must take the direct-to-leader fallback, or the
    committee must view-change past the gray leader; never wedge,
    never fork, zero consensus sheds."""
    return Scenario(
        name="gray_aggregator",
        seed=83,
        topology=Topology(
            nodes=4, committee_size=16, block_time_s=0.25,
            phase_timeout_s=2.5 if quick else 4.0,
            aggregation="handel",
        ),
        traffic=Traffic(
            plain_rate=100.0 if quick else 300.0,
            replay_workers=1,
            flood_duration_s=4.0 if quick else 8.0,
        ),
        phases=(
            Phase(
                "gray-aggregator", at_round=2,
                duration_s=8.0 if quick else 16.0,
                links=(
                    {"src": "round_leader", "dst": "*",
                     "delay_ms": 300.0, "jitter_ms": 80.0,
                     "loss": 0.05},
                    {"src": "*", "dst": "round_leader",
                     "delay_ms": 300.0, "jitter_ms": 80.0,
                     "loss": 0.05},
                ),
            ),
        ),
        # same gray-shaped p99 rationale as gray_leader: the SHARP
        # assertions are overlay survival + liveness + no fork
        invariants=Invariants(
            min_blocks=5 if quick else 9,
            round_p99_s=60.0,
            custom=(("gray_overlay_survived", _gray_overlay_survived),),
        ),
        window_s=120.0 if quick else 240.0,
    )


# -- overload scenarios: past rated capacity ----------------------


def _governor_engaged(env):
    """The governor must have actually tiered up under the 10x flood
    and refused work: peak tier >= PRESSURED, rejections counted, and
    any governor-driven scheduler sheds confined to INGRESS/SYNC (the
    standard zero_consensus_sheds invariant covers the consensus
    lane)."""
    from .. import governor as GV
    from ..sched.scheduler import SHED

    gov = env.data.get("governor")
    if gov is None:
        return False, "no governor was armed"
    if gov.peak < GV.Tier.PRESSURED:
        return False, (
            f"governor never left NORMAL (peak {gov.peak.name}) — "
            "the overload never pressured the node"
        )
    rejections = GV.rejections_total() - env.data.get(
        "gov_rejections_0", 0
    )
    if rejections < 1:
        return False, "the governor never refused a unit of work"
    submitted = env.data.get("node_pool_submitted", 0)
    if submitted < 1:
        return False, "the overload flood never submitted"
    env.data.setdefault("extra_metrics", {}).update({
        "overload_peak_tier": _m(int(gov.peak), "tier"),
        "overload_rejections": _m(int(rejections), "rejections"),
        "overload_attempts": _m(submitted, "attempts"),
        "overload_ingress_sheds": _m(
            SHED.value(lane="ingress", reason="governor"), "sheds",
        ),
        "overload_sync_sheds": _m(
            SHED.value(lane="sync", reason="governor"), "sheds",
        ),
    })
    return True, ""


def _resources_bounded(env):
    """End-of-run process resources must sit inside stationarity
    bounds relative to the pre-traffic baseline: a 10x overload may
    cost CPU and latency, never an unbounded RSS / fd / thread climb
    (the wedge-or-balloon failure modes this scenario exists to
    catch)."""
    from ..metrics import process_sample

    t0 = env.data.get("res_t0") or {}
    t1 = process_sample()
    bounds = {          # generous for a CI box, fatal for a real leak
        "rss_bytes": 512 << 20,
        "open_fds": 64,
        "threads": 24,
    }
    grew = {}
    for key, bound in bounds.items():
        a, b = t0.get(key), t1.get(key)
        if a is None or b is None:
            continue  # signal unavailable on this platform
        grew[key] = b - a
        if b - a > bound:
            return False, (
                f"{key} grew {b - a} over the run (bound {bound}) — "
                "resources are not stationary under overload"
            )
    env.data.setdefault("extra_metrics", {}).update({
        "overload_rss_growth_mib": _m(
            round(grew.get("rss_bytes", 0) / (1 << 20), 1), "MiB",
        ),
        "overload_fd_growth": _m(grew.get("open_fds", 0), "fds"),
        "overload_thread_growth": _m(grew.get("threads", 0), "threads"),
    })
    return True, ""


def overload_storm(quick: bool = False) -> Scenario:
    """10x rated ingress against a governed 4-node localnet: a paced
    overload flood (cycling funded-sender transfers into every node's
    REAL pool) plus POP/replay lane pressure.  The governor must tier
    up (pool fill / queue depth), drive the overload floor + ingress
    sheds, and the committee must keep committing with ZERO
    consensus-lane sheds while resources stay inside stationarity
    bounds — overload degrades ingestion, never liveness."""
    rated = 300.0 if quick else 1500.0  # the loadgen floor shape
    return Scenario(
        name="overload_storm",
        seed=47,
        topology=Topology(
            nodes=4, block_time_s=0.25,
            phase_timeout_s=6.0 if quick else 9.0,
            governor=True,
        ),
        traffic=Traffic(
            node_pool_rate=rated * 10,
            plain_rate=rated,
            pop_rate=16.0 if quick else 32.0,
            replay_workers=1,
            flood_duration_s=8.0 if quick else 16.0,
        ),
        # the p99 bound is overload-shaped: rounds compete with the
        # flood for the box's one vCPU — the SHARP invariants are the
        # governor customs + zero consensus sheds + liveness
        invariants=Invariants(
            min_blocks=4 if quick else 8,
            round_p99_s=60.0,
            custom=(
                ("governor_engaged", _governor_engaged),
                ("resources_bounded", _resources_bounded),
            ),
        ),
        window_s=120.0 if quick else 240.0,
    )


def _watchdog_recovered(env):
    """The watchdog must have seen BOTH injected faults — the killed
    flush thread (dead -> supervised restart) and the wedged sidecar
    reader (stale -> self-recovery) — dumped flight-recorder evidence
    for each, and the node must have kept committing (the liveness
    floor covers that part)."""
    import json as _json

    from .. import health as HL
    from .. import trace as TR

    ev = HL.EVENTS
    if ev["dead"] < 1:
        return False, "the killed flush thread was never detected"
    if ev["restart"] < 1:
        return False, "the dead flush thread was never restarted"
    if ev["stale"] < 1:
        return False, "the wedged sidecar reader was never detected"
    # attribution matters: the recovery must belong to a sidecar
    # READER — an unrelated participant flapping under box load (a
    # pump flagged stale then closed at teardown) must not satisfy
    # the injected wedge's recovery
    if not any(n.startswith("sidecar.reader")
               for n in HL.recovered_names()):
        return False, (
            "no sidecar reader was seen recovering (recovered: "
            f"{sorted(HL.recovered_names())})"
        )
    kinds: dict = {}
    for path in TR.dumps():
        try:
            with open(path) as f:
                kind = _json.load(f).get("kind", "")
        except (OSError, ValueError):
            continue
        if kind.startswith("watchdog."):
            kinds[kind] = kinds.get(kind, 0) + 1
    flush_dumps = kinds.get("watchdog.sched.flush", 0)
    reader_dumps = sum(
        n for k, n in kinds.items()
        if k.startswith("watchdog.sidecar.reader")
    )
    # at least the dead-detection dump; a FEW more are tolerated — on
    # a loaded box a busy flush batch can legitimately trip a stale
    # flag before the injected kill AND again after the supervised
    # restart (all real detections, distinct transitions).  The upper
    # bound is the per-kind cooldown's own machine bound over the run
    # window: past it, the dedup machinery is broken, not the box busy
    if not 1 <= flush_dumps <= 4:
        return False, (
            f"{flush_dumps} flight-recorder dumps for the flush "
            "thread (want 1, tolerate up to 4 under box load)"
        )
    if reader_dumps < 1:
        return False, "no flight-recorder dump for the wedged reader"
    env.data.setdefault("extra_metrics", {}).update({
        "wedge_dead_detected": _m(ev["dead"], "events"),
        "wedge_stale_detected": _m(ev["stale"], "events"),
        "wedge_restarts": _m(ev["restart"], "restarts"),
        "wedge_recoveries": _m(ev["recovered"], "events"),
        "wedge_watchdog_dumps": _m(sum(kinds.values()), "dumps"),
    })
    return True, ""


def wedged_thread_recovery(quick: bool = False) -> Scenario:
    """Fault-inject the two supervised thread classes mid-round: an
    unexpected error KILLS the scheduler flush thread (every signature
    check funnels through it) and a frame-path stall WEDGES a sidecar
    reader while it is busy.  The health watchdog must detect both
    inside its max-age window, dump exactly one flight-recorder trace
    per participant, restart the dead flush thread (restart-safe: its
    queues live on the scheduler object), let the reader's own
    redial/deadline machinery recover the wedge — and the committee
    must keep committing through all of it."""
    return Scenario(
        name="wedged_thread_recovery",
        seed=53,
        topology=Topology(
            nodes=4, sidecar=True, block_time_s=0.25,
            phase_timeout_s=6.0 if quick else 9.0,
            # tight enough to catch the 4 s reader stall mid-window,
            # loose enough that a pump busy validating one block on a
            # loaded box rarely false-positives
            watchdog_max_age_s=2.5,
        ),
        traffic=Traffic(
            pop_rate=8.0, replay_workers=1,
            flood_duration_s=5.0 if quick else 10.0,
        ),
        phases=(
            Phase(
                "wedge-flush-and-reader", at_round=2,
                duration_s=10.0,
                arms=(
                    # one unexpected error at the flush loop's top —
                    # outside every per-batch catch: the thread DIES
                    {"point": "sched.flush",
                     "exc": RuntimeError, "times": 1},
                    # one long stall on a NODE reader's frame path
                    # while it is marked busy: a WEDGE, not a death
                    # (keyed so it cannot land on a short-lived replay
                    # replica's reader, whose registration a successor
                    # replica would have replaced already)
                    {"point": "sidecar.frame", "key": "s0n1",
                     "delay_s": 4.0, "times": 1},
                ),
            ),
        ),
        invariants=Invariants(
            min_blocks=5 if quick else 9,
            round_p99_s=60.0,
            custom=(
                ("watchdog_recovered", _watchdog_recovered),
            ),
        ),
        window_s=120.0 if quick else 240.0,
    )


# -- the dress rehearsal: everything at once ----------------------


def _late_join_bootstrapped(env):
    """The gating late-join arc, end to end: the dark member actually
    came online mid-run, detected it was behind through the normal
    gossip path (sync spin-up), installed a PEER-SERVED snapshot
    (paged over the sync mesh, header hash agreed by peers, accounts
    bound to the sealed state root before adoption), and caught up to
    the live head — the runner surfaces the measured
    ``snapshot_bootstrap_seconds`` / ``join_catchup_seconds``.  One
    history is the standard no_divergent_heads invariant's job (the
    joined observer is judged like every other honest node)."""
    members = [
        h for h in env.handles if h.dark or h.joined_at is not None
    ]
    if not members:
        return False, "the topology seats no late_join member"
    h = members[0]
    if h.node is None:
        return False, "the late joiner never joined"
    if h.node.sync_spinups < 1:
        return False, (
            "the joiner never spun up its downloader — it did not "
            "detect it was behind"
        )
    dl = h._registry.get("downloader")
    if dl is None:
        return False, "the joiner has no downloader"
    if dl.snapshot_bootstraps < 1:
        return False, (
            "the joiner never installed a served snapshot (it caught "
            "up by replay alone — the bootstrap path was not exercised)"
        )
    if not env.data.get("join_catchup_s"):
        return False, "the joiner never caught up to the live head"
    return True, ""


def mainnet_rehearsal(quick: bool = False) -> Scenario:
    """The gating dress rehearsal: one long-horizon run
    composing every fault axis this framework owns, at a
    mainnet-shaped state scale.  The WHOLE run rides the WAN netem
    matrix (50–150 ms seed-keyed RTTs, jitter, loss); a staked
    external validator riding the byzantine node double-votes once
    elected and the full slashing pipeline must land (detect ->
    include -> apply); a 10x overload flood drives the governor
    through its tiers; a single-slot validator is hard-killed
    MID-COMMIT (storage batch torn) and restarts from disk mid-epoch;
    EPoS elections rotate the committee every 4 blocks throughout;
    and a dark late-join member comes online mid-run and must
    bootstrap from a peer-served snapshot of the 10^4-account state
    before tail replay.  The genesis allocation is 10^4 accounts with
    the flat sha3 root sealed in every header (the only viable
    large-state shape — see docs/ANALYSIS.md "Dress rehearsal"), so
    genesis build, per-block state persistence and the paged snapshot
    all pay mainnet-shaped costs.  Composed invariants: liveness,
    zero consensus sheds, no divergent honest heads, slashing
    applied, governor engaged, resources stationary, kill recovered,
    late joiner bootstrapped — plus the measured
    ``snapshot_bootstrap_seconds`` / ``join_catchup_seconds`` /
    ``heal``-class metrics."""
    rated = 250.0 if quick else 1000.0
    return Scenario(
        name="mainnet_rehearsal",
        seed=73,
        topology=Topology(
            nodes=4, multikey=2, staking=True, external_validators=1,
            blocks_per_epoch=4, durable=True, governor=True,
            late_join=1, snapshot_threshold=4,
            n_accounts=10_000, flat_root=True,
            block_time_s=0.3,
            phase_timeout_s=7.0 if quick else 10.0,
            byzantine=(("s0n0", "double_vote"),),
        ),
        traffic=Traffic(
            plain_rate=60.0 if quick else 150.0,
            pop_rate=6.0, replay_workers=1,
            node_pool_rate=rated * 10,
            flood_duration_s=6.0 if quick else 12.0,
        ),
        phases=(
            Phase(
                "wan-matrix", at_s=0.0, duration_s=None,
                links=("*->* rtt=50..150ms jitter=10ms loss=0.5%",),
            ),
            Phase(
                # join once the network is provably past the snapshot
                # threshold: the joiner must choose bootstrap, not
                # replay (the invariant asserts it did)
                "join-s0n4", at_round=5, duration_s=1.0,
                joins=("s0n4",),
            ),
            Phase(
                # mid-epoch (blocks_per_epoch=4: round 9 sits inside
                # an epoch) torn-batch kill of the single-slot
                # validator: quorum keeps one key of slack even with
                # the joiner still catching up
                "kill-s0n3-mid-commit", at_round=9, duration_s=1.0,
                kills=(
                    Kill("s0n3", mode="mid_commit",
                         restart_after_s=4.0 if quick else 8.0),
                ),
            ),
        ),
        # the p99 bound is composition-shaped: rounds spanning the
        # kill window or a WAN-lagged election boundary run the VC
        # ladder by design — the SHARP assertions are the composed
        # customs + zero sheds + liveness + no fork
        invariants=Invariants(
            min_blocks=11 if quick else 14,
            round_p99_s=90.0,
            min_epochs=2 if quick else 3,
            custom=(
                ("byz_evidence_applied", _byz_evidence_applied),
                ("governor_engaged", _governor_engaged),
                ("resources_bounded", _resources_bounded),
                ("kills_recovered", _kills_recovered),
                ("late_join_bootstrapped", _late_join_bootstrapped),
            ),
        ),
        window_s=280.0 if quick else 520.0,
    )


SCENARIOS = {
    "view_change_storm": view_change_storm,
    "epoch_election_rotation": epoch_election_rotation,
    "cross_shard_partition": cross_shard_partition,
    "validator_churn": validator_churn,
    "sidecar_flap": sidecar_flap,
    "leader_kill_restart": leader_kill_restart,
    "rolling_restart": rolling_restart,
    "byz_equivocating_leader": byz_equivocating_leader,
    "byz_double_voter_slashed": byz_double_voter_slashed,
    "byz_invalid_proposal_flood": byz_invalid_proposal_flood,
    "overload_storm": overload_storm,
    "wedged_thread_recovery": wedged_thread_recovery,
    "gray_leader": gray_leader,
    "asymmetric_partition": asymmetric_partition,
    "minority_partition_heal": minority_partition_heal,
    "wan_committee": wan_committee,
    "wan_committee_200": wan_committee_200,
    "gray_aggregator": gray_aggregator,
    "mainnet_rehearsal": mainnet_rehearsal,
}
