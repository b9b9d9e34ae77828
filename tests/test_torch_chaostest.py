"""The port's chaos framework (``harmony_tpu_torch/chaostest/``) against
the JAX package's: the 19 scenarios as data, the fixtures byte for byte,
faultinject's fault windows and the runner's phase windows, the runner's
refusal to answer on the host when the real kernels are asked for without
CUDA, and a scenario that cannot meet liveness, which must give the same
single violation and flight-recorder dump in both packages.

Scenario outcomes follow thread interleavings, so ``run`` is held to its
verdict and the kinds of its violations, not to its bytes."""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import types

import pytest

from harmony_tpu import faultinject as JFI
from harmony_tpu import trace as JTR
from harmony_tpu.chaostest import fixtures as JFX
from harmony_tpu.chaostest import runner as JR
from harmony_tpu.chaostest import scenario as JS
from harmony_tpu.chaostest import scenarios as JSC
from harmony_tpu.core import genesis as JGEN
from harmony_tpu_torch import device as TDV
from harmony_tpu_torch import faultinject as TFI
from harmony_tpu_torch import trace as TTR
from harmony_tpu_torch.chaostest import fixtures as TFX
from harmony_tpu_torch.chaostest import runner as TR
from harmony_tpu_torch.chaostest import scenario as TS
from harmony_tpu_torch.chaostest import scenarios as TSC
from harmony_tpu_torch.core import genesis as TGEN

NAMES = (
    "view_change_storm", "epoch_election_rotation", "cross_shard_partition",
    "validator_churn", "sidecar_flap", "leader_kill_restart",
    "rolling_restart", "byz_equivocating_leader", "byz_double_voter_slashed",
    "byz_invalid_proposal_flood", "overload_storm", "wedged_thread_recovery",
    "gray_leader", "asymmetric_partition", "minority_partition_heal",
    "wan_committee", "wan_committee_200", "gray_aggregator",
    "mainnet_rehearsal",
)


@pytest.fixture(autouse=True)
def _clean():
    for m in (JFI, TFI, JTR, TTR):
        m.reset()
    yield
    for m in (JFI, TFI, JTR, TTR):
        m.reset()


# -- the scenarios as data ------------------------------------------------------


def _data(x):
    """A scenario as plain data: dataclasses by their fields, callables
    (invariants, hold_until predicates) by their qualified names."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                {f.name: _data(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return tuple(_data(v) for v in x)
    if isinstance(x, dict):
        return {k: _data(v) for k, v in x.items()}
    if callable(x):
        return ("callable", x.__qualname__)
    return x


def test_registry_holds_the_same_nineteen_scenarios():
    assert tuple(TSC.SCENARIOS) == tuple(JSC.SCENARIOS) == NAMES


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_scenario_is_the_jax_packages(name, quick):
    port = TSC.SCENARIOS[name](quick=quick)
    want = JSC.SCENARIOS[name](quick=quick)
    assert isinstance(port, TS.Scenario) and isinstance(want, JS.Scenario)
    assert _data(port) == _data(want)
    assert port.name == name and port.window_s > 0
    assert port.window_s <= TSC.SCENARIOS[name](quick=False).window_s


# -- fixtures, byte for byte --------------------------------------------------------


def _tx(t):
    tx, sender = t if isinstance(t, tuple) else (t, None)
    return repr(tx), tx.hash(2), sender


def _fixtures(fx, gen):
    genesis, ecdsa_keys, _ = gen.dev_genesis(n_accounts=4, n_keys=4)
    ext = fx.external_bls_key(41, 0)
    obs = fx.observer_bls_key(41, 1)
    fin = fx.staking_finalizer(genesis, ecdsa_keys, shard_count=2)
    orders, owner = fx.mainnet_roster(
        200, seed=5, committee_keys=genesis.committee)
    stop = threading.Event()
    ticks = []
    for n in fx.paced_ticks(2000.0, stop):
        ticks.append(n)
        if n == 9:
            stop.set()
    return {
        "keys": [k.bytes + k.pub.bytes for k in (
            ext, obs, fx.external_bls_key(7), fx.observer_bls_key(7))],
        "stake": _tx(fx.external_validator_stake(ecdsa_keys[0], ext,
                                                 nonce=3, chain_id=2)),
        "finalizer": repr(dataclasses.asdict(fin.cfg)),
        "roster": ([(a, o.stake, o.spread_among, o.address)
                    for a, o in orders.items()], owner),
        "plain": [_tx(t) for t in fx.plain_transfers(40, 1)],
        "overload": [_tx(t) for t in fx.overload_transfers(ecdsa_keys,
                                                           depth=20)],
        "pop": [_tx(t) for t in fx.pop_submissions(4, 2, 11)],
        "ticks": ticks,
    }


def test_fixtures_give_the_same_bytes():
    port, want = _fixtures(TFX, TGEN), _fixtures(JFX, JGEN)
    assert port.keys() == want.keys()
    for k in port:
        assert port[k] == want[k], k
    assert len(port["roster"][1]) == 200 and port["ticks"] == list(range(10))


def test_advance_with_full_bitmaps_commits_the_same_blocks():
    from harmony_tpu.core import blockchain as JBC
    from harmony_tpu.core import kv as JKV
    from harmony_tpu.core import tx_pool as JPOOL
    from harmony_tpu_torch.core import blockchain as TBC
    from harmony_tpu_torch.core import kv as TKV
    from harmony_tpu_torch.core import tx_pool as TPOOL

    out = []
    for fx, gen, bc, kv, pool in ((JFX, JGEN, JBC, JKV, JPOOL),
                                  (TFX, TGEN, TBC, TKV, TPOOL)):
        genesis, _, _ = gen.dev_genesis(n_keys=5)
        chain = bc.Blockchain(kv.MemKV(), genesis, blocks_per_epoch=16)
        fx.advance_with_full_bitmaps(chain, pool.TxPool(2, 0, chain.state),
                                     n=3)
        out.append([(chain.block_by_number(n).hash(), chain.read_commit_sig(n))
                    for n in range(1, chain.head_number + 1)])
    assert out[1] == out[0] and len(out[1]) == 3


# -- fault windows ----------------------------------------------------------------


def _fire(fi, point):
    try:
        fi.fire(point)
    except Exception as e:  # noqa: BLE001 — the outcome is the finding
        return type(e).__name__
    return None


def _windows(fi):
    """faultinject's [t0, t1) windows, the after= budget and the when=
    predicate: the outcome of every fire."""
    seen = []
    fi.arm("w.point", exc=RuntimeError, t0=0.3, t1=10.0, times=1)
    fi.arm("w.budget", exc=ValueError, t0=0.3, after=1)
    fi.arm("w.closed", exc=RuntimeError, t1=0.05)
    seen.append([_fire(fi, "w.point")] + [_fire(fi, "w.budget")
                                          for _ in range(5)])
    time.sleep(0.35)
    seen.append([_fire(fi, p) for p in
                 ("w.point", "w.point", "w.closed", "w.budget", "w.budget")])
    head = {"n": 0}
    fi.arm("w.round", exc=ConnectionError, when=lambda: 3 <= head["n"] < 5)
    fi.arm("w.broken", exc=RuntimeError,
           when=lambda: (_ for _ in ()).throw(ValueError))
    for n in range(7):
        head["n"] = n
        seen.append((_fire(fi, "w.round"), _fire(fi, "w.broken")))
    return seen


def test_fault_windows_fire_as_the_jax_packages():
    port, want = _windows(TFI), _windows(JFI)
    assert port == want
    assert port[0] == [None] * 6
    assert port[1] == ["RuntimeError", None, None, None, "ValueError"]
    assert [r for r, _ in port[2:]] == [None, None, None, "ConnectionError",
                                        "ConnectionError", None, None]
    assert all(b is None for _, b in port[2:])


def _drive_timeline(runner, phase):
    """The runner's fault script over a stand-in RunEnv of one literal
    partition phase: returns the partition's (armed at, healed at)."""
    env = types.SimpleNamespace(
        scenario=types.SimpleNamespace(phases=(phase,)), handles=[],
        net=types.SimpleNamespace(partitioned=set()),
        shard_head=lambda shard: 0, by_shard=lambda shard: [], data={})
    stop = threading.Event()
    t0 = time.monotonic()
    t = threading.Thread(target=runner._timeline,
                         args=(env, stop, t0, threading.Event()),
                         daemon=True)
    t.start()
    armed = healed = None
    try:
        deadline = t0 + 5.0
        while time.monotonic() < deadline and healed is None:
            if armed is None and "n0" in env.net.partitioned:
                armed = time.monotonic() - t0
            elif armed is not None and "n0" not in env.net.partitioned:
                healed = time.monotonic() - t0
            time.sleep(0.005)
        t.join(5.0)
        assert not t.is_alive()
    finally:
        stop.set()
    return armed, healed


RUNNERS = pytest.mark.parametrize("runner, S", [(JR, JS), (TR, TS)],
                                  ids=["jax", "port"])


@RUNNERS
def test_phase_hold_until_outlasts_its_duration(runner, S):
    done = threading.Event()
    timer = threading.Timer(0.5, done.set)
    timer.start()
    phase = S.Phase("hold", at_s=0.0, duration_s=0.1, partition=("n0",),
                    hold_until=lambda env: done.is_set(), hold_max_s=30.0)
    armed, healed = _drive_timeline(runner, phase)
    timer.join()
    assert armed is not None and healed is not None
    assert healed >= 0.5, "healed on the wall clock before hold_until"


@RUNNERS
def test_phase_hold_max_caps_a_never_true_predicate(runner, S):
    phase = S.Phase("cap", at_s=0.0, duration_s=0.05, partition=("n0",),
                    hold_until=lambda env: False, hold_max_s=0.4)
    armed, healed = _drive_timeline(runner, phase)
    assert armed is not None and healed is not None
    assert 0.35 <= healed < 5.0


# -- the runner ---------------------------------------------------------------------


def test_real_kernels_without_cuda_raise_before_anything_runs(monkeypatch):
    """HARMONY_CHAOS_REAL_KERNELS=1 asks for the kernels on the card: on a
    machine without CUDA the port's run raises through the device
    resolution instead of answering on the host, and leaves the twin
    switch and the device path as they were."""
    monkeypatch.setenv("HARMONY_CHAOS_REAL_KERNELS", "1")
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    built = []
    monkeypatch.setattr(TR, "_build", lambda *a, **k: built.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TR.run(TSC.view_change_storm(quick=True))
    assert not built
    assert not TDV.kernel_twin_active()
    assert TDV._FORCED is None and TDV._NODE_DEVICE is None


def _impossible(S):
    return S.Scenario(
        name="impossible_liveness", seed=7,
        topology=S.Topology(nodes=4, block_time_s=0.2,
                            phase_timeout_s=30.0),
        traffic=S.Traffic(),
        invariants=S.Invariants(min_blocks=10_000, round_p99_s=60.0),
        window_s=6.0)


def test_impossible_liveness_gives_the_same_single_violation(tmp_path,
                                                             monkeypatch):
    """A scenario that cannot meet liveness: one violation, ``liveness``,
    and exactly one correlated dump of the same kind, in both packages
    (the port on the twins, off the card)."""
    monkeypatch.delenv("HARMONY_CHAOS_REAL_KERNELS", raising=False)
    got = {}
    for k, (runner, S) in {"jax": (JR, JS), "port": (TR, TS)}.items():
        monkeypatch.setenv("HARMONY_TPU_TRACE_DIR", str(tmp_path / k))
        r = runner.run(_impossible(S))
        dumps = [json.load(open(p)) for p in r.violation_dumps]
        got[k] = (r.passed, [v["invariant"] for v in r.violations],
                  [d["kind"] for d in dumps],
                  ["min_blocks=10000" in d["info"]["detail"] for d in dumps])
    assert got["port"] == got["jax"]
    assert got["port"] == (False, ["liveness"],
                           ["chaos.impossible_liveness.liveness"], [True])
