"""The port's resource governor, rate limiter and the scheduler's governor
shedding against the JAX package's.

Each scenario runs the same injected samples, the same fake clock and the
same call sequence on both packages' modules and returns what it observed
(tiers, transitions, knob values, admissions, verdicts, shed counts); the
two packages' observations must be equal.  The scheduler cases run with
the bigint twins as the kernels (``HARMONY_KERNEL_TWIN=1``) and the
node's device forced (the port's on the CPU).  A last case shows that a
governor shed of a check bound for CUDA fails with ``DeviceError``; only
the device's type is read, so no card is needed.
"""

import sys
import types

import pytest

import harmony_tpu.sched.scheduler  # noqa: F401 — the module, by name
import harmony_tpu_torch.sched.scheduler  # noqa: F401
from harmony_tpu import bls as J_B
from harmony_tpu import device as J_DV
from harmony_tpu import governor as J_GV
from harmony_tpu import ratelimit as J_RL
from harmony_tpu import sched as J_SCHED
from harmony_tpu.ref.hash_to_curve import hash_to_g2 as j_hash_to_g2
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import governor as T_GV
from harmony_tpu_torch import ratelimit as T_RL
from harmony_tpu_torch import sched as T_SCHED
from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2 as t_hash_to_g2

PACKAGES = {
    "jax": types.SimpleNamespace(
        B=J_B, DV=J_DV, GV=J_GV, RL=J_RL, sched=J_SCHED,
        SC=sys.modules["harmony_tpu.sched.scheduler"],
        hash_to_g2=j_hash_to_g2, device={}),
    "port": types.SimpleNamespace(
        B=T_B, DV=T_DV, GV=T_GV, RL=T_RL, sched=T_SCHED,
        SC=sys.modules["harmony_tpu_torch.sched.scheduler"],
        hash_to_g2=t_hash_to_g2, device={"device": "cpu"}),
}
PAYLOAD = b"governed-quorum-payload-32bytes!"
TIGHT = dict(rss_pressured_bytes=100, rss_critical_bytes=200,
             fds_pressured=10, fds_critical=20,
             threads_pressured=10, threads_critical=20,
             queue_pressured=10, queue_critical=20,
             pool_pressured=0.5, pool_critical=0.9,
             hysteresis=0.8, dwell_s=2.0)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for m in PACKAGES.values():
        m.GV.uninstall()
        m.sched.reset()
        m.DV.use_device(None)


class _Pool:
    """A tx-pool stand-in: a fill ratio, and the floor multipliers the
    governor drives onto it."""

    def __init__(self):
        self.fill = 0.0
        self.floors = []

    def fill_ratio(self):
        return self.fill

    def set_floor_multiplier(self, k):
        self.floors.append(k)


def _transitions(m):
    return {tuple(sorted(k)): v for k, v in m.GV.TRANSITIONS._values.items()}


# samples in turn, each with the fake clock's time: escalation is
# immediate, each step down needs the signals under the hysteresis and a
# dwell in the tier, one tier a dwell
SAMPLES = [
    (0.0, {"rss_bytes": 50, "open_fds": 5, "threads": 5}),
    (0.5, {"rss_bytes": 120}),                      # -> pressured
    (1.0, {"queue_depth": 25}),                     # -> critical
    (1.5, {"queue_depth": 19}),                     # held (hysteresis)
    (2.0, {"queue_depth": 15}),                     # held (dwell)
    (3.1, {"queue_depth": 15}),                     # -> pressured
    (3.5, {"threads": 9}),                          # held (hysteresis)
    (5.2, {"threads": 7}),                          # -> normal
    (5.3, {"open_fds": 25, "rss_bytes": None}),     # -> critical at once
    (5.4, {"pool_fill": 0.2}),                      # held (dwell)
    (7.5, {"pool_fill": 0.7}),                      # -> pressured
    (9.6, {"pool_fill": 0.7}),                      # held (pool pressured)
    (9.7, {"pool_fill": 0.1}),                      # -> normal
]


def tiers_knobs_and_transitions(m):
    now = [0.0]
    feed = [{}]
    gov = m.GV.ResourceGovernor(m.GV.Limits(**TIGHT), sample_fn=lambda:
                                feed[0], pressured_ingress_rate=1.0,
                                clock=lambda: now[0])
    pool = _Pool()
    gov.attach_pool(pool)
    m.GV.install(gov)
    before = _transitions(m)
    rows = []
    for t, sample in SAMPLES:
        now[0], feed[0] = t, sample
        tier = gov.sample_once()
        rows.append((
            t, int(tier), m.GV.TIER_NAMES[tier], gov.floor_multiplier(),
            m.GV.sync_window_scale(),
            [m.GV.should_shed(lane) for lane in m.SC.Lane],
            m.GV.admit_ingress("peer", surface="rpc"),
        ))
    moved = {k: v - before.get(k, 0) for k, v in _transitions(m).items()
             if v != before.get(k, 0)}
    return rows, int(gov.peak), pool.floors, moved, gov.last_sample


def pressured_admission_is_a_token_bucket(m):
    gov = m.GV.ResourceGovernor(m.GV.Limits(**TIGHT),
                                sample_fn=lambda: {"rss_bytes": 150},
                                pressured_ingress_rate=1.0)
    gov.sample_once()
    m.GV.install(gov)
    rejected = m.GV.REJECTIONS.value(surface="rpc")
    # burst 2 per key at PRESSURED, then refused until the bucket refills
    # (one token a second)
    verdicts = [m.GV.admit_ingress(key, surface="rpc")
                for key in ("a", "a", "a", "b", "b", "b", "a")]
    return (verdicts, m.GV.REJECTIONS.value(surface="rpc") - rejected,
            m.GV.current() is gov)


def uninstalled_governor_is_open(m):
    m.GV.uninstall()
    return (m.GV.current(), m.GV.should_shed(m.SC.Lane.INGRESS),
            m.GV.admit_ingress("x"), m.GV.sync_window_scale(),
            m.GV.STATE.value())


@pytest.mark.parametrize("scenario", [
    tiers_knobs_and_transitions, pressured_admission_is_a_token_bucket,
    uninstalled_governor_is_open,
], ids=lambda s: s.__name__)
def test_governor_behaves_as_the_jax_package(scenario):
    observed = {}
    for name, m in PACKAGES.items():
        try:
            observed[name] = scenario(m)
        finally:
            m.GV.uninstall()
    assert observed["port"] == observed["jax"]


def test_the_rate_limiters_admit_the_same_requests():
    """Both token buckets over one key sequence: bursts, refusals, the
    stalest key's eviction past ``max_keys`` (it starts over with a full
    burst), and ``drop``.  The refill rate is so slow that the test's own
    run time adds no token."""
    keys = ["a", "a", "a", "b", "c", "d", "a", "b", "b", "b", "e", "a"]
    out = {}
    for name, m in PACKAGES.items():
        rl = m.RL.RateLimiter(per_second=1e-6, burst=2, max_keys=3)
        seen = [rl.allow(k) for k in keys]
        rl.drop("b")
        seen += [rl.allow("b"), len(rl._state)]
        out[name] = seen
    assert out["port"] == out["jax"]
    assert out["port"][:3] == [True, True, False]


def governed_lanes(m, tier_sample):
    """One governor tier over a manual scheduler: INGRESS single checks
    (a good and a forged signature), a SYNC and a CONSENSUS aggregate
    check; (verdicts by lane, sheds by reason and lane, flushes)."""
    m.DV.use_device(True, **m.device)
    m.sched.reset()
    keys = [m.B.PrivateKey.generate(bytes([70 + i])) for i in range(3)]
    table = m.DV.CommitteeTable([k.pub.point for k in keys])
    agg = m.B.aggregate_sigs([k.sign_hash(PAYLOAD) for k in keys[:2]])
    h = m.hash_to_g2(PAYLOAD)
    gov = m.GV.ResourceGovernor(m.GV.Limits(**TIGHT),
                                sample_fn=lambda: tier_sample)
    gov.sample_once()
    m.GV.install(gov)
    before = dict(m.SC.SHED._values)
    s = m.SC.VerifyScheduler(manual=True, **m.device)
    sig0 = keys[0].sign_hash(PAYLOAD).point
    futures = {
        "ingress good": s.submit_single(keys[0].pub.point, h, sig0),
        "ingress forged": s.submit_single(keys[1].pub.point, h, sig0),
        "sync": s.submit_agg(table, [1, 1, 0], h, agg.point,
                             lane=m.SC.Lane.SYNC),
        "consensus": s.submit_agg(table, [1, 1, 0], h, agg.point,
                                  lane=m.SC.Lane.CONSENSUS),
    }
    flushes = 0
    while s._flush_once():
        flushes += 1
    verdicts = {k: f.result(5) for k, f in futures.items()}
    sheds = {tuple(sorted(k)): v - before.get(k, 0)
             for k, v in m.SC.SHED._values.items()
             if v != before.get(k, 0)}
    return m.GV.TIER_NAMES[gov.state()], verdicts, sheds, flushes


@pytest.mark.parametrize("tier_sample", [
    {"rss_bytes": 50}, {"rss_bytes": 150}, {"rss_bytes": 250},
], ids=["normal", "pressured", "critical"])
def test_the_scheduler_sheds_as_the_jax_package(tier_sample, monkeypatch):
    """INGRESS is shed from PRESSURED, SYNC at CRITICAL, CONSENSUS never;
    off the card a shed check gets the host's verdict, counted as
    ``shed{reason="governor"}``."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    observed = {name: governed_lanes(m, tier_sample)
                for name, m in PACKAGES.items()}
    assert observed["port"] == observed["jax"]
    tier, verdicts, sheds, _ = observed["port"]
    assert verdicts == {"ingress good": True, "ingress forged": False,
                        "sync": True, "consensus": True}
    shed_lanes = {dict(k)["lane"] for k in sheds}
    assert all(dict(k)["reason"] == "governor" for k in sheds)
    assert shed_lanes == {"normal": set(), "pressured": {"ingress"},
                          "critical": {"ingress", "sync"}}[tier]
    assert "consensus" not in shed_lanes


def test_a_governor_shed_bound_for_the_card_fails(monkeypatch):
    """At PRESSURED an INGRESS check bound for CUDA fails with
    DeviceError, counted as a governor shed, and never reaches the host
    path; CONSENSUS is still queued."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    SC = PACKAGES["port"].SC
    T_DV.use_device(True, device="cpu")
    keys = [T_B.PrivateKey.generate(bytes([70 + i])) for i in range(2)]
    h = t_hash_to_g2(PAYLOAD)
    sig = keys[0].sign_hash(PAYLOAD).point
    gov = T_GV.ResourceGovernor(T_GV.Limits(**TIGHT),
                                sample_fn=lambda: {"queue_depth": 12})
    gov.sample_once()
    T_GV.install(gov)
    monkeypatch.setattr(SC.VerifyScheduler, "_on_card",
                        lambda self, req: True)
    monkeypatch.setattr(SC.VerifyScheduler, "_ref_result", staticmethod(
        lambda req: pytest.fail("a check bound for the card reached the "
                                "host path")))
    shed = SC.SHED.value(lane="ingress", reason="governor")
    s = SC.VerifyScheduler(manual=True, device="cpu")
    with pytest.raises(T_DV.DeviceError, match="governor"):
        s.submit_single(keys[0].pub.point, h, sig).result(1)
    assert SC.SHED.value(lane="ingress", reason="governor") == shed + 1
    pending = s.submit_single(keys[0].pub.point, h, sig,
                              lane=SC.Lane.CONSENSUS)
    assert s._lanes[SC.Lane.CONSENSUS] and not pending.done()
