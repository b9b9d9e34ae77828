"""The port's verification scheduler against the JAX package's: a port of
tests/test_sched.py.

Each case runs the same call sequence on both packages, with the bigint
twins as the kernels on both sides (``HARMONY_KERNEL_TWIN=1``) and the
node's device forced (the port's on the CPU), and compares what they
return: flush order, verdicts, sheds, fill accounting, counters.  The
queue-logic cases swap the dispatchers for recorders, as the original
does.  One case runs the port's real CPU plain path: one mixed flush, one
dispatch.
"""

import sys
import threading
import time
import types

import pytest
import torch

import harmony_tpu.sched.scheduler  # noqa: F401 — the module, by name
import harmony_tpu_torch.sched.scheduler  # noqa: F401
from harmony_tpu import bls as J_B
from harmony_tpu import device as J_DV
from harmony_tpu import faultinject as J_FI
from harmony_tpu import resilience as J_RS
from harmony_tpu import sched as J_SCHED
from harmony_tpu.ops import twin as J_TWIN
from harmony_tpu.ref import bls as J_RB
from harmony_tpu.ref.hash_to_curve import hash_to_g2 as j_hash_to_g2
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import faultinject as T_FI
from harmony_tpu_torch import resilience as T_RS
from harmony_tpu_torch import sched as T_SCHED
from harmony_tpu_torch.ops import twin as T_TWIN
from harmony_tpu_torch.ref.hash_to_curve import hash_to_g2 as t_hash_to_g2

PACKAGES = {
    "jax": types.SimpleNamespace(
        B=J_B, DV=J_DV, FI=J_FI, RS=J_RS, sched=J_SCHED, TWIN=J_TWIN,
        SC=sys.modules["harmony_tpu.sched.scheduler"],
        hash_to_g2=j_hash_to_g2, device={}),
    "port": types.SimpleNamespace(
        B=T_B, DV=T_DV, FI=T_FI, RS=T_RS, sched=T_SCHED, TWIN=T_TWIN,
        SC=sys.modules["harmony_tpu_torch.sched.scheduler"],
        hash_to_g2=t_hash_to_g2, device={"device": "cpu"}),
}
N_KEYS = 4
PAYLOAD = b"sched-quorum-payload-32-bytes!!!"


@pytest.fixture(autouse=True)
def _twins(monkeypatch):
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    yield
    for m in PACKAGES.values():
        m.sched.reset()
        m.FI.reset()
        m.DV.use_device(None)


def _on_both(scenario, monkeypatch):
    """scenario(m, committee) on each package, each with the device path
    forced and a fresh global scheduler; the two results."""
    out = {}
    for name, m in PACKAGES.items():
        m.DV.use_device(True, **m.device)
        m.sched.reset()
        keys = [m.B.PrivateKey.generate(bytes([40 + i]))
                for i in range(N_KEYS)]
        table = m.DV.CommitteeTable([k.pub.point for k in keys])
        agg = m.B.aggregate_sigs([k.sign_hash(PAYLOAD) for k in keys[:3]])
        committee = (keys, table, agg, [1, 1, 1, 0])
        try:
            out[name] = scenario(m, committee, monkeypatch)
        finally:
            m.sched.reset()
            m.FI.reset()
            monkeypatch.undo()
            monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    return out["jax"], out["port"]


def _recording(s):
    """Replace the instance's device dispatchers with recorders."""
    flushes = []

    def run(kind):
        def _run(batch):
            flushes.append((kind, [(r.lane.name, r.bits) for r in batch]))
            return [True] * len(batch), len(batch)

        return _run

    s._run_single = run("single")
    s._run_agg = run("agg")
    return flushes


class _FakeTable:
    pass


# -- queue-logic invariants (recording dispatch, deterministic) ---------------------


def per_lane_fifo_and_group_prefix(m, committee, mp):
    s = m.SC.VerifyScheduler(manual=True)
    flushes = _recording(s)
    t1, t2 = _FakeTable(), _FakeTable()
    for table, tag in ((t1, "a1"), (t1, "a2"), (t2, "b1"), (t1, "a3")):
        s.submit_agg(table, tag, None, None, lane=m.SC.Lane.SYNC)
    while s._flush_once():
        pass
    assert [[tag for _, tag in b] for _, b in flushes] == \
        [["a1", "a2"], ["b1"], ["a3"]]
    return flushes


def priority_preemption_with_backfill(m, committee, mp):
    s = m.SC.VerifyScheduler(manual=True)
    flushes = _recording(s)
    t1 = _FakeTable()
    for lane, tag in (("SYNC", "s1"), ("SYNC", "s2"), ("INGRESS", "i1"),
                      ("CONSENSUS", "c1")):
        s.submit_agg(t1, tag, None, None, lane=m.SC.Lane[lane])
    s._flush_once()
    assert [tag for _, tag in flushes[0][1]] == ["c1", "s1", "s2", "i1"]
    return flushes


def starvation_bound(m, committee, mp):
    s = m.SC.VerifyScheduler(manual=True, starvation_limit=2)
    flushes = _recording(s)
    tc, ts = _FakeTable(), _FakeTable()
    s.submit_agg(ts, "s1", None, None, lane=m.SC.Lane.SYNC)
    served_sync_at = None
    for i in range(6):
        s.submit_agg(tc, f"c{i}", None, None, lane=m.SC.Lane.CONSENSUS)
        s._flush_once()
        if any(lane == "SYNC" for lane, _ in flushes[-1][1]):
            served_sync_at = i
            break
    assert served_sync_at is not None and served_sync_at <= 2
    return served_sync_at, flushes


def deadline_failfast_at_admission(m, committee, mp):
    s = m.SC.VerifyScheduler(manual=True)
    flushes = _recording(s)
    shed = m.SC.SHED.value(lane="consensus", reason="deadline")
    fut = s.submit_agg(_FakeTable(), "x", None, None,
                       lane=m.SC.Lane.CONSENSUS,
                       deadline=m.RS.Deadline.after(0.0))
    with pytest.raises(m.RS.DeadlineExceeded):
        fut.result(1.0)
    assert not any(s._lanes.values())
    s._flush_once()
    return flushes, m.SC.SHED.value(lane="consensus",
                                    reason="deadline") - shed


def expired_in_queue_never_dispatched(m, committee, mp):
    s = m.SC.VerifyScheduler(manual=True)
    flushes = _recording(s)
    fut = s.submit_agg(_FakeTable(), "x", None, None, lane=m.SC.Lane.SYNC,
                       deadline=m.RS.Deadline.after(0.02))
    admitted = bool(s._lanes[m.SC.Lane.SYNC])
    time.sleep(0.04)
    s._flush_once()
    with pytest.raises(m.RS.DeadlineExceeded):
        fut.result(1.0)
    return admitted, flushes


# -- real verdicts through the twins ------------------------------------------------


def queue_full_sheds_to_cpu_ref(m, committee, mp):
    _, table, agg, bits = committee
    h = m.hash_to_g2(PAYLOAD)
    s = m.SC.VerifyScheduler(manual=True, max_queue_per_lane=2)
    shed = m.SC.SHED.value(lane="sync", reason="queue_full")
    futs = [s.submit_agg(table, bits, h, agg.point, lane=m.SC.Lane.SYNC)
            for _ in range(3)]
    inline = (futs[2].done(), futs[2].result(), futs[0].done())
    while s._flush_once():
        pass
    return (inline, [f.result(5) for f in futs],
            m.SC.SHED.value(lane="sync", reason="queue_full") - shed)


def breaker_open_shed_matches_cpu_ref(m, committee, mp):
    keys, table, agg, bits = committee
    brk = m.RS.CircuitBreaker("device", failure_threshold=1,
                              reset_timeout_s=3600.0)
    brk.record_failure()
    mp.setattr(m.DV, "BREAKER", brk)
    calls = dict(m.TWIN.CALLS)
    shed = m.SC.SHED.value(lane="consensus", reason="breaker_open")
    h = m.hash_to_g2(PAYLOAD)
    bad = m.B.aggregate_sigs([k.sign_hash(PAYLOAD) for k in keys[:2]])
    got = [m.sched.agg_verify(table, bits, PAYLOAD, sig,
                              lane=m.sched.Lane.CONSENSUS)
           for sig in (agg.point, bad.point)]
    assert got == [m.DV._ref_agg_verify(table, bits, h, agg.point),
                   m.DV._ref_agg_verify(table, bits, h, bad.point)]
    assert dict(m.TWIN.CALLS) == calls  # the device was never touched
    return got, m.SC.SHED.value(lane="consensus",
                                reason="breaker_open") - shed


def fill_ratio_coalescing(m, committee, mp):
    keys = [m.B.PrivateKey.generate(bytes([90 + i])) for i in range(8)]
    msgs = [b"fill-%d" % i for i in range(8)]
    sigs = [k.sign_hash(msg) for k, msg in zip(keys, msgs)]
    s = m.SC.VerifyScheduler(manual=True)
    items0, slots0 = m.SC.FILL["items"], m.SC.FILL["slots"]
    flushes0 = m.SC.FLUSHES.value(kind="single")
    futs = [s.submit_single(k.pub.point, m.hash_to_g2(msg), sig.point,
                            lane=m.SC.Lane.INGRESS)
            for k, msg, sig in zip(keys, msgs, sigs)]
    while s._flush_once():
        pass
    return ([f.result(10) for f in futs], m.SC.FILL["items"] - items0,
            m.SC.FILL["slots"] - slots0,
            m.SC.FLUSHES.value(kind="single") - flushes0)


def chaos_consensus_bounded_while_sync_backs_up(m, committee, mp):
    _, table, agg, bits = committee
    h = m.hash_to_g2(PAYLOAD)
    m.FI.arm("device.dispatch", delay_s=0.05)
    s = m.sched.scheduler()
    stop = threading.Event()
    depths = []

    def flood():
        while not stop.is_set():
            futs = [s.submit_agg(table, bits, h, agg.point,
                                 lane=m.SC.Lane.SYNC) for _ in range(6)]
            depths.append(len(s._lanes[m.SC.Lane.SYNC]))
            for f in futs:
                try:
                    f.result(30)
                except RuntimeError:
                    return

    t = threading.Thread(target=flood, daemon=True)
    t.start()
    time.sleep(0.1)
    lat, oks = [], []
    for _ in range(7):
        t0 = time.monotonic()
        oks.append(m.sched.agg_verify(table, bits, PAYLOAD, agg.point,
                                      lane=m.sched.Lane.CONSENSUS))
        lat.append(time.monotonic() - t0)
    stop.set()
    t.join(timeout=30)
    assert sorted(lat)[len(lat) // 2] < 1.0
    assert max(depths, default=0) > 0
    return oks


def proofs_of_possession_on_the_ingress_lane(m, committee, mp):
    keys = [m.B.PrivateKey.generate(b"sched-pop-%d" % i) for i in range(3)]
    pops = [m.B.proof_of_possession(k) for k in keys]
    items = m.SC.ITEMS.value(lane="ingress")
    ok = m.B.verify_proofs_of_possession(
        [(k.pub.bytes, p) for k, p in zip(keys, pops)])
    bad = bytearray(pops[1])
    bad[5] ^= 0x40
    return (ok, m.B.verify_proof_of_possession(keys[0].pub.bytes, pops[0]),
            m.B.verify_proof_of_possession(keys[1].pub.bytes, bytes(bad)),
            m.B.verify_proof_of_possession(keys[1].pub.bytes, pops[0]),
            m.B.verify_proofs_of_possession([(b"\x00" * 48, pops[0])]),
            m.B.verify_proofs_of_possession([]),
            m.SC.ITEMS.value(lane="ingress") - items)


def verify_point_on_a_lane(m, committee, mp):
    keys = committee[0]
    sig = keys[1].sign_hash(PAYLOAD)
    before = m.DV.COUNTERS["verify"]
    items = m.SC.ITEMS.value(lane="ingress")
    got = [m.B.verify_point(keys[1].pub.point, PAYLOAD, sig.point,
                            lane=m.sched.Lane.INGRESS),
           m.B.verify_point(keys[2].pub.point, PAYLOAD, sig.point,
                            lane=m.sched.Lane.INGRESS)]
    return (got, m.DV.COUNTERS["verify"] - before,
            m.SC.ITEMS.value(lane="ingress") - items)


class _FakeSidecar:
    """A duck-typed sidecar client: agg_verify answers from the host
    path; agg_verify_begin returns a handle with ``result()``."""

    def __init__(self, m, table):
        self.m, self.table, self.calls = m, table, []

    def agg_verify(self, epoch, shard, payload, bitmap, sig, deadline=None):
        self.calls.append(("sync", epoch))
        bits = [(bitmap[i >> 3] >> (i & 7)) & 1 for i in range(N_KEYS)]
        return self.m.DV._ref_agg_verify(
            self.table, bits, self.m.hash_to_g2(payload),
            self.m.B.Signature.from_bytes(sig).point)

    def agg_verify_begin(self, *args, deadline=None):
        out = self.agg_verify(*args, deadline=deadline)
        self.calls[-1] = ("begin", args[0])
        return types.SimpleNamespace(result=lambda: out)


def backend_batches_through_the_worker(m, committee, mp):
    keys, table, agg, bits = committee
    bad = m.B.aggregate_sigs([k.sign_hash(PAYLOAD) for k in keys[:2]])
    client = _FakeSidecar(m, table)
    calls = [(e, 0, PAYLOAD, bytes([0b0111]), sig)
             for e, sig in ((2, agg.bytes), (3, bad.bytes), (4, agg.bytes))]
    futs = m.sched.backend_agg_verify_many(client, calls)
    got = [f.result(10) for f in futs]
    m.sched.configure(enabled=False)
    direct = [f.result(10) for f in
              m.sched.backend_agg_verify_many(client, calls)]
    return got, direct, sorted(client.calls)


def inline_and_disabled_routing(m, committee, mp):
    _, table, agg, bits = committee
    h = m.hash_to_g2(PAYLOAD)
    s = m.SC.VerifyScheduler()  # never started: runs each request inline
    inline = [s.submit_agg(table, bits, h, agg.point).result(5),
              s.submit_single(committee[0][0].pub.point, h,
                              committee[0][0].sign_hash(PAYLOAD).point
                              ).result(5)]
    m.sched.configure(enabled=False)
    before = dict(m.TWIN.CALLS)
    direct = [m.sched.agg_verify(table, bits, PAYLOAD, agg.point),
              m.sched.agg_verify_many(table, [bits, [1, 1, 0, 0]],
                                      [h, h], [agg.point, agg.point])]
    return inline, direct, {k: v - before[k]
                            for k, v in m.TWIN.CALLS.items()}


def sched_metrics_exposed(m, committee, mp):
    text = m.sched.expose_metrics()
    fams = ("harmony_sched_queue_depth", "harmony_sched_shed_total",
            "harmony_sched_flushes_total", "harmony_sched_items_total",
            "harmony_sched_wait_seconds", "harmony_sched_batch_fill_ratio")
    return [f in text for f in fams], 'lane="consensus"' in text


SCENARIOS = [
    per_lane_fifo_and_group_prefix, priority_preemption_with_backfill,
    starvation_bound, deadline_failfast_at_admission,
    expired_in_queue_never_dispatched, queue_full_sheds_to_cpu_ref,
    breaker_open_shed_matches_cpu_ref, fill_ratio_coalescing,
    chaos_consensus_bounded_while_sync_backs_up,
    proofs_of_possession_on_the_ingress_lane, verify_point_on_a_lane,
    backend_batches_through_the_worker, inline_and_disabled_routing,
    sched_metrics_exposed,
]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_port_scheduler_behaves_as_the_jax_package(scenario, monkeypatch):
    jax, port = _on_both(scenario, monkeypatch)
    assert port == jax


def test_expected_outcomes(monkeypatch):
    """What the original tests assert of the verdicts, on the port."""
    _, port = _on_both(fill_ratio_coalescing, monkeypatch)
    assert port == ([True] * 8, 8, 8, 1)
    _, port = _on_both(proofs_of_possession_on_the_ingress_lane,
                       monkeypatch)
    assert port[:6] == (True, True, False, False, False, True)
    _, port = _on_both(backend_batches_through_the_worker, monkeypatch)
    assert port[0] == port[1] == [True, False, True]


def test_a_shed_check_bound_for_the_card_fails(monkeypatch):
    """A full queue or an OPEN breaker fails a check bound for CUDA with
    DeviceError (counted as shed), never the host's verdict; the same
    check off the card gets the host's verdict.  Only the device's type
    is read: no card is needed."""
    SC = PACKAGES["port"].SC
    keys = [T_B.PrivateKey.generate(bytes([40 + i])) for i in range(2)]
    h = t_hash_to_g2(PAYLOAD)
    sig = keys[0].sign_hash(PAYLOAD).point
    shed = SC.SHED.total()
    card = SC.VerifyScheduler(manual=True, device="cuda",
                              max_queue_per_lane=0)
    with pytest.raises(T_DV.DeviceError, match="queue_full"):
        card.submit_single(keys[0].pub.point, h, sig).result(1)
    host = SC.VerifyScheduler(manual=True, device="cpu",
                              max_queue_per_lane=0)
    assert host.submit_single(keys[0].pub.point, h, sig).result(1) is True
    card_table = types.SimpleNamespace(device=torch.device("cuda"))
    monkeypatch.setattr(T_DV, "BREAKER", T_RS.CircuitBreaker("device", 1,
                                                              30.0))
    T_DV.BREAKER.record_failure()
    card = SC.VerifyScheduler(manual=True, device="cuda")
    with pytest.raises(T_DV.DeviceError, match="breaker_open"):
        card.submit_agg(card_table, [1, 0], h, sig).result(1)
    with pytest.raises(T_DV.DeviceError, match="breaker_open"):
        card.submit_single(keys[0].pub.point, h, sig).result(1)
    assert SC.SHED.total() == shed + 4


def test_one_mixed_flush_on_the_cpu_plain_path(monkeypatch):
    """Three lanes' aggregate checks on one table fuse into ONE flush:
    one dispatch of the port's real CPU plain path, the verdicts the
    host reference gives."""
    monkeypatch.delenv("HARMONY_KERNEL_TWIN")
    T_DV.use_device(True, device="cpu")
    keys = [J_B.PrivateKey.generate(bytes([40 + i])) for i in range(N_KEYS)]
    table = T_DV.CommitteeTable([k.pub.point for k in keys])
    agg = J_B.aggregate_sigs([k.sign_hash(PAYLOAD) for k in keys[:3]])
    h = t_hash_to_g2(PAYLOAD)
    SC = PACKAGES["port"].SC
    s = SC.VerifyScheduler(manual=True)
    batches, dispatches = [], T_DV.COUNTERS["batch_verify"]
    fallbacks = T_DV.COUNTERS["ref_fallback"]
    run_agg = s._run_agg
    s._run_agg = lambda batch: batches.append(len(batch)) or run_agg(batch)
    items, slots = SC.FILL["items"], SC.FILL["slots"]
    cases = [(SC.Lane.SYNC, [1, 1, 1, 0], True),
             (SC.Lane.INGRESS, [1, 1, 1, 1], False),
             (SC.Lane.CONSENSUS, [1, 1, 1, 0], True)]
    futs = [s.submit_agg(table, bits, h, agg.point, lane=lane)
            for lane, bits, _ in cases]
    assert s._flush_once() and not s._flush_once()
    assert [f.result(1) for f in futs] == [want for _, _, want in cases]
    assert [J_RB.verify_aggregate(
        [k.pub.point for k, b in zip(keys, bits) if b], PAYLOAD, agg.point)
        for _, bits, _ in cases] == [want for _, _, want in cases]
    assert batches == [3]
    assert T_DV.COUNTERS["batch_verify"] == dispatches + 1
    assert (SC.FILL["items"] - items, SC.FILL["slots"] - slots) == (3, 8)
    assert T_DV.COUNTERS["ref_fallback"] == fallbacks
