"""The port's link conditioner (``harmony_tpu_torch/chaostest/netem.py``)
against the JAX package's: link-spec parsing, the seed-deterministic
delivery schedule, match precedence and the rate cap, both in-process
hubs under loss, delay and duplication, and the netem family on the
metrics registry.  Every case runs on both packages with the same specs,
seeds and scripts and compares the results exactly."""

from __future__ import annotations

import dataclasses
import time

import pytest

from harmony_tpu import metrics as JM
from harmony_tpu import p2p as JP
from harmony_tpu.chaostest import netem as JN
from harmony_tpu_torch import metrics as TM
from harmony_tpu_torch import p2p as TP
from harmony_tpu_torch.chaostest import netem as TN

PACKAGES = {"jax": (JN, JP, JM), "port": (TN, TP, TM)}

GOOD_SPECS = [
    "a->b delay=300ms jitter=50ms loss=5% dup=1% reorder=10% rate=1mbps",
    "a->b delay=1.5s", "a->b delay=40", "a->b loss=0.25", "a->b rate=64k",
    "a->b rate=512", "a->b", "*->* rtt=50..150ms jitter=10ms loss=0.5%",
    "a-> loss=1",
    {"src": "x", "dst": "*", "delay_ms": 10, "rtt_ms": [20, 40]},
]

BAD_SPECS = [
    "a->b loss=1.5", "a->b loss=-0.1", "a->b delay=-5ms", "a->b speed=3",
    "a->b delay", "delay=3ms", "a->b rtt=50ms", "a->b rtt=150..50ms",
    "a->b rate=fast", "a->b delay=xms",
    {"src": "a", "dst": "b", "bogus": 1}, 42,
]


@pytest.mark.parametrize("spec", GOOD_SPECS, ids=range(len(GOOD_SPECS)))
def test_parse_gives_the_same_rule(spec):
    got = {k: dataclasses.asdict(ne.parse_link(spec, tag="phase:p"))
           for k, (ne, _, _) in PACKAGES.items()}
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_parse_rejects_the_same_specs(spec):
    for ne, _, _ in PACKAGES.values():
        with pytest.raises(ValueError):
            ne.parse_link(spec)


def test_partition_rules_are_the_same_total_loss():
    got = {}
    for k, (ne, _, _) in PACKAGES.items():
        rules = ne.partition_rules("s0n2", tag="phase:x")
        nm = ne.NetEm(seed=1)
        nm.add(*rules)
        got[k] = ([dataclasses.asdict(r) for r in rules],
                  nm.decide("s0n2", "s0n1", 10).drop,
                  nm.decide("s0n1", "s0n2", 10).drop,
                  nm.decide("s0n0", "s0n1", 10))
    assert got["port"] == got["jax"]
    assert got["port"][1:] == (True, True, None)


def _script(ne, seed):
    """One scripted event sequence through a rule with every event class
    and a WAN matrix rule -> the full schedule: drop set, per-copy delays,
    duplicates, reorder flags, the per-pair RTTs and the delivery order."""
    nm = ne.NetEm(seed=seed)
    nm.add({"src": "*", "dst": "*", "delay_ms": 40.0, "jitter_ms": 20.0,
            "loss": 0.2, "dup": 0.15, "reorder": 0.1})
    (wan,) = nm.add("n0->* rtt=50..150ms jitter=10ms loss=0.5%")
    events, order = [], []
    for i in range(400):
        src, dst = f"n{i % 4}", f"n{(i + 1 + i // 7) % 4}"
        d = nm.decide(src, dst, 100 + i)
        events.append((src, dst, d.drop, d.delays, d.reordered))
        if not d.drop:
            for c, dl in enumerate(d.delays):
                order.append((dl, i, c))
    order.sort()
    rtts = [nm.pair_rtt_ms(wan, "n0", f"n{j}") for j in range(1, 4)]
    return events, order, rtts, nm.totals()


@pytest.mark.parametrize("seed", [9, 10, 79])
def test_same_seed_same_delivery_schedule_in_both_packages(seed):
    assert _script(TN, seed) == _script(JN, seed)


def test_schedule_exercises_every_event_class():
    counts = {}
    for k, (ne, _, _) in PACKAGES.items():
        nm = ne.NetEm(seed=9)
        nm.add({"src": "*", "dst": "*", "delay_ms": 40.0, "jitter_ms": 20.0,
                "loss": 0.2, "dup": 0.15, "reorder": 0.1})
        drops = dups = reorders = 0
        for i in range(400):
            d = nm.decide("a", "b", i)
            drops += d.drop
            dups += (not d.drop and len(d.delays) == 2)
            reorders += d.reordered
        counts[k] = (drops, dups, reorders, nm.totals())
    assert counts["port"] == counts["jax"]
    drops, dups, reorders, _ = counts["port"]
    assert drops and dups and reorders and 0.1 < drops / 400 < 0.3


def test_match_precedence_and_rate_cap_agree():
    got = {}
    for k, (ne, _, _) in PACKAGES.items():
        nm = ne.NetEm(seed=1)
        for spec in ("*->* delay=10ms", "a->* delay=20ms", "*->b delay=30ms",
                     "a->b delay=40ms"):
            nm.add(spec)
        seen = [nm.decide(s, d, 1).delays for s, d in
                (("a", "b"), ("a", "c"), ("c", "b"), ("c", "d"))]
        nm.add("a->b delay=50ms")
        seen.append(nm.decide("a", "b", 1).delays)
        seen.append(nm.remove_tag(""))
        clk = [0.0]
        capped = ne.NetEm(seed=1, clock=lambda: clk[0])
        capped.add("a->b rate=1000")
        seen += [capped.decide("a", "b", 500).delays,
                 capped.decide("a", "b", 500).delays]
        clk[0] = 10.0
        seen.append(capped.decide("a", "b", 250).delays)
        got[k] = seen
    assert got["port"] == got["jax"]
    assert got["port"][4][0] == pytest.approx(0.050)
    assert [d[0] for d in got["port"][6:]] == pytest.approx([0.5, 1.0, 0.25])


def _hub(p2p, ne, rule, names=("a", "b", "c")):
    net = p2p.InProcessNetwork()
    hosts = {n: net.host(n) for n in names}
    inbox = {n: [] for n in names}
    for n, h in hosts.items():
        h.subscribe("t", lambda _t, p, frm, n=n: inbox[n].append((frm, p)))
    net.netem = ne.NetEm(seed=1)
    net.netem.add(rule)
    return net, hosts, inbox


def _settle(inbox, want, budget=5.0):
    deadline = time.monotonic() + budget
    while time.monotonic() < deadline and any(
            len(inbox[n]) < k for n, k in want.items()):
        time.sleep(0.01)


@pytest.mark.parametrize("case", ["loss", "delay", "dup"])
def test_hub_conditions_delivery_as_the_jax_hub_does(case):
    rule, pubs, want = {
        "loss": ("a->b loss=1", [("a", b"ping"), ("b", b"pong")],
                 {"c": 1, "a": 1}),
        "delay": ("a->* delay=120ms", [("a", b"slow")], {"b": 1, "c": 1}),
        "dup": ("a->b delay=20ms dup=100%", [("a", b"twice")], {"b": 2}),
    }[case]
    got = {}
    for k, (ne, p2p, _) in PACKAGES.items():
        net, hosts, inbox = _hub(p2p, ne, rule)
        try:
            for src, payload in pubs:
                hosts[src].publish("t", payload)
            _settle(inbox, want)
            time.sleep(0.05)
            got[k] = ({n: sorted(v) for n, v in inbox.items()},
                      net.netem.totals())
        finally:
            net.netem.close()
    assert got["port"] == got["jax"]
    inbox, totals = got["port"]
    if case == "loss":
        assert inbox["b"] == [] and ("a", b"ping") in inbox["c"]
        assert ("b", b"pong") in inbox["a"] and totals["dropped"] == 1
    elif case == "delay":
        assert inbox["b"] == inbox["c"] == [("a", b"slow")]
        assert totals["delayed"] == 2
    else:
        assert inbox["b"] == [("a", b"twice")] * 2
        assert totals["duplicated"] == 1


def test_netem_family_on_the_registry():
    """The drop on a rule shows in the module's family and in the
    process registry of each package (the port finds the family through
    its own module name)."""
    for k, (ne, p2p, metrics) in PACKAGES.items():
        net, hosts, _ = _hub(p2p, ne, "a->b loss=1", names=("a", "b"))
        try:
            hosts["a"].publish("t", b"x")
        finally:
            net.netem.close()
        text = ne.expose()
        assert "# TYPE harmony_netem_events_total counter" in text, k
        assert ('harmony_netem_events_total{event="dropped",rule="a->b"}'
                in text), k
        assert "harmony_netem_events_total" in metrics.Registry().expose(), k
