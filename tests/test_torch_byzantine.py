"""The port's ByzantineNode (``harmony_tpu_torch/chaostest/byzantine.py``)
against the JAX package's, in pump-mode localnets as tests/test_byzantine.py
builds them: a double voter detected, its evidence included and applied,
an equivocating leader in both delivery postures, a withholding validator
and a leader of invalid proposals, and the wire spray.  Each arc runs on
both packages with the same keys and seeds (on the host route) and
compares the chain heads, block hashes, stored commit proofs, the slash
records and their effect on the state, and every message published on the
hub (the adversary's among them), byte for byte."""

from __future__ import annotations

import importlib
import random
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "DV": "device", "FX": "chaostest.fixtures", "BYZ": "chaostest.byzantine",
    "BC": "core.blockchain", "GEN": "core.genesis", "KV": "core.kv",
    "POOL": "core.tx_pool", "MB": "multibls", "NODE": "node.node",
    "REG": "node.registry", "P2P": "p2p", "SL": "staking.slash",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


@pytest.fixture(autouse=True)
def _host_route(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    J.DV.use_device(False)
    T.DV.use_device(False)
    yield
    T.DV.use_device(None)
    J.DV.use_device(None)


def _localnet(m, n_nodes=4, byz_index=None, behaviors=(), staking=False,
              blocks_per_epoch=16, ext_on=None):
    """tests/test_byzantine.py's localnet on package ``m``, with every
    message published on the hub recorded, by its sender."""
    genesis, ecdsa_keys, bls_keys = m.GEN.dev_genesis(
        n_accounts=n_nodes, n_keys=n_nodes)
    net = m.P2P.InProcessNetwork()
    sent = []
    route = net.route

    def recording(topic, payload, frm):
        sent.append((frm, topic, payload))
        return route(topic, payload, frm)
    net.route = recording
    ext = m.FX.external_bls_key(7) if ext_on is not None else None
    nodes = []
    for i in range(n_nodes):
        chain = m.BC.Blockchain(
            m.KV.MemKV(), genesis, blocks_per_epoch=blocks_per_epoch,
            finalizer=(m.FX.staking_finalizer(genesis, ecdsa_keys)
                       if staking else None))
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        if ext is not None:
            pool.add(m.FX.external_validator_stake(
                ecdsa_keys[0], ext, chain_id=CHAIN_ID), is_staking=True)
        reg = m.REG.Registry(blockchain=chain, txpool=pool,
                             host=net.host(f"node{i}"))
        keys = [bls_keys[i]] + ([ext] if ext_on == i else [])
        if i == byz_index:
            node = m.BYZ.ByzantineNode(
                reg, m.MB.PrivateKeys.from_keys(keys), behaviors=behaviors,
                adversary_keys=({ext.pub.bytes} if ext is not None
                                else None), seed=5)
        else:
            node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(keys))
        # the retrying sender re-publishes on a one-second timer: off in
        # these pumped rounds, whose order must not depend on the clock
        node.sender.RETRY_INTERVAL = node.sender.SLOW_INTERVAL = 3600.0
        nodes.append(node)
    return nodes, ecdsa_keys, ext, net, sent


def _pump(nodes, rounds=80):
    for _ in range(rounds):
        if not any(n.process_pending() for n in nodes):
            break


def _run_round(nodes):
    leaders = [n for n in nodes if n.is_leader]
    assert len(leaders) == 1
    leaders[0].start_round_if_leader()
    _pump(nodes)


def _chains(nodes):
    return [[(n.chain.block_by_number(b).hash(), n.chain.read_commit_sig(b))
             for b in range(1, n.chain.head_number + 1)] for n in nodes]


def _double_vote(m):
    nodes, ecdsa_keys, ext, _, sent = _localnet(
        m, 4, byz_index=2, behaviors=("double_vote",), staking=True,
        blocks_per_epoch=4, ext_on=2)
    byz = nodes[2]
    honest = [n for n in nodes if n is not byz]
    for _ in range(8):
        _run_round(nodes)
    chain = honest[0].chain
    included = [b for b in range(1, chain.head_number + 1)
                if chain.header_by_number(b).slashes]
    records = [(b, chain.header_by_number(b).slashes) for b in included]
    rec = m.SL.decode_records(records[0][1])[0] if records else None
    offender = ecdsa_keys[0].address()
    w = chain.state().validator(offender)
    return {
        "chains": _chains(nodes), "sent": sent,
        "actions": dict(byz.byz_actions),
        "detected": [n.double_sign_events for n in honest],
        "records": records,
        "evidence": None if rec is None else (rec.evidence.offender,
                                              rec.reporter),
        "validator": (w.status, w.total_delegation()),
        "reporter_balance": chain.state().balance(rec.reporter),
        "committee_2": chain.committee_for_epoch(2),
        "ext": ext.pub.bytes, "offender": offender,
    }


def _equivocate(m, twin_first):
    nodes, _, _, _, sent = _localnet(m, 4, byz_index=1,
                                     behaviors=("equivocate",))
    byz = nodes[1]
    assert byz.is_leader
    if twin_first:
        byz.byz_actions["equivocate"] = 1
    _run_round(nodes)
    return {"chains": _chains(nodes), "sent": sent,
            "actions": dict(byz.byz_actions),
            "voted": [n._announce_voted for n in nodes if n is not byz]}


def _withhold(m):
    nodes, _, _, _, sent = _localnet(m, 4, byz_index=3,
                                     behaviors=("withhold",))
    _run_round(nodes)
    return {"chains": _chains(nodes), "sent": sent,
            "actions": dict(nodes[3].byz_actions)}


def _invalid(m):
    nodes, _, _, _, sent = _localnet(m, 4, byz_index=1,
                                     behaviors=("invalid_proposal",))
    byz = nodes[1]
    assert byz.is_leader
    byz.start_round_if_leader()
    _pump(nodes)
    return {"chains": _chains(nodes), "sent": sent,
            "actions": dict(byz.byz_actions),
            "voted": [n._announce_voted for n in nodes if n is not byz]}


def _spray(m):
    nodes, _, _, net, sent = _localnet(m, 2, byz_index=1,
                                       behaviors=("wire_spray",))
    rng = random.Random(99)
    for _ in range(200):
        nodes[1]._spray_once(rng)
    nodes[0].process_pending()
    return {"sent": sent, "actions": dict(nodes[1].byz_actions),
            "invalid": net.invalid_total, "muted": sorted(net.muted),
            "head": nodes[0].chain.head_number}


def _both(arc):
    port, want = arc(T), arc(J)
    assert port["sent"], "nothing was published"
    return port, want


def test_double_voter_detected_included_applied():
    port, want = _both(_double_vote)
    assert port == want
    assert len(port["chains"][0]) >= 7
    assert port["actions"]["double_vote"] >= 1 and sum(port["detected"])
    assert port["records"], "no committed block carried the slash record"
    assert port["evidence"][0] == port["offender"]
    status, stake = port["validator"]
    assert status == 2
    assert 10**20 - stake == T.SL.apply_slash(10**20).total_slashed
    assert port["reporter_balance"] > 10**24
    assert port["ext"] not in port["committee_2"]


@pytest.mark.parametrize("twin_first", [False, True],
                         ids=["twin_second", "twin_first"])
def test_equivocating_leader(twin_first):
    port, want = _both(lambda m: _equivocate(m, twin_first))
    assert port == want
    honest = [c for i, c in enumerate(port["chains"]) if i != 1]
    if twin_first:
        # the committee prepared the twin: the round wedges, never forks
        assert all(c == [] for c in honest)
        assert all(v is not None for v in port["voted"])
    else:
        assert port["actions"]["equivocate"] == 1
        assert all(len(c) == 1 for c in honest)
        assert len({c[0][0] for c in honest}) == 1


def test_withholding_validator_follows_without_voting():
    port, want = _both(_withhold)
    assert port == want
    assert all(len(c) == 1 for c in port["chains"])
    assert port["actions"]["withhold"] >= 1
    assert not any(frm == "node3" for frm, _, _ in port["sent"])


def test_invalid_proposals_rejected_by_every_validator():
    port, want = _both(_invalid)
    assert port == want
    assert port["actions"]["invalid_proposal"] == 1
    assert all(c == [] for i, c in enumerate(port["chains"]) if i != 1)
    assert all(v is None for v in port["voted"])


def test_wire_spray_is_the_same_bytes_and_never_crashes():
    port, want = _both(_spray)
    assert port == want
    assert port["actions"]["wire_spray"] > 0 and port["invalid"] > 0
    assert port["head"] == 0
