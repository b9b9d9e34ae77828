"""The port's node with the Handel overlay against the JAX package's:
ports of the localnet arcs of tests/test_aggregation.py (two rounds
through the overlay, the 64-slot assembly's bounded inbound, and the
direct mode's byte parity with an unconfigured node).

The JAX package's runs on its host route; the port's in host mode and,
for one overlay round, in device mode (the twins: every partial's check
through its scheduler and ``device.py``).  Comparisons are exact: the
wire bytes of a direct-mode round (every topic and payload, in order,
byte for byte between the packages), block hashes and roots, and the
commit proofs, which each package's chain accepts from the other's.
Where the overlay's timing decides which partials merge first, the
commit bitmaps may differ; there each package's chain must accept the
other's proof.
"""

import importlib
import time
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "DV": "device", "BC": "core.blockchain", "GEN": "core.genesis",
    "KV": "core.kv", "POOL": "core.tx_pool", "MB": "multibls",
    "NODE": "node.node", "REG": "node.registry", "P2P": "p2p",
    "ENG": "chain.engine", "SCHED": "sched", "RAW": "core.rawdb",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


@pytest.fixture(autouse=True)
def _host_unless_asked(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    J.DV.use_device(False)
    T.DV.use_device(False)
    T.SCHED.reset()
    fallbacks = T.DV.COUNTERS["ref_fallback"]
    yield
    T.SCHED.reset()
    T.DV.use_device(None)
    J.DV.use_device(None)
    assert T.DV.COUNTERS["ref_fallback"] == fallbacks


def _localnet(m, n_nodes=4, keys_per_node=1, aggregation=None):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=n_nodes * keys_per_node)
    net = m.P2P.InProcessNetwork()
    nodes = []
    for i in range(n_nodes):
        chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        reg = m.REG.Registry(blockchain=chain, txpool=pool,
                             host=net.host(f"node{i}"))
        if aggregation is not None:
            reg.set("aggregation", aggregation)
        ks = bls_keys[i * keys_per_node:(i + 1) * keys_per_node]
        node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(ks))
        # the retrying sender re-publishes on a one-second timer: off in
        # these pumped rounds, whose order must not depend on the clock
        # (under load a retry would reorder the pump and so the votes)
        node.sender.RETRY_INTERVAL = node.sender.SLOW_INTERVAL = 3600.0
        nodes.append(node)
    return nodes, net


def _pump_agg(nodes, done, budget_s=30.0):
    deadline = time.monotonic() + budget_s
    while time.monotonic() < deadline:
        busy = any([n.process_pending() for n in nodes])
        now = time.monotonic()
        for n in nodes:
            n._aggregation_tick(now)
        if done():
            return True
        if not busy:
            time.sleep(0.005)
    return done()


def _accepts(m, blocks, proofs):
    genesis, _, _ = m.GEN.dev_genesis(n_keys=4)
    cell = []
    chain = m.BC.Blockchain(
        m.KV.MemKV(), genesis, blocks_per_epoch=16,
        engine=m.ENG.Engine(lambda s, e: m.ENG.EpochContext(
            cell[0].committee_for_epoch(e))))
    cell.append(chain)
    return chain.insert_chain([m.RAW.decode_block(b) for b in blocks],
                              commit_sigs=proofs, verify_seals=True)


def _handel_commits(m):
    nodes, _ = _localnet(m, aggregation="handel")
    assert all(n.aggregator is not None for n in nodes)
    for target in (1, 2):
        leader = next(n for n in nodes if n.is_leader)
        leader.start_round_if_leader()
        assert _pump_agg(nodes, lambda: all(
            n.chain.head_number == target for n in nodes)), \
            f"round {target} never committed through the overlay"
    stats = [n.aggregation_stats() for n in nodes]
    assert sum(s["merged"] for s in stats) > 0
    assert sum(s["forged"] for s in stats) == 0
    assert sum(s["fallbacks"] for s in stats) == 0
    assert all(n.chain.read_commit_sig(2) is not None for n in nodes)
    assert all(n.dropped_messages == 0 for n in nodes)
    chain = nodes[0].chain
    first = chain.block_by_number(1).header
    return ((first.hash(), first.root, first.receipt_root),
            [m.RAW.encode_block(chain.block_by_number(k), CHAIN_ID)
             for k in (1, 2)],
            [chain.read_commit_sig(k) for k in (1, 2)])


_JAX: dict = {}


@pytest.mark.parametrize("mode", ("host", "device"))
def test_handel_localnet_commits(mode, monkeypatch):
    """Two rounds through the overlay: merged partials, none forged, no
    stall fallback; the first block equal in both packages, and each
    package's chain accepts the other's blocks and commit proofs."""
    if "handel" not in _JAX:
        _JAX["handel"] = _handel_commits(J)
    want = _JAX["handel"]
    if mode == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T.DV.use_device(True, device="cpu")
        T.SCHED.reset()
        before = T.DV.COUNTERS["agg_verify"]
    got = _handel_commits(T)
    if mode == "device":
        assert T.DV.COUNTERS["agg_verify"] > before
        T.DV.use_device(False)
    assert got[0] == want[0]
    assert _accepts(T, want[1], want[2]) == 2
    assert _accepts(J, got[1], got[2]) == 2


def test_handel_64_slot_assembly_bounded_inbound():
    """A 64-slot committee (4 operators of 16 keys) assembles both quorums
    through the ladder; the leader ingests at most 16 vote messages."""
    nodes, _ = _localnet(T, 4, keys_per_node=16, aggregation="handel")
    leader = next(n for n in nodes if n.is_leader)
    assert all(len(n.aggregator.home_slots) == 16 for n in nodes)
    assert nodes[0].aggregator.n == 64
    leader.start_round_if_leader()
    assert _pump_agg(nodes, lambda: all(n.chain.head_number == 1
                                        for n in nodes))
    inbound = sum(v for (_ph, kind), v in leader.host.inbound_votes.items()
                  if kind in ("ballot", "aggregate"))
    assert inbound <= 64 // 4
    assert sum(n.aggregation_stats()["forged"] for n in nodes) == 0


def _record_wire(nodes):
    rec = []
    for n in nodes:
        orig = n.host.publish

        def pub(topic, payload, _orig=orig, _name=n.host.name):
            rec.append((_name, topic, payload))
            return _orig(topic, payload)

        n.host.publish = pub
    return rec


def _one_recorded_round(m, aggregation):
    nodes, _ = _localnet(m, aggregation=aggregation)
    rec = _record_wire(nodes)
    next(n for n in nodes if n.is_leader).start_round_if_leader()
    assert _pump_agg(nodes, lambda: all(n.chain.head_number == 1
                                        for n in nodes))
    return rec


def test_direct_mode_bit_parity():
    """The direct mode's round is byte-identical to an unconfigured
    node's, with no aggregation-topic publish, and byte-identical to the
    JAX package's round; the overlay really moves votes off the topic."""
    base = _one_recorded_round(T, None)
    direct = _one_recorded_round(T, "direct")
    assert base == direct
    assert all("/aggregation/" not in topic for _, topic, _p in base)
    assert base == _one_recorded_round(J, None)
    handel = _one_recorded_round(T, "handel")
    assert any("/aggregation/" in topic for _, topic, _p in handel)
