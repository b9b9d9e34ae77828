"""The port's node against the JAX package's through view changes and
pipelining: ports of tests/test_node_net.py's view-change arcs (a leader
lost before it proposes, a leader lost after PREPARED whose block the
NEWVIEW carries) and of its pipelined commit-and-propose arc.

Each arc runs on both packages with the same keys; the JAX package's on
its host route, the port's in host mode and, for the carried block, also
in device mode (the twins, every node's ``Blockchain`` wired to an
``Engine``).  Comparisons are exact: block hashes, state, transaction
and receipts roots and the stored commit proofs at every height, and the
re-proposed block's hash and view.
"""

import importlib
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "DV": "device", "BC": "core.blockchain", "GEN": "core.genesis",
    "KV": "core.kv", "POOL": "core.tx_pool", "MB": "multibls",
    "NODE": "node.node", "REG": "node.registry", "P2P": "p2p",
    "ENG": "chain.engine", "SCHED": "sched",
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


def _localnet(m, engine=False):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=4)
    net = m.P2P.InProcessNetwork()
    nodes = []
    for i in range(4):
        cell = []
        eng = (m.ENG.Engine(lambda s, e, cell=cell: m.ENG.EpochContext(
            cell[0].committee_for_epoch(e))) if engine else None)
        chain = m.BC.Blockchain(m.KV.MemKV(), genesis, engine=eng,
                                blocks_per_epoch=16)
        cell.append(chain)
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        reg = m.REG.Registry(blockchain=chain, txpool=pool,
                             host=net.host(f"node{i}"))
        node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([bls_keys[i]]))
        # the retrying sender re-publishes on a one-second timer: off in
        # these pumped rounds, whose order must not depend on the clock
        # (under load a retry would reorder the pump and so the votes)
        node.sender.RETRY_INTERVAL = node.sender.SLOW_INTERVAL = 3600.0
        nodes.append(node)
    return nodes, net


def _pump(nodes):
    for _ in range(50):
        if not any(n.process_pending() for n in nodes):
            break


def _digest(node):
    chain = node.chain
    out = []
    for num in range(1, chain.head_number + 1):
        h = chain.block_by_number(num).header
        out.append((h.hash(), h.root, h.tx_root, h.receipt_root,
                    h.view_id, chain.read_commit_sig(num)))
    return out


_JAX: dict = {}


def _jax(scenario):
    if scenario not in _JAX:
        _JAX[scenario] = scenario(J)
    return _JAX[scenario]


def _replaces_failed_leader(m):
    nodes, net = _localnet(m)
    leader = next(n for n in nodes if n.is_leader)
    net.partitioned.add(leader.host.name)
    live = [n for n in nodes if n is not leader]
    for n in live:
        n.start_view_change()
    _pump(nodes)
    new_leader = next(n for n in live if n.is_leader)
    assert new_leader is not leader
    new_leader.start_round_if_leader()
    _pump(nodes)
    assert all(n.chain.head_number == 1 for n in live)
    assert leader.chain.head_number == 0
    assert all(not n.in_view_change for n in live)
    assert all(_digest(n) == _digest(live[0]) for n in live)
    return nodes.index(new_leader), [n.view_id for n in nodes], \
        _digest(live[0])


def test_view_change_replaces_failed_leader():
    assert _replaces_failed_leader(T) == _jax(_replaces_failed_leader)


def _carries_prepared_block(m, engine=False):
    nodes, net = _localnet(m, engine=engine)
    leader = next(n for n in nodes if n.is_leader)
    validators = [n for n in nodes if n is not leader]
    proposed = leader.start_round_if_leader()
    for v in validators:
        v.process_pending()
    leader.process_pending(max_msgs=2)
    for v in validators:
        v.process_pending()
    net.partitioned.add(leader.host.name)
    assert all(v._prepared_proof is not None for v in validators)
    prepared = validators[0]._prepared_proof
    for v in validators:
        v.start_view_change()
    _pump(nodes)
    new_leader = next(v for v in validators if v.is_leader)
    assert new_leader._reproposal is not None or new_leader._proposed
    new_leader.start_round_if_leader()
    _pump(nodes)
    assert all(v.chain.head_number == 1 for v in validators)
    committed = validators[0].chain.block_by_number(1)
    assert committed.hash() == proposed.hash()
    assert committed.header.view_id == proposed.header.view_id
    assert all(v.dropped_messages == 0 for v in validators)
    return proposed.hash(), prepared, _digest(validators[0])


@pytest.mark.parametrize("mode", ("host", "device"))
def test_view_change_carries_prepared_block(mode, monkeypatch):
    """The leader vanishes after PREPARED: the NEWVIEW carries the
    prepared proof and the new leader re-proposes the same block, which
    commits; the prepared proof and every height are equal in both
    packages."""
    if mode == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T.DV.use_device(True, device="cpu")
        T.SCHED.reset()
        before = T.DV.COUNTERS["agg_verify"]
    assert _carries_prepared_block(T, engine=mode == "device") == \
        _jax(_carries_prepared_block)
    if mode == "device":
        assert T.DV.COUNTERS["agg_verify"] > before


def _pipelining(m):
    nodes, _ = _localnet(m)
    leader = next(n for n in nodes if n.is_leader)
    for n in nodes:
        n.pipelining = True
        n.block_time = 0.0
    leader.start_round_if_leader()
    for _ in range(200):
        if all(n.chain.head_number >= 2 for n in nodes):
            break
        if not any(n.process_pending(max_msgs=4) for n in nodes):
            break
    assert all(n.chain.head_number >= 2 for n in nodes)
    return _digest(nodes[0])[:2]


def test_precommit_and_propose_pipelining():
    assert _pipelining(T) == _jax(_pipelining)
