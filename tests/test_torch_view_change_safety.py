"""A node that has voted to leave a view casts no vote in it.

The JAX package's node keeps voting in the view it is leaving: a
validator whose VIEWCHANGE (sent before PREPARED reached it, so it
carries no prepared block) is out still prepares and commits the old
leader's proposal.  The old leader can then commit block X at a height
while the NEWVIEW, built from those view-change votes, lets the new
leader propose block Y there, which the others commit: the chain forks.
The chaos scenario rolling_restart ran into it on the card.  The port's
node casts no PREPARE or COMMIT vote in the old view once it is in a
view change, so every node ends with one block at the height.  It still
keeps the old view's announced block pending: a lone node that timed out
inserts the block that the other three commit, without a sync.

The same pumped localnet of four nodes of one key runs on both
packages: two validators time out before the leader's announce, the
third after voting PREPARE and before PREPARED reaches it; or one
validator alone times out before the announce."""

import importlib
import types

import pytest

CHAIN_ID = 2
_MODULES = {
    "DV": "device", "BC": "core.blockchain", "GEN": "core.genesis",
    "KV": "core.kv", "POOL": "core.tx_pool", "MB": "multibls",
    "NODE": "node.node", "REG": "node.registry", "P2P": "p2p",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    J.DV.use_device(False)
    T.DV.use_device(False)
    yield
    T.DV.use_device(None)
    J.DV.use_device(None)


def _pump(nodes):
    for _ in range(60):
        if not any(n.process_pending() for n in nodes):
            break


def _nodes(m):
    genesis, _, keys = m.GEN.dev_genesis(n_keys=4)
    net = m.P2P.InProcessNetwork()
    nodes = []
    for i in range(4):
        chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
        reg = m.REG.Registry(blockchain=chain,
                             txpool=m.POOL.TxPool(CHAIN_ID, 0, chain.state),
                             host=net.host(f"node{i}"))
        node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([keys[i]]))
        # pumped: no clock-driven re-publishes
        node.sender.RETRY_INTERVAL = node.sender.SLOW_INTERVAL = 3600.0
        nodes.append(node)
    return nodes


def _late_view_change(m):
    """Heights and blocks at height 1 after the interleaving; the
    leader's proposal X and each node's block there."""
    nodes = _nodes(m)
    try:
        leader = next(n for n in nodes if n.is_leader)
        validators = [n for n in nodes if n is not leader]
        nxt = next(n for n in validators
                   if n.leader_key(leader.view_id + 1)
                   == n.keys[0].pub.bytes)
        late = [nxt, next(v for v in validators if v is not nxt)]
        early = [v for v in validators if v not in late]
        for v in late:  # time out before the announce
            v.start_view_change()
        proposed = leader.start_round_if_leader()
        for v in validators:
            v.process_pending()
        leader.process_pending()
        for v in early:  # voted PREPARE, times out before PREPARED
            v.start_view_change()
        _pump(nodes)
        new_leader = next(n for n in nodes if n.is_leader)
        new_leader.start_round_if_leader()
        _pump(nodes)
        return (nodes.index(leader), [n.chain.head_number for n in nodes],
                [n.chain.block_by_number(1).hash() == proposed.hash()
                 for n in nodes],
                len({n.chain.block_by_number(1).hash() for n in nodes}))
    finally:
        for n in nodes:
            n.stop()


def test_the_jax_packages_node_forks():
    leader, heads, is_x, distinct = _late_view_change(J)
    assert heads == [1, 1, 1, 1]
    # the old leader committed its proposal, the others the new view's
    assert distinct == 2 and is_x[leader] and sum(is_x) == 1


def test_the_ports_node_keeps_one_block_at_the_height():
    leader, heads, is_x, distinct = _late_view_change(T)
    assert heads == [1, 1, 1, 1]
    assert distinct == 1 and not any(is_x)


@pytest.mark.parametrize("root", ("harmony_tpu", "harmony_tpu_torch"))
def test_a_lone_node_in_a_view_change_inserts_the_committed_block(root):
    m = J if root == "harmony_tpu" else T
    nodes = _nodes(m)
    try:
        leader = next(n for n in nodes if n.is_leader)
        lone = next(n for n in nodes if n is not leader)
        lone.start_view_change()
        proposed = leader.start_round_if_leader()
        _pump(nodes)
        assert [n.chain.head_number for n in nodes] == [1, 1, 1, 1]
        assert {n.chain.block_by_number(1).hash() for n in nodes} == {
            proposed.hash()}
    finally:
        for n in nodes:
            n.stop()
