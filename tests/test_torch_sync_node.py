"""The port's behind node and epoch chain against the JAX package's: ports
of tests/test_node_net.py's behind node that spins up its downloader (here
with every synced seal checked) and of tests/test_epochchain.py (inserts,
refusals, idempotence and the beacon epoch feed).

Each scenario runs on both packages with the same inputs (``dev_genesis``
keys, seeded committees) and returns what it produced: heads, rounds,
block hashes, state roots, committees, refusals.  The two must be equal.
The JAX package checks seals on its host route; the port on its host
route and in device mode, on the CPU by the bigint twins
(``HARMONY_KERNEL_TWIN=1``).  Shared helpers come from
tests/test_torch_sync.py.
"""

import time

import pytest

from test_torch_sync import J, T, _both, _checked_chain, _device_mode, \
    _digest, _jax

CHAIN_ID = 2


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


def _localnet(m, n_nodes=4, device=False):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=n_nodes)
    net = m.P2P.InProcessNetwork()
    nodes = []
    for i in range(n_nodes):
        chain = _checked_chain(m, genesis, device)
        reg = m.REG.Registry(blockchain=chain,
                             txpool=m.POOL.TxPool(CHAIN_ID, 0, chain.state),
                             host=net.host(f"node{i}"))
        node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([bls_keys[i]]))
        # pumped rounds: no retry timer reorders the votes
        node.sender.RETRY_INTERVAL = node.sender.SLOW_INTERVAL = 3600.0
        nodes.append(node)
    return nodes, genesis, net


def _pump(nodes, rounds=50):
    for _ in range(rounds):
        if not any(n.process_pending() for n in nodes):
            break


# -- a behind node spins up its downloader -----------------------------------


def _behind_node(m, device=False):
    """Two rounds commit; a node with no keys joins late with a registry
    downloader over a sync server of node 0's chain, every synced seal
    checked.  Future-round gossip spins the downloader up once; the node
    catches up and rejoins at the network's round."""
    nodes, genesis, net = _localnet(m, device=device)
    for _ in range(2):
        next(n for n in nodes if n.is_leader).start_round_if_leader()
        _pump(nodes)
    assert all(n.chain.head_number == 2 for n in nodes)
    chain = _checked_chain(m, genesis, device)
    srv = m.STREAM.SyncServer(nodes[0].chain, listen_port=0)
    reg = m.REG.Registry(blockchain=chain,
                         txpool=m.POOL.TxPool(CHAIN_ID, 0, chain.state),
                         host=net.host("late"))
    late = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([]))
    reg.set("downloader", m.SYNC.Downloader(
        chain, [m.STREAM.SyncClient(srv.port)], verify_seals=True))
    try:
        keys = m.MB.PrivateKeys.from_keys([m.B.PrivateKey.generate(b"\x07")])
        msg = m.MSG.sign_message(m.MSG.FBFTMessage(
            msg_type=m.MSG.MsgType.ANNOUNCE, view_id=3, block_num=3,
            block_hash=b"\x01" * 32,
            sender_pubkeys=[k.pub.bytes for k in keys]), keys)
        env = m.ING.pack_envelope(m.ING.MessageCategory.CONSENSUS,
                                  int(msg.msg_type), m.MSG.encode_message(msg))
        for _ in range(late.ahead_threshold):
            late._handle(env)
        assert late._syncing or late._sync_done.is_set()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            late.process_pending()
            if late.chain.head_number == 2 and not late._syncing:
                break
            time.sleep(0.02)
        return (late.chain.head_number, late.sync_spinups, late.block_num,
                late.dropped_messages, _digest(late.chain),
                _digest(nodes[0].chain) == _digest(late.chain))
    finally:
        late.stop()
        srv.close()
        if late._sync_thread is not None:
            late._sync_thread.join(timeout=30)
            assert not late._sync_thread.is_alive()


@pytest.mark.parametrize("mode", ("host", "device"))
def test_behind_node_spins_up_sync(mode, monkeypatch):
    want = _jax(_behind_node)
    if mode == "device":
        _device_mode(monkeypatch)
        before = T.DV.COUNTERS["batch_verify"]
    got = _behind_node(T, device=None if mode == "device" else False)
    assert got == want
    head, spinups, block_num, dropped, _, same = got
    assert (head, spinups, block_num, dropped, same) == (2, 1, 3, 0, True)
    if mode == "device":
        assert T.DV.COUNTERS["batch_verify"] > before


# -- the epoch chain and its feed --------------------------------------------


def _ec_keys(m):
    keys = [m.B.PrivateKey.generate(bytes([70 + i])) for i in range(4)]
    return keys, [k.pub.bytes for k in keys]


def _ec_seal(m, header, keys, idx):
    payload = m.SIG.construct_commit_payload(
        header.hash(), header.block_num, header.view_id, True)
    agg = m.B.aggregate_sigs([keys[i].sign_hash(payload) for i in idx])
    mask = m.MASK.Mask([k.pub.point for k in keys])
    for i in idx:
        mask.set_bit(i, True)
    return agg.bytes, mask.mask_bytes()


def _elected_state(m, serialized, shard_id=1):
    S = m.SHARD
    return S.State(epoch=1, shards=[S.Committee(
        shard_id=shard_id,
        slots=[S.Slot(ecdsa_address=bytes([i]) * 20, bls_pubkey=k)
               for i, k in enumerate(serialized)])])


def _epochchain(m, device=False):
    keys, serialized = _ec_keys(m)
    eng = m.ENG.Engine(lambda s, e: m.ENG.EpochContext(serialized),
                       device=device)
    ec = m.EC.EpochChain(m.KV.MemKV(), lambda s: serialized, engine=eng)
    resolved = [ec.committee_for(1, 0), ec.committee_for(1, 5)]
    h = m.HDR.Header(shard_id=0, block_num=16, epoch=0, view_id=16,
                     shard_state=b"elected")
    ec.insert(h, _elected_state(m, serialized), *_ec_seal(m, h, keys,
                                                          [0, 1, 2]))
    resolved.append(ec.committee_for(1, 1))
    refused = []
    other = m.EC.EpochChain(m.KV.MemKV(), lambda s: serialized, engine=eng)
    h2 = m.HDR.Header(shard_id=0, block_num=16, epoch=0, view_id=16)
    for state, idx in ((None, [0, 1, 2]),
                       (_elected_state(m, serialized), [0])):
        with pytest.raises(m.EC.EpochChainError) as e:
            other.insert(h2, state, *_ec_seal(m, h2, keys, idx))
        refused.append(str(e.value))
    # no engine: idempotent re-insert of an epoch already followed
    plain = m.EC.EpochChain(m.KV.MemKV(), lambda s: serialized)
    plain.insert(h2, _elected_state(m, serialized))
    plain.insert(m.HDR.Header(shard_id=0, block_num=17, epoch=0, view_id=17),
                 _elected_state(m, serialized))
    return (resolved, ec.head_epoch(), ec.header_for_epoch(0).hash(),
            refused, other.head_epoch(), plain.header_for_epoch(0).hash())


@pytest.mark.parametrize("mode", ("host", "device"))
def test_epochchain_insert_refusals_and_idempotence(mode, monkeypatch):
    want = _jax(_epochchain)
    if mode == "device":
        _device_mode(monkeypatch)
        before = T.DV.COUNTERS["agg_verify"]
    got = _epochchain(T, device=None if mode == "device" else False)
    assert got == want
    resolved, head, _, refused, other_head, _ = got
    assert resolved[1] == [] and resolved[0] == resolved[2]
    assert head == 0 and other_head is None and len(refused) == 2
    if mode == "device":
        assert T.DV.COUNTERS["agg_verify"] > before


def _epoch_feed(m):
    _, serialized = _ec_keys(m)
    bpe = 4
    genesis, _, _ = m.GEN.dev_genesis()
    beacon = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=bpe)
    worker = m.W.Worker(beacon, m.POOL.TxPool(2, 0, beacon.state))
    for i in range(2 * bpe):
        block = worker.propose_block(view_id=i + 1)
        beacon.insert_chain([block], verify_seals=False)
        beacon.write_commit_sig(block.block_num, b"\x01" * 96 + b"\x0f")
    for epoch in (1, 2):
        m.RAW.write_shard_state(beacon.db, epoch,
                                _elected_state(m, serialized, 1))
    srv = m.STREAM.SyncServer(beacon, listen_port=0)
    try:
        client = m.STREAM.SyncClient(srv.port)
        ec = m.EC.EpochChain(m.KV.MemKV(), lambda s: serialized)
        feed = m.FEED.EpochFeed(ec, client, blocks_per_epoch=bpe)
        first = feed.feed_once()
        out = (first, ec.head_epoch(), ec.committee_for(1, 1),
               ec.committee_for(1, 2), feed.feed_once(),
               [ec.header_for_epoch(e).hash() for e in (0, 1)])
        client.close()
        return out
    finally:
        srv.close()


def test_epoch_feed_follows_beacon():
    first, head, c1, c2, again, _ = _both(_epoch_feed)
    assert (first, head, again) == (2, 1, 0) and c1 == c2 and c1
