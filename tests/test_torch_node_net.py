"""The port's node against the JAX package's: ports of the localnet arcs of
tests/test_node_net.py (commits over gossip, a partitioned validator, a
one-node committee's self-quorum, the VRF-gated proposal, operator leader
rotation; the view-change and pipelining arcs are in
tests/test_torch_node_view_change.py) and of its gossip, gater and
service-manager tests.

Each localnet runs on both packages with the same keys (``dev_genesis``).
The JAX package's runs on its host route.  The port's runs in host mode,
and for the commit arc also in device mode: every check through its
scheduler and ``device.py`` on the CPU by the bigint twins
(``HARMONY_KERNEL_TWIN=1``), each node's ``Blockchain`` wired to an
``Engine`` whose seal check re-runs each commit proof on insert.  All
comparisons are exact: block hashes, state, transaction and receipts
roots, the stored commit proofs, balances and verdicts.  A check bound
for CUDA on a machine without it raises ``DeviceError``; in the node's
tolerant pump that is a counted dropped message, never a verdict.
"""

import importlib
import time
import types

import pytest
import torch

CHAIN_ID = 2
_MODULES = {
    "B": "bls", "DV": "device", "BC": "core.blockchain",
    "GEN": "core.genesis", "KV": "core.kv", "POOL": "core.tx_pool",
    "TY": "core.types", "RAW": "core.rawdb", "MB": "multibls",
    "NODE": "node.node", "REG": "node.registry", "P2P": "p2p",
    "HOST": "p2p.host", "GATE": "p2p.gating", "SVC": "node.services",
    "ENG": "chain.engine", "VRF": "crypto_vrf", "SHARD": "shard.committee",
    "SCHED": "sched", "FI": "faultinject",
}


def _package(root):
    return types.SimpleNamespace(name=root, **{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")


@pytest.fixture(autouse=True)
def _no_twins_unless_asked(monkeypatch):
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


def _device_mode(monkeypatch):
    """The port's checks through its scheduler and device.py, on the CPU
    by the twins."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T.DV.use_device(True, device="cpu")
    T.SCHED.reset()


def _engine(m, cell):
    """An Engine over the chain's own committees, wired as the node's
    boot wires it: a committee provider over committee_for_epoch."""
    return m.ENG.Engine(
        lambda shard, epoch: m.ENG.EpochContext(
            cell[0].committee_for_epoch(epoch)))


def _localnet(m, n_nodes=4, keys_per_node=1, engine=False,
              aggregation=None):
    genesis, ecdsa_keys, bls_keys = m.GEN.dev_genesis(
        n_keys=n_nodes * keys_per_node)
    net = m.P2P.InProcessNetwork()
    nodes = []
    for i in range(n_nodes):
        cell = []
        chain = m.BC.Blockchain(
            m.KV.MemKV(), genesis, blocks_per_epoch=16,
            engine=_engine(m, cell) if engine else None)
        cell.append(chain)
        pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
        reg = m.REG.Registry(blockchain=chain, txpool=pool,
                             host=net.host(f"node{i}"))
        if aggregation is not None:
            reg.set("aggregation", aggregation)
        node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(
            bls_keys[i * keys_per_node:(i + 1) * keys_per_node]))
        # the retrying sender re-publishes on a one-second timer: off in
        # these pumped rounds, whose order must not depend on the clock
        # (under load a retry would reorder the pump and so the votes)
        node.sender.RETRY_INTERVAL = node.sender.SLOW_INTERVAL = 3600.0
        nodes.append(node)
    return nodes, ecdsa_keys, net


def _pump(nodes, rounds=50):
    for _ in range(rounds):
        if not any(n.process_pending() for n in nodes):
            break


def _digest(node):
    """Per height: the block hash, the state, transaction and receipts
    roots, and the stored commit proof."""
    chain = node.chain
    out = []
    for num in range(1, chain.head_number + 1):
        h = chain.block_by_number(num).header
        out.append((h.hash(), h.root, h.tx_root, h.receipt_root,
                    chain.read_commit_sig(num)))
    return out


def _accepts(m, genesis_of, blocks, proofs):
    """A fresh chain of package m, its Engine wired, inserts the blocks
    with their commit proofs, each seal checked."""
    genesis, _, _ = m.GEN.dev_genesis(n_keys=genesis_of)
    cell = []
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16,
                            engine=_engine(m, cell))
    cell.append(chain)
    mine = [m.RAW.decode_block(b) for b in blocks]
    return chain.insert_chain(mine, commit_sigs=proofs, verify_seals=True)


def _commits(m, engine=False):
    nodes, ecdsa_keys, _ = _localnet(m, engine=engine)
    leaders = [n for n in nodes if n.is_leader]
    assert len(leaders) == 1
    leaders[0].start_round_if_leader()
    _pump(nodes)
    assert all(n.chain.head_number == 1 for n in nodes)
    assert all(n.committed_blocks == 1 for n in nodes)
    to = b"\x0a" * 20
    tx = m.TY.Transaction(
        nonce=0, gas_price=1, gas_limit=25_000, shard_id=0, to_shard=0,
        to=to, value=777,
    ).sign(ecdsa_keys[0], CHAIN_ID)
    leaders = [n for n in nodes if n.is_leader]
    assert len(leaders) == 1
    leaders[0].pool.add(tx)
    leaders[0].start_round_if_leader()
    _pump(nodes)
    assert all(n.chain.head_number == 2 for n in nodes)
    assert all(n.chain.state().balance(to) == 777 for n in nodes)
    assert all(n.dropped_messages == 0 for n in nodes)
    digests = [_digest(n) for n in nodes]
    assert all(d == digests[0] for d in digests)
    assert all(p is not None for *_, p in digests[0])
    chain = nodes[0].chain
    blocks = [m.RAW.encode_block(chain.block_by_number(n), CHAIN_ID)
              for n in (1, 2)]
    return digests[0], blocks, [chain.read_commit_sig(n) for n in (1, 2)]


_JAX: dict = {}


def _jax(scenario):
    if scenario not in _JAX:
        _JAX[scenario] = scenario(J)
    return _JAX[scenario]


@pytest.mark.parametrize("mode", ("host", "device"))
def test_localnet_commits_blocks_over_gossip(mode, monkeypatch):
    """Two rounds (an empty block, a transfer): equal blocks, roots and
    commit proofs at every height in both packages, and each package's
    chain accepts the other's blocks with their commit proofs, every seal
    checked."""
    want = _jax(_commits)
    if mode == "device":
        _device_mode(monkeypatch)
        before = dict(T.DV.COUNTERS)
    got = _commits(T, engine=mode == "device")
    assert got[0] == want[0]
    assert got[1] == want[1] and got[2] == want[2]
    if mode == "device":
        # every vote, quorum proof and seal went through device.py: the
        # announce's and each phase's sender signatures, the QC checks,
        # and each node's seal check on insert
        assert T.DV.COUNTERS["verify"] > before["verify"]
        assert T.DV.COUNTERS["agg_verify"] - before["agg_verify"] >= 8
    assert _accepts(T, 4, want[1], want[2]) == 2
    assert _accepts(J, 4, got[1], got[2]) == 2
    # a proof with a flipped signature byte is refused in both
    bad = bytearray(got[2][1])
    bad[3] ^= 1
    for m in (J, T):
        with pytest.raises(m.BC.ChainError):
            _accepts(m, 4, got[1], [got[2][0], bytes(bad)])


def _partitioned(m):
    nodes, _, net = _localnet(m)
    victim = next(n for n in nodes if not n.is_leader)
    net.partitioned.add(victim.host.name)
    next(n for n in nodes if n.is_leader).start_round_if_leader()
    _pump(nodes)
    live = [n for n in nodes if n is not victim]
    assert all(n.chain.head_number == 1 for n in live)
    assert victim.chain.head_number == 0
    return _digest(live[0])


def test_localnet_tolerates_partitioned_validator():
    assert _partitioned(T) == _jax(_partitioned)


def _self_quorum(m):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=1)
    net = m.P2P.InProcessNetwork()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    reg = m.REG.Registry(blockchain=chain, txpool=pool,
                         host=net.host("solo"))
    node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(bls_keys))
    assert node.is_leader
    node.start_round_if_leader()
    assert node.chain.head_number == 1
    node.start_round_if_leader()
    assert node.chain.head_number == 2
    assert node.chain.read_commit_sig(1) is not None
    return _digest(node)


def test_single_node_committee_self_quorum():
    assert _self_quorum(T) == _jax(_self_quorum)


def _vrf_proposal(m):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=1)
    genesis.config.extra["vrf"] = 0  # active from epoch 0
    net = m.P2P.InProcessNetwork()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    reg = m.REG.Registry(blockchain=chain, txpool=pool, host=net.host("v"))
    node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys(bls_keys))
    parent_hash = chain.current_header().hash()
    block = node.start_round_if_leader()
    assert block is not None and block.header.vrf != b""
    out = m.VRF.verify(bls_keys[0].pub, parent_hash, block.header.vrf)
    assert len(out) == 32
    other = m.B.PrivateKey.generate(b"\x99")
    _, bad_proof = m.VRF.evaluate(other, parent_hash)
    with pytest.raises(ValueError):
        m.VRF.verify(bls_keys[0].pub, parent_hash, bad_proof)
    return block.header.vrf, out, _digest(node)


@pytest.mark.parametrize("mode", ("host", "device"))
def test_vrf_gated_proposal_carries_verifiable_proof(mode, monkeypatch):
    """The VRF proof (a BLS signature over the parent hash) and its output
    are equal in both packages; the port's check runs on its device path
    in device mode."""
    if mode == "device":
        _device_mode(monkeypatch)
        before = T.DV.COUNTERS["verify"]
    assert _vrf_proposal(T) == _jax(_vrf_proposal)
    if mode == "device":
        assert T.DV.COUNTERS["verify"] > before


def _rotation(m):
    genesis, _, bls_keys = m.GEN.dev_genesis(n_keys=4)
    genesis.config.leader_rotation_epoch = 0
    net = m.P2P.InProcessNetwork()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    serialized = [k.pub.bytes for k in bls_keys]
    S = m.SHARD
    state = S.State(epoch=0, shards=[S.Committee(shard_id=0, slots=[
        S.Slot(ecdsa_address=b"\xaa" * 20, bls_pubkey=serialized[0]),
        S.Slot(ecdsa_address=b"\xaa" * 20, bls_pubkey=serialized[1]),
        S.Slot(ecdsa_address=b"\xaa" * 20, bls_pubkey=serialized[2]),
        S.Slot(ecdsa_address=b"\xbb" * 20, bls_pubkey=serialized[3]),
    ])])
    m.RAW.write_shard_state(chain.db, 0, state)
    chain._committee_cache.clear()
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    reg = m.REG.Registry(blockchain=chain, txpool=pool, host=net.host("r"))
    node = m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([bls_keys[0]]))
    got = [node.leader_key(v) for v in range(4)]
    assert got == [serialized[0], serialized[3]] * 2
    genesis.config.leader_rotation_epoch = None
    assert [node.leader_key(v) for v in range(4)] == serialized
    return got


def test_operator_distinct_leader_rotation():
    assert _rotation(T) == _jax(_rotation)


# -- checks bound for the card on a machine without one ---------------------


@pytest.fixture
def bound_for_the_card(monkeypatch):
    """The node's device set to CUDA on a machine without it; committee
    tables keep their keys on the meta device but report CUDA, so a check
    reaches its dispatch, which fails here."""
    init = T.DV.CommitteeTable._init

    def on_meta(self, arr, n, device, points):
        init(self, arr, n, "meta", points)
        self.device = torch.device("cuda")

    from harmony_tpu_torch import resilience as RS

    monkeypatch.setattr(T.DV.CommitteeTable, "_init", on_meta)
    monkeypatch.setattr(T.DV, "_TABLE_CACHE", {})
    monkeypatch.setattr(T.DV, "BREAKER", RS.CircuitBreaker("device", 100,
                                                           30.0))
    T.DV.use_device(True, device="cuda")
    T.SCHED.reset()


def test_checks_bound_for_the_card_commit_nothing(bound_for_the_card):
    """Every sender-signature check raises DeviceError; the tolerant pump
    counts each as a dropped message.  Nothing commits, no peer is scored
    down, no double-sign evidence is recorded, and no check falls back to
    the host."""
    fallbacks = T.DV.COUNTERS["ref_fallback"]
    nodes, _, net = _localnet(T, engine=True)
    leader = next(n for n in nodes if n.is_leader)
    assert leader.start_round_if_leader() is not None
    _pump(nodes)
    assert all(n.chain.head_number == 0 for n in nodes)
    validators = [n for n in nodes if n is not leader]
    assert all(n.dropped_messages >= 1 for n in validators)
    assert sum(n.dropped_messages for n in nodes) >= len(validators)
    assert net.scores == {} and net.invalid_total == 0 and not net.muted
    assert all(n.double_sign_events == 0 and not n.pending_slash_records
               for n in nodes)
    assert T.DV.COUNTERS["ref_fallback"] == fallbacks
    # the check itself raises, never answers False
    from harmony_tpu_torch.node.ingress import verify_sender
    from harmony_tpu_torch.consensus.messages import FBFTMessage, MsgType, \
        sign_message

    keys = T.MB.PrivateKeys.from_keys([T.B.PrivateKey.generate(b"k")])
    msg = sign_message(FBFTMessage(
        msg_type=MsgType.ANNOUNCE, view_id=1, block_num=1,
        block_hash=b"\x11" * 32, sender_pubkeys=[keys[0].pub.bytes]), keys)
    with pytest.raises(T.DV.DeviceError):
        verify_sender(msg)


def test_seal_check_bound_for_the_card_stores_nothing(bound_for_the_card):
    """insert_chain's seal check on CONSENSUS raises DeviceError out of
    the insert; the chain keeps its head."""
    want = _jax(_commits)
    genesis, _, _ = T.GEN.dev_genesis(n_keys=4)
    cell = []
    chain = T.BC.Blockchain(T.KV.MemKV(), genesis, blocks_per_epoch=16,
                            engine=_engine(T, cell))
    cell.append(chain)
    block = T.RAW.decode_block(want[1][0])
    with pytest.raises(T.DV.DeviceError):
        chain.insert_chain([block], commit_sigs=[want[2][0]],
                           verify_seals=True,
                           lane=T.SCHED.Lane.CONSENSUS)
    assert chain.head_number == 0 and chain.read_commit_sig(1) is None


# -- hosts, gater, services -------------------------------------------------


def test_inprocess_gossip_validate_and_deliver():
    net = T.P2P.InProcessNetwork()
    a, b, c = net.host("a"), net.host("b"), net.host("c")
    got = []
    b.subscribe("t", lambda t, p, f: got.append((t, p, f)))
    c.add_validator("t", lambda p, f: T.HOST.ACCEPT if p != b"bad"
                    else T.HOST.IGNORE)
    got_c = []
    c.subscribe("t", lambda t, p, f: got_c.append(p))
    a.publish("t", b"hello")
    a.publish("t", b"bad")
    assert got == [("t", b"hello", "a"), ("t", b"bad", "a")]
    assert got_c == [b"hello"]


def test_topics_are_the_jax_packages():
    for name in ("consensus_topic", "aggregation_topic", "slash_topic",
                 "node_topic"):
        f, g = getattr(T.P2P, name), getattr(J.P2P, name)
        args = ("localnet", 3) + ((7,) if name == "aggregation_topic"
                                  else ())
        assert f(*args) == g(*args)


def _tcp_relay(m):
    h1, h2, h3 = (m.P2P.TCPHost(f"n{i}") for i in (1, 2, 3))
    try:
        h2.add_validator("x", lambda p, f: m.HOST.ACCEPT)
        h2.connect(h1.port)
        h3.connect(h2.port)
        assert h1.wait_for_peers(1) and h3.wait_for_peers(1)
        assert h2.wait_for_peers(2)
        got1, got3 = [], []
        h1.subscribe("x", lambda t, p, f: got1.append(p))
        h3.subscribe("x", lambda t, p, f: got3.append(p))
        h1.publish("x", b"m1")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not got3:
            time.sleep(0.01)
        assert got3 == [b"m1"]
        assert got1 == []
    finally:
        h1.close(), h2.close(), h3.close()


def test_tcp_gossip_relay_and_dedup():
    _tcp_relay(T)


def test_tcp_gossip_between_the_packages():
    """A port host and a JAX-package host speak one wire: a message
    published on either side reaches the other."""
    jh, th = J.P2P.TCPHost("jax"), T.P2P.TCPHost("port")
    try:
        th.connect(jh.port)
        assert jh.wait_for_peers(1) and th.wait_for_peers(1)
        got_j, got_t = [], []
        jh.subscribe("x", lambda t, p, f: got_j.append(p))
        th.subscribe("x", lambda t, p, f: got_t.append(p))
        th.publish("x", b"from-port")
        jh.publish("x", b"from-jax")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not (got_j and got_t):
            time.sleep(0.01)
        assert got_j == [b"from-port"] and got_t == [b"from-jax"]
    finally:
        jh.close(), th.close()


def test_gater_limits():
    g = T.GATE.Gater(max_peers=2, max_per_ip=1)
    assert g.allow("10.0.0.1")
    assert not g.allow("10.0.0.1")
    assert g.allow("10.0.0.2")
    assert not g.allow("10.0.0.3")
    g.release("10.0.0.1")
    g.ban("10.0.0.3")
    assert not g.allow("10.0.0.3")
    assert g.allow("10.0.0.1")


def test_tcp_validation_pool_and_peer_scoring():
    """REJECTed junk drives the sender's score to the floor and drops
    that connection; IGNOREd traffic is free; loopback is never IP-banned,
    repeated strikes from another address are."""
    h1, h2 = T.P2P.TCPHost("spammer"), T.P2P.TCPHost("victim")
    h2.SCORE_FLOOR = -5.0
    try:
        h1.connect(h2.port)
        assert h2.wait_for_peers(1) and h1.wait_for_peers(1)
        good = []

        def verdict(p, f):
            if p.startswith(b"ok"):
                return T.HOST.ACCEPT
            if p.startswith(b"meh"):
                return T.HOST.IGNORE
            return T.HOST.REJECT

        h2.add_validator("t", verdict)
        h2.subscribe("t", lambda t, p, f: good.append(p))
        h1.publish("t", b"ok-1")
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and not good:
            time.sleep(0.01)
        assert good == [b"ok-1"]
        for i in range(10):
            h1.publish("t", b"meh-%d" % i)
        time.sleep(0.5)
        assert h2.peer_count() == 1
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and h2.peer_count():
            for i in range(10):
                h1.publish("t", b"junk-%d" % i)
            time.sleep(0.2)
        assert h2.peer_count() == 0
        assert h2.gater.allow("127.0.0.1")
        assert good == [b"ok-1"]

        class _Sock:
            def close(self):
                pass

        for _ in range(h2.IP_BAN_STRIKES):
            sock = _Sock()
            for _ in range(10):
                h2._punish("10.9.8.7", sock)
        assert not h2.gater.allow("10.9.8.7")
    finally:
        h1.close(), h2.close()


class _SpySvc(T.SVC.Service):
    def __init__(self, log, name, fail=False):
        self.log, self.name, self.fail = log, name, fail

    def start(self):
        if self.fail:
            raise RuntimeError("boom")
        self.log.append(("start", self.name))

    def stop(self):
        self.log.append(("stop", self.name))


def test_service_manager_order_and_rollback():
    S = T.SVC
    log = []
    m = S.Manager()
    m.register(S.ServiceType.CONSENSUS, _SpySvc(log, "consensus"))
    m.register(S.ServiceType.SYNCHRONIZE, _SpySvc(log, "sync"))
    m.start_services()
    m.stop_services()
    assert log == [("start", "consensus"), ("start", "sync"),
                   ("stop", "sync"), ("stop", "consensus")]
    log.clear()
    m2 = S.Manager()
    m2.register(S.ServiceType.CONSENSUS, _SpySvc(log, "a"))
    m2.register(S.ServiceType.PROMETHEUS, _SpySvc(log, "b", fail=True))
    with pytest.raises(RuntimeError):
        m2.start_services()
    assert log == [("start", "a"), ("stop", "a")]


def test_multi_key_signature_equals_the_per_key_aggregate():
    """A node of many keys signs once by the keys' sum: the same bytes as
    the JAX package's per-key signatures, summed; keys that cancel give
    the aggregate of their signatures too."""
    seeds = [bytes([7, i]) for i in range(20)]
    payload = b"\x42" * 32
    want = J.MB.PrivateKeys.from_keys(
        [J.B.PrivateKey.generate(s) for s in seeds]).sign_hash_aggregated(
            payload).bytes
    got = T.MB.PrivateKeys.from_keys(
        [T.B.PrivateKey.generate(s) for s in seeds]).sign_hash_aggregated(
            payload).bytes
    assert got == want
    k = T.B.PrivateKey.generate(b"cancel")
    from harmony_tpu_torch.ref.params import R_ORDER

    pair = T.MB.PrivateKeys.from_keys([k, T.B.PrivateKey(R_ORDER - k.scalar)])
    assert pair.sign_hash_aggregated(payload).bytes == T.B.aggregate_sigs(
        [x.sign_hash(payload) for x in pair]).bytes
