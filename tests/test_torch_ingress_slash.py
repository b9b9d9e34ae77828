"""The port's gossip ingress, tx-pool key proofs and double-sign slashing
against the JAX package's: ports of tests/test_ingress.py, of the
proof-of-possession check of tests/test_sched.py, and of the codec,
verification and node-detection arcs of tests/test_slash_pipeline.py
(its chain-application arcs need the staking finalizer, which the port
does not have yet).

Each case runs on both packages with the same keys and bytes; verdicts,
error texts, encoded records and fingerprints must be equal.  The port's
BLS checks also run in device mode (the twins, through its scheduler and
``device.py``), and bound for CUDA on a machine without it, where each
raises ``DeviceError`` and is never answered False.
"""

import importlib
import struct
import types

import pytest
import torch

CHAIN_ID = 2
_MODULES = {
    "B": "bls", "DV": "device", "MSG": "consensus.messages",
    "SIG": "consensus.signature", "ING": "node.ingress", "SL": "staking.slash",
    "E": "crypto_ecdsa", "POOL": "core.tx_pool", "TY": "core.types",
    "BC": "core.blockchain", "GEN": "core.genesis", "KV": "core.kv",
    "MB": "multibls", "NODE": "node.node", "REG": "node.registry",
    "P2P": "p2p", "HOST": "p2p.host", "SCHED": "sched",
}


def _package(root):
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"{root}.{v}")
        for k, v in _MODULES.items()})


J = _package("harmony_tpu")
T = _package("harmony_tpu_torch")
MODES = ("host", "device")


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


@pytest.fixture(params=MODES)
def mode(request, monkeypatch):
    if request.param == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T.DV.use_device(True, device="cpu")
        T.SCHED.reset()
    return request.param


@pytest.fixture
def bound_for_the_card(monkeypatch):
    """Checks bound for CUDA on a machine without it: each dispatch
    fails."""
    from harmony_tpu_torch import resilience as RS

    init = T.DV.CommitteeTable._init

    def on_meta(self, arr, n, device, points):
        init(self, arr, n, "meta", points)
        self.device = torch.device("cuda")

    monkeypatch.setattr(T.DV.CommitteeTable, "_init", on_meta)
    monkeypatch.setattr(T.DV, "_TABLE_CACHE", {})
    monkeypatch.setattr(T.DV, "BREAKER",
                        RS.CircuitBreaker("device", 100, 30.0))
    T.DV.use_device(True, device="cuda")
    T.SCHED.reset()


def _verdict(fn):
    """(True, result) or (False, exception type name, message)."""
    try:
        return True, fn()
    except Exception as e:  # noqa: BLE001 — the verdict is the result
        return False, type(e).__name__, str(e)


# -- ingress ----------------------------------------------------------------

KEYS = [bytes([i + 1]) * 48 for i in range(8)]
# (message fields, context fields, shard id, accepted)
INGRESS_CASES = {
    "plain": ({}, {}, 2, True),
    "wrong shard": ({}, {}, 3, False),
    "stale view": ({"view_id": 94}, {}, 2, False),
    "view at the window's edge": ({"view_id": 95}, {}, 2, True),
    "vote at a validator": ({}, {"is_leader": False}, 2, False),
    "proof at the leader": ({"msg_type": "PREPARED",
                             "payload": bytes(97)}, {}, 2, False),
    "proof at a validator": ({"msg_type": "PREPARED",
                              "payload": bytes(97)},
                             {"is_leader": False}, 2, True),
    "stranger": ({"sender_pubkeys": [bytes(48)]}, {}, 2, False),
    "short key": ({"sender_pubkeys": [b"short"]}, {}, 2, False),
    "no key": ({"sender_pubkeys": []}, {}, 2, False),
    "bad bitmap": ({"msg_type": "PREPARED", "payload": bytes(98)},
                   {"is_leader": False}, 2, False),
    "future view change": ({"msg_type": "VIEWCHANGE", "view_id": 101}, {},
                           2, True),
    "stale view change": ({"msg_type": "VIEWCHANGE"}, {}, 2, False),
    "stale view change in view change": (
        {"msg_type": "VIEWCHANGE"},
        {"in_view_change": True, "is_leader": False}, 2, True),
}


def _ingress(m, fields, ctx_fields, shard):
    base = dict(msg_type=m.MSG.MsgType.PREPARE, view_id=100, block_num=7,
                block_hash=bytes(32), sender_pubkeys=[KEYS[0]],
                payload=bytes(96))
    base.update(fields)
    if isinstance(base["msg_type"], str):
        base["msg_type"] = m.MSG.MsgType[base["msg_type"]]
    ctx = dict(shard_id=2, current_view_id=100, committee_keys=set(KEYS),
               is_leader=True)
    ctx.update(ctx_fields)
    res = m.ING.validate_consensus_message(
        m.MSG.FBFTMessage(**base), m.ING.IngressContext(**ctx), shard)
    return res.accepted, res.reason


@pytest.mark.parametrize("case", sorted(INGRESS_CASES))
def test_ingress_filter(case):
    fields, ctx, shard, accepted = INGRESS_CASES[case]
    got = _ingress(T, fields, ctx, shard)
    assert got == _ingress(J, fields, ctx, shard)
    assert got[0] is accepted


def test_envelope_roundtrip():
    for m in (J, T):
        env = m.ING.pack_envelope(m.ING.MessageCategory.CONSENSUS, 3,
                                  b"payload")
        assert env == b"\x00\x03payload"
        assert m.ING.parse_envelope(env) == (
            m.ING.MessageCategory.CONSENSUS, 3, b"payload")
        with pytest.raises(ValueError):
            m.ING.parse_envelope(b"\x00")


def _sender_sig(m):
    keys = m.MB.PrivateKeys.from_keys([m.B.PrivateKey.generate(b"ing-k")])
    msg = m.MSG.sign_message(m.MSG.FBFTMessage(
        msg_type=m.MSG.MsgType.ANNOUNCE, view_id=1, block_num=1,
        block_hash=b"\x11" * 32, sender_pubkeys=[keys[0].pub.bytes]), keys)
    good = m.ING.verify_sender(msg)
    msg.block_num = 2  # breaks the signed encoding
    return good, m.ING.verify_sender(msg)


def test_ingress_sender_sig_gate(mode):
    before = T.DV.COUNTERS["verify"]
    assert _sender_sig(T) == _sender_sig(J) == (True, False)
    if mode == "device":
        assert T.DV.COUNTERS["verify"] - before == 2


def test_ingress_sender_sig_bound_for_the_card_raises(bound_for_the_card):
    with pytest.raises(T.DV.DeviceError):
        _sender_sig(T)


# -- the tx pool's key proofs -----------------------------------------------


def _pop_pool(m):
    class _State:
        def nonce(self, sender):
            return 0

        def balance(self, sender):
            return 10**30

    pool = m.POOL.TxPool(CHAIN_ID, 0, lambda: _State())
    staker = m.E.ECDSAKey.from_seed(b"sched-pop-staker")
    bls_key = m.B.PrivateKey.generate(b"sched-pop-bls")
    pop = m.B.proof_of_possession(bls_key)

    def mk(nonce, pop_bytes):
        return m.TY.StakingTransaction(
            nonce=nonce, gas_price=1, gas_limit=50_000,
            directive=m.TY.Directive.CREATE_VALIDATOR,
            fields={"amount": 10**20, "min_self_delegation": 10**18,
                    "bls_keys": bls_key.pub.bytes,
                    "bls_key_sigs": pop_bytes},
        ).sign(staker, CHAIN_ID)

    bad = bytearray(pop)
    bad[5] ^= 0x40
    return pool, pop, mk, bytes(bad)


def _pop(m):
    pool, pop, mk, bad = _pop_pool(m)
    out = [pool.add(mk(0, pop), is_staking=True)]
    out.append(_verdict(lambda: pool.add(mk(1, bad), is_staking=True)))
    out.append(_verdict(lambda: pool.add(mk(1, pop + pop),
                                         is_staking=True)))
    return pop, out


def test_txpool_staking_pop_on_ingress_lane(mode):
    """A valid proof of possession admits; a forged one and a length
    mismatch are refused with the same PoolError."""
    before = T.DV.COUNTERS["verify"]
    got = _pop(T)
    assert got == _pop(J)
    assert got[1][1][:2] == (False, "PoolError")
    assert "proof of possession" in got[1][1][2]
    if mode == "device":
        assert T.DV.COUNTERS["verify"] > before


def test_txpool_pop_bound_for_the_card_raises(bound_for_the_card):
    pool, pop, mk, _ = _pop_pool(T)
    with pytest.raises(T.DV.DeviceError):
        pool.add(mk(0, pop), is_staking=True)
    assert len(pool) == 0


# -- slashing: codec and verification ---------------------------------------


def _record(m, key, height=100, view=7, epoch=3, shard=0,
            offender=b"\x0f" * 20, reporter=b"\x1e" * 20,
            h1=bytes([1]) * 32, h2=bytes([2]) * 32):
    SL = m.SL
    votes = [SL.Vote(signer_pubkeys=[key.pub.bytes], block_header_hash=h,
                     signature=key.sign_hash(m.SIG.construct_commit_payload(
                         h, height, view)).bytes) for h in (h1, h2)]
    return SL.Record(evidence=SL.Evidence(
        moment=SL.Moment(epoch, shard, height, view),
        first_vote=votes[0], second_vote=votes[1], offender=offender),
        reporter=reporter)


def _codec(m):
    SL = m.SL
    key = m.B.PrivateKey.generate(b"\x77")
    rec = _record(m, key)
    blob = SL.encode_record(rec)
    assert SL.decode_record(blob) == rec
    many = SL.encode_records([rec, _record(m, key, height=101)])
    assert SL.decode_records(many) == [rec, _record(m, key, height=101)]
    fp = [SL.record_fingerprint(_record(m, key, reporter=r))
          for r in (b"\x1e" * 20, b"\x2f" * 20)]
    assert fp[0] == fp[1]
    assert fp[0] != SL.record_fingerprint(_record(m, key, height=101))
    inflated = bytearray(blob)
    struct.pack_into("<H", inflated, 28, 0xFFFF)
    errors = [_verdict(lambda: SL.decode_record(bytes(inflated)))]
    errors += [_verdict(lambda c=cut: SL.decode_record(blob[:c]))
               for cut in (1, 10, 27, 30, len(blob) - 1)]
    errors.append(_verdict(lambda: SL.decode_record(blob + b"\x00")))
    errors.append(_verdict(lambda: SL.decode_records(
        struct.pack("<H", SL.MAX_SLASHES_PER_BLOCK + 1) + bytes(64))))
    assert all(not ok for ok, *_ in errors)
    return blob, many, fp[0], errors


def test_slash_record_codec_and_bounded_decode():
    assert _codec(T) == _codec(J)


def _verify_cases(m):
    SL = m.SL
    key = m.B.PrivateKey.generate(b"\x77")
    other = m.B.PrivateKey.generate(b"\x78")
    committee = [key.pub.bytes]
    cases = {"valid": (_record(m, key), committee),
             "non-committee signer": (_record(m, key), [other.pub.bytes]),
             "same hash": (_record(m, key, h1=bytes([3]) * 32,
                                   h2=bytes([3]) * 32), committee),
             "self report": (_record(m, key, offender=b"\x1e" * 20),
                             committee)}
    bad_sig = _record(m, key)
    bad_sig.evidence.second_vote.signature = bytes(96)
    cases["invalid ballot"] = (bad_sig, committee)
    wrong_phase = _record(m, key)
    wrong_phase.evidence.second_vote.signature = key.sign_hash(
        m.SIG.prepare_payload(bytes([2]) * 32)).bytes
    cases["wrong phase"] = (wrong_phase, committee)
    forged = _record(m, key)
    forged.evidence.second_vote.signature = other.sign_hash(
        m.SIG.construct_commit_payload(bytes([2]) * 32, 100, 7)).bytes
    cases["forged ballot"] = (forged, committee)
    disjoint = _record(m, key)
    disjoint.evidence.second_vote = _record(m, other).evidence.second_vote
    cases["disjoint keys"] = (disjoint, [key.pub.bytes, other.pub.bytes])
    return {name: _verdict(lambda r=r, c=c: SL.verify_record(r, c))
            for name, (r, c) in cases.items()}


def test_slash_verification_verdicts(mode):
    """Every edge case gives the same verdict and error text in both
    packages; in device mode the port's ballot checks run on its device
    path."""
    before = T.DV.COUNTERS["verify"]
    got = _verify_cases(T)
    assert got == _verify_cases(J)
    assert got["valid"] == (True, None)
    assert all(not v[0] and v[1] == "SlashVerifyError"
               for k, v in got.items() if k != "valid")
    if mode == "device":
        assert T.DV.COUNTERS["verify"] > before


def test_slash_verification_bound_for_the_card_raises(bound_for_the_card):
    key = T.B.PrivateKey.generate(b"\x77")
    with pytest.raises(T.DV.DeviceError):
        T.SL.verify_record(_record(T, key), [key.pub.bytes])


# -- slashing: detection at the node ----------------------------------------


def _leader_node(m):
    genesis, ecdsa_keys, keys = m.GEN.dev_genesis(n_keys=4)
    net = m.P2P.InProcessNetwork()
    chain = m.BC.Blockchain(m.KV.MemKV(), genesis, blocks_per_epoch=16)
    pool = m.POOL.TxPool(CHAIN_ID, 0, chain.state)
    reg = m.REG.Registry(blockchain=chain, txpool=pool,
                         host=net.host("leader"))
    return m.NODE.Node(reg, m.MB.PrivateKeys.from_keys([keys[1]])), net, \
        keys, ecdsa_keys


def _double_commit(m, node, rogue):
    announced = node.leader.current_block_hash
    for block_hash in (announced, bytes([0xAB]) * 32):
        node._on_commit(m.MSG.FBFTMessage(
            msg_type=m.MSG.MsgType.COMMIT, view_id=node.view_id,
            block_num=node.block_num, block_hash=block_hash,
            sender_pubkeys=[rogue.pub.bytes],
            payload=rogue.sign_hash(
                node.leader._commit_payload(block_hash)).bytes))


def _conflict(m):
    node, net, keys, _ = _leader_node(m)
    assert node.is_leader
    node.start_round_if_leader()
    heard = []
    net.host("probe").subscribe(node._slash_topic,
                                lambda t, p, f: heard.append(p))
    _double_commit(m, node, keys[2])
    assert node.double_sign_events == 1
    # no staked validator stands behind the key on this chain (no staking
    # finalizer): the evidence is queued for forensics, no record is built
    assert node.pending_slash_records == [] and heard == []
    return list(node.pending_double_signs)


def test_commit_conflict_is_detected_and_queued(mode):
    """A commit-phase double vote at the leader is detected (its second
    ballot checked on INGRESS) and queued as the same evidence."""
    assert _conflict(T) == _conflict(J)


def _gossiped(m):
    node, _, keys, ecdsa_keys = _leader_node(m)
    rec = _record(m, keys[2], height=node.block_num, view=node.view_id,
                  epoch=0, offender=ecdsa_keys[2].address(),
                  reporter=ecdsa_keys[3].address())
    env = m.ING.pack_envelope(m.ING.MessageCategory.NODE,
                              m.ING.NODE_MSG_SLASH, m.SL.encode_record(rec))
    node._handle(env)
    assert len(node.pending_slash_records) == 1
    node._handle(env)
    assert len(node.pending_slash_records) == 1
    assert node._slash_validator(b"\x01\x10garbage", "x") == m.HOST.REJECT
    return m.SL.encode_record(node.pending_slash_records[0])


def test_gossiped_record_queued_with_dedup(mode):
    assert _gossiped(T) == _gossiped(J)


def test_forensic_queue_evicts_duplicates_then_counts_drops():
    node, _, _, _ = _leader_node(T)

    def mk(i):
        return {"height": i, "view_id": i, "keys": [f"{i:02x}"],
                "shard_id": 0, "first_hash": "", "first_keys": [],
                "first_signature": "", "second_hash": "",
                "second_signature": ""}

    for i in range(64):
        node._queue_forensic_evidence(mk(i))
    assert len(node.pending_double_signs) == 64
    node._queue_forensic_evidence(mk(3))
    assert len(node.pending_double_signs) == 64
    assert node.double_signs_dropped == 0
    node._queue_forensic_evidence(mk(99))
    assert node.double_signs_dropped == 1
    assert node._ds_drop_logged
