"""The port's FBFT round, view change and Handel aggregation against the
JAX package's: ports of tests/test_fbft_round.py, tests/test_view_change.py
and the unit tier of tests/test_aggregation.py (its localnet arcs need the
node, which the port does not have yet), with the encoded FBFT,
view-change and aggregation messages held byte-equal.

Each scenario runs on both packages with the same keys.  The port's runs
in two modes: with the device path forced on the CPU through the bigint
twins (``HARMONY_KERNEL_TWIN=1``), so that every check goes through its
scheduler and ``device.py``, and in host mode (the device path off).  The
JAX package's runs on its host route.  Verdicts, bytes and points must be
equal.  A check bound for CUDA raises ``DeviceError`` here and never
answers False.
"""

import types

import pytest
import torch

from harmony_tpu import bls as J_B
from harmony_tpu import device as J_DV
from harmony_tpu import faultinject as J_FI
from harmony_tpu import multibls as J_MB
from harmony_tpu.consensus import aggregation as J_AGG
from harmony_tpu.consensus import fbft as J_FB
from harmony_tpu.consensus import mask as J_MASK
from harmony_tpu.consensus import messages as J_MSG
from harmony_tpu.consensus import quorum as J_Q
from harmony_tpu.consensus import signature as J_SIG
from harmony_tpu.consensus import view_change as J_VC
from harmony_tpu.ref import bls as J_RB
from harmony_tpu.ref import keccak as J_K
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import faultinject as T_FI
from harmony_tpu_torch import multibls as T_MB
from harmony_tpu_torch import resilience as T_RS
from harmony_tpu_torch import sched as T_SCHED
from harmony_tpu_torch.consensus import aggregation as T_AGG
from harmony_tpu_torch.consensus import fbft as T_FB
from harmony_tpu_torch.consensus import mask as T_MASK
from harmony_tpu_torch.consensus import messages as T_MSG
from harmony_tpu_torch.consensus import quorum as T_Q
from harmony_tpu_torch.consensus import signature as T_SIG
from harmony_tpu_torch.consensus import view_change as T_VC
from harmony_tpu_torch.ref import bls as T_RB
from harmony_tpu_torch.ref import keccak as T_K

PACKAGES = {
    "jax": types.SimpleNamespace(
        B=J_B, FI=J_FI, MB=J_MB, AGG=J_AGG, FB=J_FB, MASK=J_MASK, MSG=J_MSG,
        Q=J_Q, SIG=J_SIG, VC=J_VC, RB=J_RB, K=J_K),
    "port": types.SimpleNamespace(
        B=T_B, FI=T_FI, MB=T_MB, AGG=T_AGG, FB=T_FB, MASK=T_MASK, MSG=T_MSG,
        Q=T_Q, SIG=T_SIG, VC=T_VC, RB=T_RB, K=T_K),
}
MODES = ("host", "device")
BLOCK = b"block body bytes"


@pytest.fixture(autouse=True)
def _no_twins_unless_asked(monkeypatch):
    """Other files of a test process may have left HARMONY_KERNEL_TWIN
    set; the twins run only where a test asks for them."""
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)


@pytest.fixture(params=MODES)
def mode(request, monkeypatch):
    """The port's device path forced on the CPU through the twins, or
    off; the JAX package's on its host route."""
    if request.param == "device":
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T_DV.use_device(True, device="cpu")
    else:
        T_DV.use_device(False)
    J_DV.use_device(False)
    T_SCHED.reset()
    fallbacks = T_DV.COUNTERS["ref_fallback"]
    yield request.param
    T_SCHED.reset()
    T_DV.use_device(None)
    J_DV.use_device(None)
    for m in PACKAGES.values():
        m.FI.reset()
    assert T_DV.COUNTERS["ref_fallback"] == fallbacks


_JAX_RESULTS: dict = {}


def _on_both(scenario):
    """scenario(m) on each package; the two results.  The JAX package's
    runs once per scenario, whichever the port's mode."""
    if scenario not in _JAX_RESULTS:
        _JAX_RESULTS[scenario] = scenario(PACKAGES["jax"])
    return _JAX_RESULTS[scenario], scenario(PACKAGES["port"])


@pytest.fixture
def bound_for_the_card(monkeypatch):
    """The node's device set to CUDA on a machine without it.  Committee
    tables keep their keys on the meta device but report CUDA, so that a
    check goes all the way to its dispatch, which fails here."""
    init = T_DV.CommitteeTable._init

    def on_meta(self, arr, n, device, points):
        init(self, arr, n, "meta", points)
        self.device = torch.device("cuda")

    monkeypatch.setattr(T_DV.CommitteeTable, "_init", on_meta)
    monkeypatch.setattr(T_DV, "_TABLE_CACHE", {})
    monkeypatch.setattr(T_DV, "BREAKER",
                        T_RS.CircuitBreaker("device", 100, 30.0))
    T_DV.use_device(True, device="cuda")
    T_SCHED.reset()
    fallbacks = T_DV.COUNTERS["ref_fallback"]
    yield
    T_SCHED.reset()
    T_DV.use_device(None)
    assert T_DV.COUNTERS["ref_fallback"] == fallbacks


# -- the FBFT round ---------------------------------------------------------------------


def _network(m):
    """7 nodes, one multi-key (2 slots): 8 committee slots."""
    keysets = [
        m.MB.PrivateKeys.from_keys([
            m.B.PrivateKey.generate(bytes([10 * n + j]))
            for j in range(2 if n == 0 else 1)])
        for n in range(7)]
    committee = [k.pub.bytes for ks in keysets for k in ks]
    cfg = m.FB.RoundConfig(committee=committee, block_num=42, view_id=3)

    def decider():
        return m.Q.Decider(m.Q.Policy.UNIFORM, committee)

    leader = m.FB.Leader(keysets[0], cfg, decider())
    validators = [m.FB.Validator(ks, cfg, decider()) for ks in keysets[1:]]
    return leader, validators, cfg


def full_round(m):
    """The original test_full_round and test_tampered_proof_rejected;
    every message's wire bytes and every verdict."""
    leader, validators, cfg = _network(m)
    block_hash = m.K.keccak256(BLOCK)
    wire, out = [], []
    announce = leader.announce(block_hash, BLOCK)
    wire.append(m.MSG.encode_message(announce))
    out += [announce.msg_type == m.MSG.MsgType.ANNOUNCE,
            leader.decider.count(m.FB.Phase.PREPARE) == len(leader.keys),
            m.MSG.verify_sender_sig(announce)]
    self_prep = m.FB.Validator(leader.keys, cfg,
                               leader.decider).on_announce(announce)
    out.append(leader.on_prepare(self_prep))
    prepares = [v.on_announce(announce) for v in validators]
    wire += [m.MSG.encode_message(p) for p in prepares]
    out += [leader.on_prepare(p) for p in prepares]
    out.append(leader.on_prepare(prepares[0]))
    prepared = leader.try_prepared(block_hash)
    wire.append(m.MSG.encode_message(prepared))
    sig, bitmap = m.MSG.decode_sig_and_bitmap(prepared.payload, 1)
    out += [prepared.msg_type == m.MSG.MsgType.PREPARED, len(sig), bitmap,
            m.MSG.verify_sender_sig(prepared),
            leader.try_prepared(m.K.keccak256(b"not announced"))]
    commits = [v.on_prepared(prepared) for v in validators]
    wire += [m.MSG.encode_message(c) for c in commits]
    self_commit = m.FB.Validator(leader.keys, cfg,
                                 leader.decider).on_prepared(prepared)
    out.append(leader.on_commit(self_commit))
    out += [leader.on_commit(c) for c in commits]
    committed = leader.try_committed(block_hash)
    wire.append(m.MSG.encode_message(committed))
    out.append(committed.msg_type == m.MSG.MsgType.COMMITTED)
    out += [v.on_committed(committed) for v in validators]
    tampered = m.FB.FBFTMessage(
        msg_type=m.MSG.MsgType.COMMITTED, view_id=cfg.view_id,
        block_num=cfg.block_num, block_hash=m.K.keccak256(b"other block"),
        sender_pubkeys=committed.sender_pubkeys, payload=committed.payload)
    out.append(validators[0].on_committed(tampered))
    forged = m.MSG.decode_message(m.MSG.encode_message(prepared))
    forged.view_id += 1
    out.append(m.MSG.verify_sender_sig(forged))
    return wire, out


def test_full_round(mode):
    jax, port = _on_both(full_round)
    assert port == jax
    wire, out = port
    assert out == ([True, True, True, False] + [True] * 6
                   + [False, True, 96, b"\xff", True, None, True]
                   + [True] * 6 + [True] + [True] * 6 + [False, False])
    # every wire form decodes back to itself, in either package
    for data in wire:
        for m in PACKAGES.values():
            assert m.MSG.encode_message(m.MSG.decode_message(data)) == data


def test_round_checks_ride_their_lanes(monkeypatch):
    """On the device path each validator's proof check is one
    sched.agg_verify on CONSENSUS, and each vote check one single check
    on CONSENSUS."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T_DV.use_device(True, device="cpu")
    T_SCHED.reset()
    aggs, singles = [], []
    agg_verify, verify_single = T_SCHED.agg_verify, T_SCHED.verify_single

    def rec_agg(*a, lane, **k):
        aggs.append(lane)
        return agg_verify(*a, lane=lane, **k)

    def rec_single(*a, lane, **k):
        singles.append(lane)
        return verify_single(*a, lane=lane, **k)

    monkeypatch.setattr(T_SCHED, "agg_verify", rec_agg)
    monkeypatch.setattr(T_SCHED, "verify_single", rec_single)
    try:
        before = T_DV.COUNTERS["agg_verify"], T_DV.COUNTERS["verify"]
        _, out = full_round(PACKAGES["port"])
        assert out[-8:-2] == [True] * 6
        # 6 prepared checks, 6 committed, the leader's own prepared
        # check and the tampered proof's
        assert aggs == [T_SCHED.Lane.CONSENSUS] * 14
        # the self-vote is dropped before its check; 6 prepares, 7
        # commits, and the 3 sender signatures (on CONSENSUS by default)
        assert singles == [T_SCHED.Lane.CONSENSUS] * 16
        assert T_DV.COUNTERS["agg_verify"] - before[0] == 14
        assert T_DV.COUNTERS["verify"] - before[1] == 16
    finally:
        T_SCHED.reset()
        T_DV.use_device(None)


def overlapping_keyset(m):
    _, validators, cfg = _network(m)
    leader = m.FB.Leader(validators[0].keys, cfg,
                         m.Q.Decider(m.Q.Policy.UNIFORM, cfg.committee))
    h = m.K.keccak256(b"overlap test block")
    announce = leader.announce(h, b"overlap test block")
    v1 = validators[1]
    first = leader.on_prepare(v1.on_announce(announce))
    combined = m.MB.PrivateKeys.from_keys(
        list(v1.keys) + list(validators[2].keys))
    overlap = m.FB.Validator(combined, cfg,
                             leader.decider).on_announce(announce)
    return [first, leader.on_prepare(overlap), m.MSG.encode_message(overlap)]


def test_overlapping_keyset_vote_rejected(mode):
    jax, port = _on_both(overlapping_keyset)
    assert port == jax and port[:2] == [True, False]


def malformed_and_below_quorum(m):
    _, validators, cfg = _network(m)
    out = []
    for bad in (b"short", bytes(96), bytes(96) + b"\x00\x01"):
        msg = m.FB.FBFTMessage(
            msg_type=m.MSG.MsgType.PREPARED, view_id=cfg.view_id,
            block_num=cfg.block_num, block_hash=m.K.keccak256(b"x"),
            sender_pubkeys=[cfg.committee[0]], payload=bad)
        out.append(validators[0].on_prepared(msg))
    leader2 = m.FB.Leader(validators[0].keys, cfg,
                          m.Q.Decider(m.Q.Policy.UNIFORM, cfg.committee))
    h = m.K.keccak256(b"b2")
    leader2.announce(h, b"b2")
    vote = validators[1].on_announce(leader2.announce(h, b"b2"))
    out += [leader2.on_prepare(vote), leader2.try_prepared(h)]
    return out


def test_malformed_proof_and_insufficient_quorum(mode):
    jax, port = _on_both(malformed_and_below_quorum)
    assert port == jax == [None, None, None, True, None]


def codecs(m):
    """Signable payloads, the sig-and-bitmap proof and the aggregation
    overlay's codec, with their error messages."""
    h = bytes(range(32))
    out = [m.SIG.construct_commit_payload(h, 7, 9, True),
           m.SIG.construct_commit_payload(h, 7, 9, False),
           m.SIG.prepare_payload(h),
           m.MSG.encode_sig_and_bitmap(bytes(96), b"\x0f")]
    c = m.MSG.AggContribution(phase=1, view_id=5, block_num=6, block_hash=h,
                              level=2, bitmap=b"\x05\x01", sig=bytes(96),
                              sender_slot=9)
    wire = m.MSG.encode_aggregation(c)
    out += [wire, m.MSG.decode_aggregation(wire) == c]
    for bad in (wire[:-1], wire + b"\x00", b"\x03" + wire[1:], bytes(10),
                wire[:50] + b"\x00\x00" + wire[52:]):
        with pytest.raises(ValueError) as e:
            m.MSG.decode_aggregation(bad)
        out.append(str(e.value))
    for call in (lambda: m.SIG.prepare_payload(b"x"),
                 lambda: m.MSG.decode_sig_and_bitmap(bytes(50), 1),
                 lambda: m.MSG.decode_sig_and_bitmap(bytes(98), 1),
                 lambda: m.MSG.decode_message(bytes(20))):
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    log = m.MSG.FBFTLog()
    msg = m.MSG.FBFTMessage(msg_type=m.MSG.MsgType.PREPARE, view_id=1,
                            block_num=2, block_hash=h, trace_ctx=b"tc")
    out += [log.add_message(msg), log.add_message(msg),
            len(log.get_messages(m.MSG.MsgType.PREPARE, block_num=2)),
            len(log.prune_below(3).get_messages(m.MSG.MsgType.PREPARE)),
            m.MSG.encode_message(msg),
            m.MSG.decode_message(m.MSG.encode_message(msg)) == msg]
    return out


def test_codecs_equal_the_jax_package():
    jax, port = _on_both(codecs)
    assert port == jax


def test_multibls_equals_the_jax_package():
    def drive(m):
        keys = [m.B.PrivateKey.generate(bytes([70 + i])) for i in range(3)]
        ks = m.MB.PrivateKeys.from_keys(keys + keys[:1])
        pubs = ks.public_keys()
        with pytest.raises(ValueError):
            m.MB.PrivateKeys().sign_hash_aggregated(b"h" * 32)
        return [len(ks), pubs.serialized(), pubs.contains(keys[1].pub),
                ks.sign_hash_aggregated(b"h" * 32).bytes]

    jax, port = _on_both(drive)
    assert port == jax and port[0] == 3 and port[2] is True


def test_fbft_checks_bound_for_the_card_raise(bound_for_the_card):
    """A vote check and a proof check bound for CUDA raise DeviceError
    here; neither answers False."""
    m = PACKAGES["port"]
    T_DV.use_device(False)
    leader, validators, cfg = _network(m)
    announce = leader.announce(m.K.keccak256(BLOCK), BLOCK)
    prepares = [v.on_announce(announce) for v in validators]
    leader.decider.reset()
    for p in prepares:  # votes cast on the host
        assert leader.on_prepare(p)
    prepared = leader.try_prepared(m.K.keccak256(BLOCK))
    T_DV.use_device(True, device="cuda")
    with pytest.raises(T_DV.DeviceError):
        validators[0].on_prepared(prepared)
    fresh = m.FB.Leader(leader.keys, cfg,
                        m.Q.Decider(m.Q.Policy.UNIFORM, cfg.committee))
    fresh.announce(m.K.keccak256(BLOCK), BLOCK)
    with pytest.raises(T_DV.DeviceError):
        fresh.on_prepare(prepares[0])
    with pytest.raises(T_DV.DeviceError):
        T_MSG.verify_sender_sig(announce)


# -- view change ----------------------------------------------------------------------


def _vc_committee(m):
    keysets = [m.MB.PrivateKeys.from_keys(
        [m.B.PrivateKey.generate(bytes([60 + i]))]) for i in range(4)]
    return keysets, [ks[0].pub.bytes for ks in keysets]


def _decider(m, keys):
    return m.Q.Decider(m.Q.Policy.UNIFORM, keys)


def _real_prepared_proof(m, keysets, keys, block_hash):
    agg = m.B.aggregate_sigs([ks.sign_hash_aggregated(block_hash)
                              for ks in keysets])
    bitmap = bytearray((len(keys) + 7) >> 3)
    for i in range(len(keys)):
        bitmap[i >> 3] |= 1 << (i & 7)
    return m.MSG.encode_sig_and_bitmap(agg.bytes, bytes(bitmap))


def _collector(m, keys, view_id):
    return m.VC.ViewChangeCollector(keys, _decider(m, keys), view_id)


def next_leader(m):
    _, keys = _vc_committee(m)
    out = [m.VC.next_leader_key(keys, keys[1], 1) == keys[2],
           m.VC.next_leader_key(keys, keys[3], 1) == keys[0],
           m.VC.next_leader_key(keys, keys[0], 2) == keys[2],
           m.VC.next_leader_key(keys, b"nope", 1) == keys[0]]
    with pytest.raises(ValueError):
        m.VC.next_leader_key([], b"", 1)
    return out


def nil_quorum_and_new_view(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 9)
    msgs = [m.VC.construct_viewchange(ks, 9, block_num=5) for ks in keysets]
    out = [coll.on_viewchange(x) for x in msgs]
    out.append(coll.on_viewchange(msgs[0]))
    out.append(coll.on_viewchange(m.VC.construct_viewchange(keysets[0], 10,
                                                            5)))
    nv = coll.try_new_view(block_num=5, leader_keys=keysets[0])
    out += [m.VC.encode_newview(nv),
            [m.VC.encode_viewchange(x) for x in msgs],
            m.VC.verify_new_view(nv, keys, _decider(m, keys))]
    return out


def with_prepared_block(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 11)
    block_hash = bytes(range(32))
    proof = _real_prepared_proof(m, keysets, keys, block_hash)
    out = [coll.on_viewchange(m.VC.construct_viewchange(
        ks, 11, 6, block_hash, proof)) for ks in keysets[:2]]
    out += [coll.on_viewchange(m.VC.construct_viewchange(ks, 11, 6))
            for ks in keysets[2:]]
    nv = coll.try_new_view(block_num=6, leader_keys=keysets[1])
    out += [nv.m1_payload == m.VC.m1_payload(block_hash, proof),
            m.VC.encode_newview(nv),
            m.VC.verify_new_view(nv, keys, _decider(m, keys))]
    return out


def missing_m1(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 13)
    block_hash = bytes(range(32))
    proof = _real_prepared_proof(m, keysets, keys, block_hash)
    for ks in keysets[:3]:
        coll.on_viewchange(m.VC.construct_viewchange(ks, 13, 7, block_hash,
                                                     proof))
    coll.on_viewchange(m.VC.construct_viewchange(keysets[3], 13, 7))
    nv = coll.try_new_view(block_num=7, leader_keys=keysets[0])
    nv.m1_payload = b""
    return [m.VC.verify_new_view(nv, keys, _decider(m, keys))]


def fabricated_m1(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 17)
    for ks in keysets:
        coll.on_viewchange(m.VC.construct_viewchange(ks, 17, 9))
    nv = coll.try_new_view(block_num=9, leader_keys=keysets[0])
    fake_proof = m.MSG.encode_sig_and_bitmap(
        keysets[0].sign_hash_aggregated(b"x" * 32).bytes, b"\x0f")
    nv.m1_payload = m.VC.m1_payload(bytes(range(32)), fake_proof)
    return [m.VC.verify_new_view(nv, keys, _decider(m, keys))]


def outsider_and_overlapping(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 19)
    outsider = m.MB.PrivateKeys.from_keys(
        [m.B.PrivateKey.generate(b"\x77")])
    out = [coll.on_viewchange(m.VC.construct_viewchange(outsider, 19, 9)),
           bool(coll.m3_sigs or coll.m2_sigs),
           coll.on_viewchange(m.VC.construct_viewchange(keysets[0], 19, 9))]
    both = m.MB.PrivateKeys.from_keys(list(keysets[0]) + list(keysets[1]))
    out.append(coll.on_viewchange(m.VC.construct_viewchange(both, 19, 9)))
    return out


def tampered_m3(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 15)
    for ks in keysets:
        coll.on_viewchange(m.VC.construct_viewchange(ks, 15, 8))
    nv = coll.try_new_view(block_num=8, leader_keys=keysets[0])
    nv.view_id += 1
    return [m.VC.verify_new_view(nv, keys, _decider(m, keys))]


def loss_below_and_at_quorum(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 21)
    out = [coll.on_viewchange(m.VC.construct_viewchange(ks, 21, 10))
           for ks in keysets[:2]]
    out += [coll.try_new_view(block_num=10, leader_keys=keysets[0]),
            len(coll.m3_sigs)]
    coll = _collector(m, keys, 23)
    out += [coll.on_viewchange(m.VC.construct_viewchange(ks, 23, 11))
            for ks in keysets[:3]]
    nv = coll.try_new_view(block_num=11, leader_keys=keysets[1])
    out += [m.VC.encode_newview(nv),
            m.VC.verify_new_view(nv, keys, _decider(m, keys))]
    return out


def duplicates_and_stale_views(m):
    keysets, keys = _vc_committee(m)
    decider = _decider(m, keys)
    coll = m.VC.ViewChangeCollector(keys, decider, 25)
    msg = m.VC.construct_viewchange(keysets[0], 25, 12)
    out = [coll.on_viewchange(msg)]
    before = (dict(coll.m3_sigs), decider.count(m.Q.Phase.VIEWCHANGE))
    out += [coll.on_viewchange(msg) for _ in range(3)]
    out.append((dict(coll.m3_sigs),
                decider.count(m.Q.Phase.VIEWCHANGE)) == before)
    coll = _collector(m, keys, 27)
    out += [coll.on_viewchange(m.VC.construct_viewchange(keysets[0], v, 13))
            for v in (26, 30)]
    out.append(bool(coll.m3_sigs or coll.m2_sigs))
    return out


def garbled_wire(m):
    """Seeded wire corruption of a VIEWCHANGE and a NEWVIEW: each
    corrupted form fails to decode or is rejected, and leaves nothing."""
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 29)
    wire = m.VC.encode_viewchange(m.VC.construct_viewchange(keysets[0], 29,
                                                            14))
    out = []
    m.FI.reset()
    try:
        for seed in range(8):
            m.FI.set_seed(seed)
            m.FI.arm("vc.wire", garble=True)
            bad = m.FI.garble("vc.wire", wire)
            m.FI.reset()
            out.append(bad)
            try:
                msg = m.VC.decode_viewchange(bad)
            except ValueError:
                out.append("undecodable")
                continue
            out.append(coll.on_viewchange(msg))
        out.append(bool(coll.m3_sigs or coll.m2_sigs))
        out.append(coll.on_viewchange(m.VC.decode_viewchange(wire)))
        coll = _collector(m, keys, 31)
        for ks in keysets:
            coll.on_viewchange(m.VC.construct_viewchange(ks, 31, 15))
        nv_wire = m.VC.encode_newview(
            coll.try_new_view(block_num=15, leader_keys=keysets[0]))
        for seed in range(8):
            m.FI.set_seed(seed)
            m.FI.arm("nv.wire", garble=True)
            bad = m.FI.garble("nv.wire", nv_wire)
            m.FI.reset()
            try:
                got = m.VC.decode_newview(bad)
            except ValueError:
                out.append("undecodable")
                continue
            out.append(m.VC.verify_new_view(got, keys, _decider(m, keys)))
    finally:
        m.FI.reset()
    return out


def conflicting_prepared(m):
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 33)
    hash_a, hash_b = bytes(range(32)), bytes(reversed(range(32)))
    proof_a = _real_prepared_proof(m, keysets, keys, hash_a)
    proof_b = _real_prepared_proof(m, keysets, keys, hash_b)
    return [coll.on_viewchange(m.VC.construct_viewchange(
                keysets[0], 33, 16, hash_a, proof_a)),
            coll.on_viewchange(m.VC.construct_viewchange(
                keysets[1], 33, 16, hash_b, proof_b)),
            coll.m1_payload == m.VC.m1_payload(hash_a, proof_a)]


VIEW_CHANGE = {
    "next_leader": (next_leader, [True] * 4),
    "nil_quorum_and_new_view": (nil_quorum_and_new_view, None),
    "with_prepared_block": (with_prepared_block, None),
    "missing_m1_rejected": (missing_m1, [False]),
    "fabricated_m1_rejected": (fabricated_m1, [False]),
    "outsider_and_overlapping_rejected": (outsider_and_overlapping,
                                          [False, False, True, False]),
    "tampered_m3_rejected": (tampered_m3, [False]),
    "loss_below_and_at_quorum": (loss_below_and_at_quorum, None),
    "duplicates_and_stale_views": (duplicates_and_stale_views,
                                   [True, False, False, False, True, False,
                                    False, False]),
    "garbled_wire": (garbled_wire, None),
    "conflicting_prepared_rejected": (conflicting_prepared,
                                      [True, False, True]),
}


@pytest.mark.parametrize("case", VIEW_CHANGE)
def test_view_change(case, mode):
    scenario, want = VIEW_CHANGE[case]
    jax, port = _on_both(scenario)
    assert port == jax
    if want is not None:
        assert port == want
    if case == "nil_quorum_and_new_view":
        assert port[:6] == [True] * 4 + [False, False] and port[-1] is True
    elif case == "with_prepared_block":
        assert port[:5] == [True] * 5 and port[-1] is True
    elif case == "loss_below_and_at_quorum":
        assert port[:4] == [True, True, None, 2]
        assert port[4:7] == [True] * 3 and port[-1] is True
    elif case == "garbled_wire":
        # nothing leaked from the corrupted VIEWCHANGEs; the pristine one
        # lands; every corrupted NEWVIEW is caught
        assert port[16:18] == [False, True]
        assert all(v in ("undecodable", False) for v in port[1:16:2])
        assert all(v in ("undecodable", False) for v in port[18:])


def test_new_view_aggregates_on_the_cpu_plain_path(monkeypatch):
    """With the twins off and the node's device on the CPU, the NEWVIEW
    check's aggregate_public runs g1_masked_sum's plain version through
    device.masked_pubkey_sum: one dispatch per call, the JAX package's
    verdict on the same NEWVIEW."""
    from harmony_tpu_torch.ops import twin as T_TWIN

    m = PACKAGES["port"]
    T_DV.use_device(False)
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 37)
    block_hash = bytes(range(32))
    proof = _real_prepared_proof(m, keysets, keys, block_hash)
    for ks in keysets[:3]:
        coll.on_viewchange(m.VC.construct_viewchange(ks, 37, 18, block_hash,
                                                     proof))
    wire = m.VC.encode_newview(coll.try_new_view(18, keysets[0]))
    T_DV.use_device(True, device="cpu")
    T_SCHED.reset()
    # the single checks through the twins, the sums on the plain path
    monkeypatch.setattr(T_DV, "_kernels", lambda dev: T_TWIN)
    try:
        before = T_DV.COUNTERS["masked_pubkey_sum"]
        fallbacks = T_DV.COUNTERS["ref_fallback"]
        assert T_VC.verify_new_view(T_VC.decode_newview(wire), keys,
                                    _decider(m, keys)) is True
        assert J_VC.verify_new_view(J_VC.decode_newview(wire), keys,
                                    _decider(PACKAGES["jax"], keys)) is True
        # M3 and the embedded PREPARED proof (no NIL votes): two sums
        assert T_DV.COUNTERS["masked_pubkey_sum"] - before == 2
        assert T_DV.COUNTERS["ref_fallback"] == fallbacks
    finally:
        T_SCHED.reset()
        T_DV.use_device(None)


def test_aggregate_public_honors_twin_mode(monkeypatch):
    """With the twins on, the NEWVIEW path's aggregate_public takes the
    host path and never touches the device sum."""
    from harmony_tpu_torch.ops import curve as CV

    _, keys = _vc_committee(PACKAGES["port"])
    points = [T_RB.pubkey_from_bytes(k) for k in keys]
    mask = T_MASK.Mask(points)
    for i in range(len(points)):
        mask.set_bit(i, True)
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")

    def _boom(*a, **k):
        raise AssertionError("aggregate_public ran a device sum under twins")

    monkeypatch.setattr(CV, "masked_sum_to_affine", _boom)
    monkeypatch.setattr(CV, "masked_sum", _boom)
    assert mask.aggregate_public(device=True) == \
        J_RB.aggregate_pubkeys(points)


def test_view_change_checks_bound_for_the_card_raise(bound_for_the_card):
    """NEWVIEW verification bound for CUDA raises DeviceError here (its
    masked sum, then its single check); so does the collector's vote
    check.  Neither answers False."""
    m = PACKAGES["port"]
    T_DV.use_device(False)
    keysets, keys = _vc_committee(m)
    coll = _collector(m, keys, 35)
    msgs = [m.VC.construct_viewchange(ks, 35, 17) for ks in keysets]
    for x in msgs[:3]:
        assert coll.on_viewchange(x)
    nv = coll.try_new_view(block_num=17, leader_keys=keysets[0])
    T_DV.use_device(True, device="cuda")
    with pytest.raises(T_DV.DeviceError):
        m.VC.verify_new_view(nv, keys, _decider(m, keys))
    with pytest.raises(T_DV.DeviceError):
        coll.on_viewchange(msgs[3])
    assert len(coll.m3_sigs) == 3


# -- Handel aggregation: the unit tier ------------------------------------------------


def test_level_topology_equals_the_jax_package():
    for n in (1, 2, 3, 4, 13, 16, 64, 200):
        assert T_AGG.num_levels(n) == J_AGG.num_levels(n)
        for slot in range(n):
            seen = set()
            for level in range(1, T_AGG.num_levels(n) + 1):
                peers = T_AGG.level_peers(slot, level, n)
                assert peers == J_AGG.level_peers(slot, level, n)
                assert T_AGG.level_span(slot, level, n) == \
                    J_AGG.level_span(slot, level, n)
                assert slot not in peers and all(0 <= p < n for p in peers)
                assert not set(peers) & seen
                seen |= set(peers)
            assert seen == set(range(n)) - {slot}
    assert [T_AGG.num_levels(n) for n in (1, 2, 3, 4, 64, 200)] == \
        [1, 1, 2, 2, 6, 8]
    assert T_AGG.level_span(12, 3, 13) == (8, 13)


def _mk_agg(m, n=8, home=0, leader_slot=0, **kw):
    keys = [m.B.PrivateKey.generate(b"agg-unit-%d" % i) for i in range(n)]
    committee = [k.pub.bytes for k in keys]
    bar = (2 * n) // 3 + 1
    emitted = []
    agg = m.AGG.Aggregator(
        committee, [home], quorum_check=lambda bv: int(bv.sum()) >= bar,
        emit=lambda t, ph, lv, bm, sg: emitted.append((t, ph, lv, bm, sg)),
        leader_slot=leader_slot, **kw)
    return agg, keys, emitted


def _contrib(m, keys, payload, slots):
    bits = 0
    for s in slots:
        bits |= 1 << s
    return bits, m.B.aggregate_sigs([keys[s].sign_hash(payload)
                                     for s in slots]).bytes


def _stats(agg):
    return [agg.inbound, agg.merged, agg.dup_dropped, agg.stale_dropped,
            agg.forged, agg.emissions, agg.fallbacks]


def merge_disjoint(m):
    agg, keys, emitted = _mk_agg(m)
    payload = b"\x11" * 32
    agg.seed(m.AGG.PHASE_PREPARE, payload, 1, keys[0].sign_hash(payload))
    bits, sig_b = _contrib(m, keys, payload, [1, 2])
    bm = bits.to_bytes(agg.mask_len, "little")
    out = [agg.on_contribution(m.AGG.PHASE_PREPARE, 1, bm, sig_b),
           agg.on_contribution(m.AGG.PHASE_PREPARE, 1, bm, sig_b)]
    work = agg.tick(m.AGG.PHASE_PREPARE, now=0.0)
    st = agg.phases[m.AGG.PHASE_PREPARE]
    mask = m.MASK.Mask(agg.committee_points)
    mask.set_mask((0b111).to_bytes(agg.mask_len, "little"))
    out += [work, agg.signed_count(m.AGG.PHASE_PREPARE), st.sig.bytes,
            m.RB.verify(mask.aggregate_public(device=False), payload,
                        st.sig.point)]
    sub_bits, sub_sig = _contrib(m, keys, payload, [2])
    out += [agg.on_contribution(m.AGG.PHASE_PREPARE, 1,
                                sub_bits.to_bytes(agg.mask_len, "little"),
                                sub_sig),
            _stats(agg), emitted]
    return out


def merge_overlapping(m):
    agg, keys, _ = _mk_agg(m)
    payload = b"\x22" * 32
    agg.seed(m.AGG.PHASE_PREPARE, payload, 0b11, m.B.aggregate_sigs(
        [keys[0].sign_hash(payload), keys[1].sign_hash(payload)]))
    bits, sig_b = _contrib(m, keys, payload, [1, 2, 3])
    agg.on_contribution(m.AGG.PHASE_PREPARE, 1,
                        bits.to_bytes(agg.mask_len, "little"), sig_b)
    work = agg.tick(m.AGG.PHASE_PREPARE, now=0.0)
    st = agg.phases[m.AGG.PHASE_PREPARE]
    mask = m.MASK.Mask(agg.committee_points)
    mask.set_mask(st.bits.to_bytes(agg.mask_len, "little"))
    return [work, st.bits, st.sig.bytes,
            m.RB.verify(mask.aggregate_public(device=False), payload,
                        st.sig.point), _stats(agg)]


def forged_partial(m):
    agg, keys, _ = _mk_agg(m)
    payload = b"\x33" * 32
    agg.seed(m.AGG.PHASE_PREPARE, payload, 1, keys[0].sign_hash(payload))
    bits, sig_b = _contrib(m, keys, b"\x44" * 32, [1, 2])
    agg.on_contribution(m.AGG.PHASE_PREPARE, 1,
                        bits.to_bytes(agg.mask_len, "little"), sig_b,
                        frm="evil")
    work = agg.tick(m.AGG.PHASE_PREPARE, now=0.0)
    return [work, agg.signed_count(m.AGG.PHASE_PREPARE),
            agg.on_contribution(m.AGG.PHASE_PREPARE, 1,
                                bytes(agg.mask_len + 1), sig_b),
            agg.on_contribution(m.AGG.PHASE_PREPARE, 1,
                                bytes(agg.mask_len), sig_b),
            agg.on_contribution(m.AGG.PHASE_PREPARE, 1, b"\x06",
                                bytes([0xC0]) + bytes(94) + b"\x01"),
            _stats(agg)]


def timeout_escalation(m):
    agg, keys, emitted = _mk_agg(m, home=3, leader_slot=5,
                                 level_timeout_s=0.1, reemit_s=0.05)
    payload = b"\x55" * 32
    agg.seed(m.AGG.PHASE_PREPARE, payload, 1 << 3,
             keys[3].sign_hash(payload), now=0.0)
    agg.tick(m.AGG.PHASE_PREPARE, now=0.0)
    first = list(emitted)
    now = 0.0
    for _ in range(agg.n_levels + 2):
        now += 0.15
        agg.tick(m.AGG.PHASE_PREPARE, now=now)
    return [first, emitted, agg.phases[m.AGG.PHASE_PREPARE].final_sent,
            _stats(agg)]


def quorum_and_proof(m):
    agg, keys, _ = _mk_agg(m)
    payload = b"\x66" * 32
    agg.seed(m.AGG.PHASE_COMMIT, payload, 1, keys[0].sign_hash(payload))
    out = [agg.quorum(m.AGG.PHASE_COMMIT)]
    bits, sig_b = _contrib(m, keys, payload, [1, 2, 3, 4, 5, 6])
    agg.on_contribution(m.AGG.PHASE_COMMIT, 2,
                        bits.to_bytes(agg.mask_len, "little"), sig_b)
    agg.tick(m.AGG.PHASE_COMMIT, now=0.0)
    proof = agg.proof(m.AGG.PHASE_COMMIT)
    mask = m.MASK.Mask(agg.committee_points)
    mask.set_mask(proof[96:])
    out += [agg.quorum(m.AGG.PHASE_COMMIT), proof,
            m.RB.verify(mask.aggregate_public(device=False), payload,
                        m.B.Signature.from_bytes(proof[:96]).point),
            agg.active_phases()]
    return out


def fallback_one_shot(m):
    agg, keys, _ = _mk_agg(m, stall_timeout_s=0.2)
    payload = b"\x77" * 32
    agg.seed(m.AGG.PHASE_PREPARE, payload, 1, keys[0].sign_hash(payload),
             fallback="direct-vote", now=0.0)
    return [agg.stalled(0.1), agg.stalled(0.5),
            agg.take_fallback(m.AGG.PHASE_PREPARE),
            agg.take_fallback(m.AGG.PHASE_PREPARE), agg.stalled(1.0),
            agg.fallbacks]


AGGREGATION = {
    "merge_disjoint_adds_and_dedups": merge_disjoint,
    "merge_overlapping_keeps_heavier": merge_overlapping,
    "forged_partial_rejected_never_merged": forged_partial,
    "timeout_escalation_reaches_leader": timeout_escalation,
    "quorum_and_proof_shape": quorum_and_proof,
    "fallback_is_one_shot": fallback_one_shot,
}


@pytest.mark.parametrize("case", AGGREGATION)
def test_aggregation(case, mode):
    jax, port = _on_both(AGGREGATION[case])
    assert port == jax
    if case == "merge_disjoint_adds_and_dedups":
        assert port[:2] == ["queued", "dup"]
        assert (port[2]["merged"], port[2]["forged"], port[3]) == (1, 0, 3)
        assert port[5:7] == [True, "stale"] and port[7][1:3] == [1, 1]
    elif case == "merge_overlapping_keeps_heavier":
        assert port[0]["merged"] == 1 and port[1] == 0b1110
        assert port[3] is True
    elif case == "forged_partial_rejected_never_merged":
        work = port[0]
        assert (work["forged"], work["merged"], work["forged_from"]) == \
            (1, 0, ["evil"])
        assert port[1:5] == [1, "malformed", "malformed", "queued"]
    elif case == "timeout_escalation_reaches_leader":
        assert port[0] and all(t != 5 for t, *_ in port[0])
        assert port[1][-1][0] == 5 and port[2] >= 1
    elif case == "quorum_and_proof_shape":
        assert port[0] is False and port[1] is True
        assert len(port[2]) == 97 and port[3] is True
    else:
        assert port == [[], [T_AGG.PHASE_PREPARE], "direct-vote", None, [],
                        1]


def test_handel_verify_rides_the_consensus_lane(monkeypatch):
    """On the device path a partial's check is one sched.agg_verify on
    CONSENSUS: an honest partial verifies, a forged one does not."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T_DV.use_device(True, device="cpu")
    T_SCHED.reset()
    lanes = []
    agg_verify = T_SCHED.agg_verify

    def rec(*a, lane, **k):
        lanes.append(lane)
        return agg_verify(*a, lane=lane, **k)

    monkeypatch.setattr(T_SCHED, "agg_verify", rec)
    try:
        m = PACKAGES["port"]
        agg, keys, _ = _mk_agg(m)
        payload = b"\x88" * 32
        honest = _contrib(m, keys, payload, [1, 2, 5])
        forged = _contrib(m, keys, b"\x99" * 32, [1, 2, 5])
        assert agg._verify(payload, *honest) is not None
        assert agg._verify(payload, *forged) is None
        assert agg._verify(payload, honest[0], b"\x00" * 95) is None
        assert lanes == [T_SCHED.Lane.CONSENSUS] * 2
    finally:
        T_SCHED.reset()
        T_DV.use_device(None)


def test_handel_verify_bound_for_the_card_raises(bound_for_the_card):
    m = PACKAGES["port"]
    agg, keys, _ = _mk_agg(m)
    payload = b"\x88" * 32
    for bits, sig_b in (_contrib(m, keys, payload, [1, 2]),
                        _contrib(m, keys, b"\x99" * 32, [1, 2])):
        with pytest.raises(T_DV.DeviceError):
            agg._verify(payload, bits, sig_b)
