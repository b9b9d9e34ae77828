"""The port's chain engine and the host code under it against the JAX
package's: a port of tests/test_chain_engine.py, with the headers' hashes
and RLP bytes, keccak, Dec arithmetic, vote power, quorum decisions,
effective stake and committee election held equal on seeded inputs.

The port's engine runs in two modes: with the device path forced on the
CPU through the bigint twins (``HARMONY_KERNEL_TWIN=1``), so that every
check goes through its scheduler and ``device.py``, and in host mode (the
device path off).  The JAX package's runs on its host route.  Verdicts,
bytes and points must be equal.  A check bound for CUDA raises
``DeviceError`` here and never answers False.
"""

import random
import types

import numpy as np
import pytest
import torch

from harmony_tpu import bls as J_B
from harmony_tpu import device as J_DV
from harmony_tpu import rlp as J_RLP
from harmony_tpu.chain import engine as J_ENG
from harmony_tpu.chain import header as J_HDR
from harmony_tpu.consensus import mask as J_MASK
from harmony_tpu.consensus import quorum as J_Q
from harmony_tpu.consensus import signature as J_SIG
from harmony_tpu.consensus import votepower as J_VP
from harmony_tpu.core import rawdb as J_RAWDB
from harmony_tpu.numeric import dec as J_DEC
from harmony_tpu.ops import interop as J_I
from harmony_tpu.ref import keccak as J_K
from harmony_tpu.shard import committee as J_COM
from harmony_tpu.staking import effective as J_EFF
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import resilience as T_RS
from harmony_tpu_torch import rlp as T_RLP
from harmony_tpu_torch import sched as T_SCHED
from harmony_tpu_torch.chain import engine as T_ENG
from harmony_tpu_torch.chain import header as T_HDR
from harmony_tpu_torch.consensus import mask as T_MASK
from harmony_tpu_torch.consensus import quorum as T_Q
from harmony_tpu_torch.consensus import signature as T_SIG
from harmony_tpu_torch.consensus import votepower as T_VP
from harmony_tpu_torch.numeric import dec as T_DEC
from harmony_tpu_torch.ref import keccak as T_K
from harmony_tpu_torch.shard import committee as T_COM
from harmony_tpu_torch.staking import effective as T_EFF

PACKAGES = {
    "jax": types.SimpleNamespace(B=J_B, ENG=J_ENG, HDR=J_HDR, MASK=J_MASK,
                                 SIG=J_SIG, engine_device=False),
    "port": types.SimpleNamespace(B=T_B, ENG=T_ENG, HDR=T_HDR, MASK=T_MASK,
                                  SIG=T_SIG, engine_device=None),
}
MODES = ("host", "device")
N_KEYS = 4
VERSIONS = ("v0", "v1", "v2", "v3")


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
    yield request.param
    T_SCHED.reset()
    T_DV.use_device(None)
    J_DV.use_device(None)


@pytest.fixture(scope="module")
def keys():
    return {name: [m.B.PrivateKey.generate(bytes([30 + i]))
                   for i in range(N_KEYS)]
            for name, m in PACKAGES.items()}


def _engine(m, keys, **kw):
    serialized = [k.pub.bytes for k in keys]
    return m.ENG.Engine(lambda shard, epoch: m.ENG.EpochContext(serialized),
                        device=m.engine_device, **kw)


def _sign_header(m, header, keys, signer_idx):
    payload = m.SIG.construct_commit_payload(
        header.hash(), header.block_num, header.view_id, True)
    agg = m.B.aggregate_sigs([keys[i].sign_hash(payload)
                              for i in signer_idx])
    mask = m.MASK.Mask([k.pub.point for k in keys])
    for i in signer_idx:
        mask.set_bit(i, True)
    return agg.bytes, mask.mask_bytes()


def _on_both(scenario, keys):
    """scenario(m, keys) on each package; the two results."""
    return (scenario(PACKAGES["jax"], keys["jax"]),
            scenario(PACKAGES["port"], keys["port"]))


# -- headers, RLP, keccak ---------------------------------------------------------------


def _header_fields(rng, version):
    def b(n):
        return bytes(rng.randrange(256) for _ in range(n))

    return dict(
        shard_id=rng.randrange(4), block_num=rng.randrange(1 << 40),
        epoch=rng.randrange(2000), view_id=rng.randrange(1 << 40),
        parent_hash=b(32), root=b(32), tx_root=b(32), receipt_root=b(32),
        out_cx_root=b(32), timestamp=rng.randrange(1 << 35),
        last_commit_sig=b(96), last_commit_bitmap=b(25),
        extra=b(rng.randrange(40)), vrf=b(rng.choice((0, 1, 96))),
        vdf=b(rng.choice((0, 258))), shard_state=b(rng.randrange(300)),
        cross_links=b(rng.randrange(70)), slashes=b(rng.randrange(3)),
        version=version)


@pytest.mark.parametrize("version", VERSIONS)
def test_header_hash_and_rlp_equal_the_jax_package(version):
    rng = random.Random(f"header-{version}")
    for _ in range(4):
        fields = _header_fields(rng, version)
        t, j = T_HDR.Header(**fields), J_HDR.Header(**fields)
        assert t.signing_fields() == j.signing_fields()
        assert t.hash() == j.hash() and len(t.hash()) == 32
        assert T_RLP.decode(t.signing_fields()) == \
            J_RLP.decode(j.signing_fields())
        # the JAX package's storage codec round-trips the same header to
        # the port's hash (the rawdb test of the original)
        back = J_RAWDB.decode_header(J_RAWDB.encode_header(j))
        assert back == j and back.hash() == t.hash()


def test_header_hash_includes_carried_commit_proof():
    h = T_HDR.Header(shard_id=0, block_num=5, epoch=1, view_id=5)
    base = h.hash()
    h.last_commit_sig = b"x" * 96
    h.last_commit_bitmap = b"\x0f"
    assert h.hash() != base
    assert h.hash() == J_HDR.Header(
        shard_id=0, block_num=5, epoch=1, view_id=5,
        last_commit_sig=b"x" * 96, last_commit_bitmap=b"\x0f").hash()
    assert T_HDR.Header(shard_id=0, block_num=6, epoch=1,
                        view_id=5).hash() != base


def test_header_versions_hash_distinctly():
    kw = dict(shard_id=1, block_num=7, epoch=2, view_id=7)
    hashes = {T_HDR.Header(version=v, **kw).hash() for v in VERSIONS}
    assert len(hashes) == 4
    with pytest.raises(ValueError):
        T_HDR.Header(version="v9", **kw).hash()


def _rlp_item(rng, depth=0):
    kind = rng.randrange(4 if depth < 3 else 2)
    if kind == 0:
        return rng.choice((0, 1, 127, 128, 255, 256, 1 << 64,
                           rng.randrange(1 << 200)))
    if kind == 1:
        return bytes(rng.randrange(256)
                     for _ in range(rng.choice((0, 1, 55, 56, 300))))
    return [_rlp_item(rng, depth + 1) for _ in range(rng.randrange(5))]


RLP_MALFORMED = [b"", b"\x81\x05", b"\xb8\x05abc", b"\xb8\x00", b"\xb8\x37" +
                 bytes(55), b"\xc3\x01\x02", b"\x01\x02", b"\xf8\x01\x01",
                 b"\x82\x00"]


def test_rlp_codec_equals_the_jax_package():
    rng = random.Random("rlp")
    for _ in range(60):
        item = _rlp_item(rng)
        enc = T_RLP.encode(item)
        assert enc == J_RLP.encode(item)
        assert T_RLP.decode(enc) == J_RLP.decode(enc)
    for bad in RLP_MALFORMED:
        errors = []
        for codec in (T_RLP, J_RLP):
            with pytest.raises(ValueError) as e:
                codec.decode(bad)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    with pytest.raises(T_RLP.RLPError):
        T_RLP.encode(True)
    with pytest.raises(T_RLP.RLPError):
        T_RLP.decode_int(b"\x00\x01")
    assert T_RLP.decode_int(b"\x01\x00") == J_RLP.decode_int(b"\x01\x00")


def test_keccak_equals_the_jax_package():
    assert T_K.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    rng = random.Random("keccak")
    for n in (1, 135, 136, 137, 271, 272, 1000):
        data = bytes(rng.randrange(256) for _ in range(n))
        assert T_K.keccak256(data) == J_K.keccak256(data)


# -- Dec, vote power, quorum, effective stake, committees ---------------------------


def _dec_ops(D, raws, strings):
    out = []
    for a, b in zip(raws, raws[1:]):
        x, y = D.Dec(a), D.Dec(b)
        out += [x.add(y).raw, x.sub(y).raw, x.mul(y).raw,
                x.mul_truncate(y).raw, x.mul_int(7).raw, x.neg().raw,
                x.cmp(y), x.gt(y), x.gte(y), x.lt(y), x.lte(y),
                x.equal(y), x.is_zero(), x.is_negative(),
                x.truncate_int(), x.round_int(), repr(x)]
        if b:
            out += [x.quo(y).raw, x.quo_truncate(y).raw]
    for s in strings:
        out.append(D.Dec.from_str(s).raw)
    out += [D.Dec.with_prec(12345, 3).raw, D.new_dec(9).raw,
            D.one_dec().raw, D.zero_dec().raw]
    return out


def test_dec_arithmetic_equals_the_jax_package():
    rng = random.Random("dec")
    unit = 10 ** 18
    raws = [0, unit, -unit, unit // 2, 3 * unit // 2, 5 * unit // 2,
            -5 * unit // 2]
    raws += [rng.randrange(-10 ** 30, 10 ** 30) for _ in range(40)]
    raws += [rng.randrange(-10 ** 18, 10 ** 18) for _ in range(20)]
    strings = ["0", "1", "-1", "0.15", "0.35", "-2.5", "123.000000000000000001",
               ".5", "7."]
    assert _dec_ops(T_DEC, raws, strings) == _dec_ops(J_DEC, raws, strings)
    for D in (T_DEC, J_DEC):
        with pytest.raises(ValueError):
            D.Dec.from_str("0.0000000000000000001")
        with pytest.raises(ValueError):
            D.Dec.with_prec(1, 19)


def _slots(VP, D, rng, n, n_harmony):
    slots = []
    for i in range(n):
        key = bytes([i]) * 48
        stake = (None if i < n_harmony
                 else D.Dec(rng.randrange(1, 10 ** 24)))
        slots.append(VP.Slot(address=f"one{i}", bls_pubkey=key,
                             effective_stake=stake))
    return slots


def _roster_view(r):
    return ([(k, v.is_harmony, v.group_percent.raw, v.overall_percent.raw,
              v.effective_stake.raw) for k, v in r.voters.items()],
            r.ordered_keys, r.our_voting_power.raw,
            r.their_voting_power.raw, r.total_effective_stake.raw,
            r.harmony_slot_count)


def _quorum_decisions(VP, Q, D, seed):
    rng = random.Random(seed)
    out = []
    for n, n_harmony in ((4, 1), (8, 4), (7, 7), (25, 0), (200, 68)):
        slots = _slots(VP, D, rng, n, n_harmony)
        roster = VP.compute_roster(slots, D.Dec.from_str("0.68"),
                                   D.Dec.from_str("0.32"))
        out.append(_roster_view(roster))
        keys = [s.bls_pubkey for s in slots]
        uni = Q.Decider(Q.Policy.UNIFORM, keys)
        staked = Q.Decider(Q.Policy.STAKED, keys, roster)
        for _ in range(6):
            bits = [int(rng.random() < rng.random()) for _ in range(n)]
            out.append((uni.is_quorum_achieved_by_mask(bits),
                        staked.is_quorum_achieved_by_mask(bits)))
        for i, k in enumerate(keys[: 2 * n // 3 + 1]):
            for d in (uni, staked):
                d.submit_vote(Q.Phase.COMMIT,
                              Q.Ballot(k, b"h", b"s", 1, i))
            out.append((uni.is_quorum_achieved(Q.Phase.COMMIT),
                        staked.is_quorum_achieved(Q.Phase.COMMIT),
                        staked.tallied_power(Q.Phase.COMMIT).raw))
        out.append(list(uni.signers_bitmap(Q.Phase.COMMIT)))
        out.append(uni.submit_vote(Q.Phase.COMMIT,
                                   Q.Ballot(keys[0], b"h", b"s", 1, 0)))
    out.append([Q.uniform_quorum_threshold(n) for n in range(1, 30)])
    out.append(Q.staked_quorum_threshold().raw)
    return out


def test_quorum_decisions_equal_the_jax_package():
    from harmony_tpu.numeric import Dec  # noqa: F401 — package import
    from harmony_tpu_torch.numeric import Dec as T_Dec

    assert T_Dec is T_DEC.Dec
    got = _quorum_decisions(T_VP, T_Q, T_DEC, "quorum")
    assert got == _quorum_decisions(J_VP, J_Q, J_DEC, "quorum")
    with pytest.raises(KeyError):
        T_Q.Decider(T_Q.Policy.UNIFORM, [b"a"]).submit_vote(
            T_Q.Phase.PREPARE, T_Q.Ballot(b"b", b"", b"", 0, 0))
    with pytest.raises(ValueError):
        T_Q.Decider(T_Q.Policy.STAKED, [b"a"])


def _election(EFF, COM, D, seed):
    rng = random.Random(seed)
    orders = {}
    for v in range(30):
        addr = bytes([v]) * 20
        keys = [bytes([v, j]) * 24 for j in range(rng.randrange(1, 4))]
        orders[addr] = EFF.SlotOrder(stake=rng.randrange(1, 10 ** 25),
                                     spread_among=keys, address=addr)
    out = []
    for pull, extended in ((10, False), (11, True), (100, False)):
        med, picks = EFF.apply(orders, pull, extended,
                               exclude_keys={bytes([3, 0]) * 24})
        out.append((med.raw, [(p.addr, p.key, p.raw_stake.raw,
                               p.epos_stake.raw) for p in picks]))
    harmony = [(bytes([200 + i]) * 20, bytes([200 + i]) * 48)
               for i in range(8)]
    state = COM.epos_staked_committee(3, 2, harmony, 4, orders, 16)
    out.append([(c.shard_id, [(s.ecdsa_address, s.bls_pubkey,
                               None if s.effective_stake is None
                               else s.effective_stake.raw)
                              for s in c.slots]) for c in state.shards])
    out.append(state.find_committee(1).bls_pubkeys())
    out.append(state.find_committee(5))
    out.append(EFF.median([]).raw)
    return out


def test_effective_stake_and_committee_election_equal_the_jax_package():
    assert _election(T_EFF, T_COM, T_DEC, "epos") == \
        _election(J_EFF, J_COM, J_DEC, "epos")


def test_committee_tables_lie_on_the_node_device(keys):
    serialized = [k.pub.bytes for k in keys["port"]]
    points = [k.pub.point for k in keys["port"]]
    want = J_I.g1_batch_affine(points)
    T_DV.use_device(False, device="cpu")
    try:
        ctx = T_ENG.EpochContext(serialized)
        table = ctx.device_table()
        assert table.device == torch.device("cpu")
        assert np.array_equal(table.numpy(), want)
        assert ctx.device_table() is table and len(ctx) == N_KEYS
        com = T_COM.Committee(shard_id=0, slots=[
            T_COM.Slot(ecdsa_address=b"", bls_pubkey=k) for k in serialized])
        assert np.array_equal(com.device_pubkey_table().numpy(), want)
        padded = ctx.committee_table()
        assert (padded.size, padded.device.type) == (8, "cpu")
        assert ctx.committee_table() is padded
    finally:
        T_DV.use_device(None)


def test_verify_buckets_follow_the_device():
    assert T_ENG.VERIFY_BUCKETS_CPU == T_DV.BATCH_BUCKETS_CPU
    assert T_ENG.VERIFY_BUCKETS_GPU == T_DV.BATCH_BUCKETS_GPU
    assert T_ENG.VERIFY_BUCKETS == J_ENG.VERIFY_BUCKETS == (8, 64)
    try:
        T_DV.use_device(False, device="cuda")
        assert T_ENG.verify_buckets() == (8, 64, 256)
        assert [T_ENG.bucket_size(n) for n in (1, 9, 65, 300)] == \
            [8, 64, 256, 256]
        # the device path on with the node's device on the CPU: CPU buckets
        T_DV.use_device(True, device="cpu")
        assert T_ENG.verify_buckets() == J_ENG.VERIFY_BUCKETS_CPU
        assert [T_ENG.bucket_size(n) for n in (1, 9, 65)] == [8, 64, 64]
    finally:
        T_DV.use_device(None)


def test_verify_buckets_without_a_node_device_or_cuda_are_the_cpus(
        monkeypatch):
    """With no node device (the default) on a host without CUDA, the
    buckets are the CPU's, the JAX package's answer there, and
    bucket_size follows them: resolving the device raises, the buckets do
    not."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    T_DV.use_device(None)
    J_DV.use_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        T_DV.resolve_device()
    assert T_ENG.verify_buckets() == J_ENG.verify_buckets() == (8, 64)
    assert [T_ENG.bucket_size(n) for n in (1, 9, 65, 300)] == \
        [J_ENG.bucket_size(n) for n in (1, 9, 65, 300)] == [8, 64, 64, 64]


# -- the engine's checks ------------------------------------------------------------


def verify_and_cache(m, keys):
    eng = _engine(m, keys)
    h = m.HDR.Header(shard_id=0, block_num=10, epoch=2, view_id=10)
    sig, bitmap = _sign_header(m, h, keys, [0, 1, 2, 3])
    sig2, bitmap2 = _sign_header(m, h, keys, [0, 1])
    sig3, _ = _sign_header(m, h, keys, [0, 1, 2])
    out = [eng.verify_header_signature(h, sig, bitmap),
           eng.verify_header_signature(h, sig, bitmap),
           eng.verify_header_signature(h, sig2, bitmap2),
           eng.verify_header_signature(h, sig3, bitmap),
           eng.verify_header_signature(h, bytes(96), bitmap),
           eng.verify_header_signature(h, sig, bitmap + b"\x00"),
           # the cache key has no payload shape: a hit whatever is_staking
           eng.verify_header_signature(h, sig, bitmap, is_staking=False)]
    h2 = m.HDR.Header(shard_id=0, block_num=11, epoch=2, view_id=11)
    sig4, bitmap4 = _sign_header(m, h2, keys, [0, 1, 2])
    out += [eng.verify_header_signature(h2, sig4, bitmap4, is_staking=False),
            eng.verify_header_signature(h2, sig4, bitmap4)]
    return out, sig, bitmap, len(eng._verified)


def test_verify_header_signature_and_cache(keys, mode):
    before = T_DV.COUNTERS["agg_verify"], T_DV.COUNTERS["ref_fallback"]
    jax, port = _on_both(verify_and_cache, keys)
    assert port == jax
    assert port[0] == [True, True, False, False, False, False, True, False,
                       True]
    # four checks reach the device path: the two quorum checks, the
    # mismatched signature and the pre-staking payload; the cached ones,
    # the one below quorum and the malformed ones do not
    made = T_DV.COUNTERS["agg_verify"] - before[0]
    assert made == (4 if mode == "device" else 0)
    assert T_DV.COUNTERS["ref_fallback"] == before[1]


def seal_via_child(m, keys):
    eng = _engine(m, keys)
    parent = m.HDR.Header(shard_id=0, block_num=20, epoch=2, view_id=20)
    sig, bitmap = _sign_header(m, parent, keys, [0, 1, 2])
    child = m.HDR.Header(shard_id=0, block_num=21, epoch=2, view_id=21,
                         parent_hash=parent.hash(), last_commit_sig=sig,
                         last_commit_bitmap=bitmap)
    return [eng.verify_seal(parent, child), eng.verify_seal(child, child),
            child.hash()]


def test_verify_seal_via_child(keys, mode):
    jax, port = _on_both(seal_via_child, keys)
    assert port == jax and port[:2] == [True, False]


def _chain(m, keys, n, start, signers=(0, 1, 2, 3)):
    headers, prev = [], bytes(32)
    for i in range(n):
        h = m.HDR.Header(shard_id=0, block_num=start + i, epoch=3,
                         view_id=start + i, parent_hash=prev)
        sig, bitmap = _sign_header(m, h, keys, list(signers))
        headers.append((h, sig, bitmap))
        prev = h.hash()
    return headers


def batched_replay(m, keys):
    eng = _engine(m, keys)
    headers = _chain(m, keys, 5, 100)
    items = list(headers)
    items[2] = (items[2][0], items[1][1], items[2][2])
    first = eng.verify_headers_batch(items)
    second = eng.verify_headers_batch(
        [headers[0], headers[1], headers[3], headers[4]])
    staking = eng.verify_headers_batch(
        [headers[2], headers[2]], is_staking=[True, False])
    with pytest.raises(ValueError):
        eng.verify_headers_batch(headers, is_staking=[True])
    return first, second, staking, [h.hash() for h, _, _ in headers]


def test_batched_replay(keys, mode):
    jax, port = _on_both(batched_replay, keys)
    assert port == jax
    assert port[:3] == ([True, True, False, True, True], [True] * 4,
                        [True, False])


def test_replay_dispatches_repeats_then_answers_from_the_cache(
        keys, monkeypatch):
    """Repeats inside one batch are all dispatched (the verified-signature
    cache fills after the flush); the same batch again is answered from
    the cache, with the same verdicts, except the forged signature, which
    is checked again (the cache holds only verified signatures).  Without
    the forgery, nothing is dispatched.  A header below quorum is
    rejected on the host."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T_DV.use_device(True, device="cpu")
    J_DV.use_device(False)
    T_SCHED.reset()
    calls = []
    many = T_SCHED.agg_verify_many

    def recorded(table, bits_list, *a, lane=T_SCHED.Lane.SYNC, **k):
        calls.append((len(bits_list), lane))
        return many(table, bits_list, *a, lane=lane, **k)

    monkeypatch.setattr(T_SCHED, "agg_verify_many", recorded)
    try:
        out = {}
        for name, m in PACKAGES.items():
            ks = keys[name]
            distinct = _chain(m, ks, 4, 300)
            below = _chain(m, ks, 1, 310, signers=(0, 1))[0]
            forged = (distinct[1][0], distinct[0][1], distinct[1][2])
            items = [distinct[i % 4] for i in range(12)] + [forged, below]
            eng = _engine(m, ks)
            first = eng.verify_headers_batch(items)
            made = len(calls)
            again = eng.verify_headers_batch(items)
            cached = eng.verify_headers_batch(items[:12] + [below])
            out[name] = (first, again, cached, made, len(calls))
        assert out["port"][:3] == out["jax"][:3]
        assert out["port"][0] == [True] * 12 + [False, False]
        assert out["port"][1] == out["port"][0]
        assert out["port"][2] == [True] * 12 + [False]
        # the 12 repeats and the forgery, then the forgery alone, then none
        assert calls == [(13, T_SCHED.Lane.SYNC), (1, T_SCHED.Lane.SYNC)]
        assert T_DV.COUNTERS["ref_fallback"] == 0
    finally:
        T_SCHED.reset()
        T_DV.use_device(None)
        J_DV.use_device(None)


def test_decode_sig_bitmap_errors_equal_the_jax_package(keys):
    errors = {}
    for name, m in PACKAGES.items():
        eng = _engine(m, keys[name])
        ctx = eng.epoch_context(0, 1)
        assert eng.epoch_context(0, 1) is ctx
        got = []
        for sig, bm in ((bytes([0xC0]) + bytes(95), b"\x0f"),
                        (bytes(96), b"\x0f"), (bytes(95), b"\x0f"),
                        (_sign_header(m, m.HDR.Header(shard_id=0), keys[name],
                                      [0])[0], b"\x0f\x00")):
            try:
                eng.decode_sig_bitmap(ctx, sig, bm)
                got.append("ok")
            except ValueError as e:
                got.append(type(e).__name__)
        errors[name] = got
    assert errors["port"] == errors["jax"]
    assert errors["port"][0] == "ValueError"


# -- a check bound for the card -------------------------------------------------------


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
    monkeypatch.setattr(T_DV, "BREAKER",
                        T_RS.CircuitBreaker("device", 100, 30.0))
    T_DV.use_device(True, device="cuda")
    T_SCHED.reset()
    yield
    T_SCHED.reset()
    T_DV.use_device(None)


def test_a_check_bound_for_the_card_raises(keys, bound_for_the_card):
    """The engine's checks bound for CUDA raise DeviceError here, through
    the scheduler and with it disarmed, and never answer False."""
    m, ks = PACKAGES["port"], keys["port"]
    headers = _chain(m, ks, 2, 400)
    fallbacks = T_DV.COUNTERS["ref_fallback"]
    for armed in (True, False):
        T_SCHED.configure(enabled=armed)
        eng = _engine(m, ks)
        h, sig, bitmap = headers[0]
        with pytest.raises(T_DV.DeviceError):
            eng.verify_header_signature(h, sig, bitmap)
        with pytest.raises(T_DV.DeviceError):
            eng.verify_header_signature(h, sig, bitmap,
                                        lane=T_SCHED.Lane.CONSENSUS)
        with pytest.raises(T_DV.DeviceError):
            eng.verify_headers_batch(headers)
        assert not eng._verified
    assert T_DV.COUNTERS["ref_fallback"] == fallbacks
