"""The port's user-facing BLS API (bls.py) and participation bitmap
(consensus/mask.py) against the JAX package's: ports of
tests/test_bls_api.py and the Mask cases of tests/test_consensus.py.

The port's checks run with the device forced, on the CPU, through the
bigint twins (``HARMONY_KERNEL_TWIN=1``), so that each goes through the
scheduler and device.py; the JAX package's run on its host route.  Bytes,
points and verdicts must be equal.  Two calls of ``Mask.aggregate_public``
run the port's real CPU plain path (one masked-sum dispatch each).
"""

import pytest

from harmony_tpu import bls as J_B
from harmony_tpu import device as J_DV
from harmony_tpu.consensus import mask as J_MASK
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import sched as T_SCHED
from harmony_tpu_torch.consensus import mask as T_MASK

MSG = b"0123456789abcdef0123456789abcdef"


@pytest.fixture(autouse=True)
def _no_twins_unless_asked(monkeypatch):
    """Other files of a test process may have left HARMONY_KERNEL_TWIN
    set; the twins run only where a test asks for them."""
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)


@pytest.fixture(scope="module")
def keys():
    return ([T_B.PrivateKey.generate(bytes([i])) for i in range(3)],
            [J_B.PrivateKey.generate(bytes([i])) for i in range(3)])


@pytest.fixture
def port_on_twins(monkeypatch):
    """The port's device path forced on the CPU through the twins; the
    JAX package's on its host route."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    T_DV.use_device(True, device="cpu")
    J_DV.use_device(False)
    T_SCHED.reset()
    yield
    T_SCHED.reset()
    T_DV.use_device(None)
    J_DV.use_device(None)


# -- the wrappers ---------------------------------------------------------------------


def test_wrapper_roundtrip(keys):
    tk, jk = keys
    k = tk[0]
    assert k.pub.bytes == jk[0].pub.bytes and k.bytes == jk[0].bytes
    assert len(k.pub.bytes) == T_B.PUBKEY_BYTES == J_B.PUBKEY_BYTES
    assert T_B.PublicKey.from_bytes(k.pub.bytes) == k.pub
    assert T_B.PrivateKey.from_bytes(k.bytes).pub == k.pub
    sig = k.sign_hash(MSG)
    assert sig.bytes == jk[0].sign_hash(MSG).bytes
    assert len(sig.bytes) == T_B.SIG_BYTES
    assert T_B.Signature.from_bytes(sig.bytes) == sig
    assert repr(k.pub) == repr(jk[0].pub)


def test_sign_verify_wrapper(keys):
    sig = keys[0][0].sign_hash(MSG)
    assert sig.verify(keys[0][0].pub, MSG)
    assert not sig.verify(keys[0][1].pub, MSG)


def test_pubkey_add_sub(keys):
    a, b = keys[0][0].pub, keys[0][1].pub
    assert a.add(b).sub(b) == a
    assert a.add(b).bytes == keys[1][0].pub.add(keys[1][1].pub).bytes


def test_aggregate_and_verify(keys):
    sigs = [k.sign_hash(MSG) for k in keys[0]]
    agg = T_B.aggregate_sigs(sigs)
    assert agg.bytes == J_B.aggregate_sigs(
        [k.sign_hash(MSG) for k in keys[1]]).bytes
    agg_pk = keys[0][0].pub.add(keys[0][1].pub).add(keys[0][2].pub)
    assert agg.verify(agg_pk, MSG)


def test_cached_deserialization(keys):
    data = keys[0][0].pub.bytes
    p1 = T_B.pubkey_from_bytes_cached(data)
    p2 = T_B.pubkey_from_bytes_cached(data)
    assert p1.point is p2.point
    assert p1.point == J_B.pubkey_from_bytes_cached(data).point


# -- the checks: the port's through its scheduler and device.py --------------------


def _checks(b, keys):
    pk_bytes = [k.pub.bytes for k in keys]
    sigs = [k.sign_hash(MSG) for k in keys]
    agg = b.aggregate_sigs(sigs)
    bad = bytearray(agg.bytes)
    bad[5] ^= 0x40
    pops = [(k.pub.bytes, b.proof_of_possession(k)) for k in keys]
    return [
        b.verify_point(keys[0].pub.point, MSG, sigs[0].point),
        b.verify_point(keys[1].pub.point, MSG, sigs[0].point),
        b.verify_aggregate_bytes(pk_bytes, MSG, agg.bytes),
        b.verify_aggregate_bytes(pk_bytes[:2], MSG, agg.bytes),
        b.verify_aggregate_bytes(pk_bytes, b"x" * 32, agg.bytes),
        b.verify_aggregate_bytes([], MSG, agg.bytes),
        b.verify_aggregate_bytes(pk_bytes, MSG, bytes(bad)),
        b.verify_aggregate_bytes(pk_bytes, MSG, agg.bytes[:95]),
        b.verify_aggregate_bytes([b"\x00" * 48], MSG, agg.bytes),
        b.verify_proofs_of_possession(pops),
        b.verify_proof_of_possession(pops[0][0], pops[1][1]),
        b.verify_proof_of_possession(pops[0][0], b"\xc0" + bytes(95)),
        pops[0][1],
    ]


def test_checks_through_the_device_path_equal_the_jax_host_route(
        keys, port_on_twins):
    before = T_DV.COUNTERS["verify"], T_DV.COUNTERS["ref_fallback"]
    got = _checks(T_B, keys[0])
    assert got == _checks(J_B, keys[1])
    assert got[:12] == [True, False, True, False, False, False, False,
                        False, False, True, False, False]
    # 2 verify_point, 3 well-formed aggregate checks, 3 + 1 proofs
    assert T_DV.COUNTERS["verify"] - before[0] == 9
    assert T_DV.COUNTERS["ref_fallback"] == before[1]


def test_verify_point_takes_the_host_route_when_the_device_is_off(keys):
    T_DV.use_device(False)
    try:
        before = T_DV.COUNTERS["verify"]
        sig = keys[0][2].sign_hash(MSG)
        assert T_B.verify_point(keys[0][2].pub.point, MSG, sig.point)
        assert T_DV.COUNTERS["verify"] == before
    finally:
        T_DV.use_device(None)


def test_a_proof_bound_for_the_card_raises_rather_than_rejects(keys):
    """verify_proofs_of_possession turns an unverifiable proof into False,
    but a check that the card could not run raises DeviceError: here the
    scheduler bound for CUDA has no room and sheds it."""
    T_DV.use_device(True)
    T_SCHED.reset()
    T_SCHED.configure(device="cuda", max_queue_per_lane=0)
    try:
        k = keys[0][0]
        with pytest.raises(T_DV.DeviceError):
            T_B.verify_proofs_of_possession(
                [(k.pub.bytes, T_B.proof_of_possession(k))])
    finally:
        T_SCHED.reset()
        T_DV.use_device(None)


def test_scheduler_disarmed_dispatches_directly(keys, port_on_twins):
    T_SCHED.configure(enabled=False)
    sig = keys[0][1].sign_hash(MSG)
    assert T_B.verify_point(keys[0][1].pub.point, MSG, sig.point)
    assert T_SCHED._SCHED is None  # no scheduler was started


# -- Mask -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def committee(keys):
    sks = [T_B.PrivateKey.generate(bytes([i])) for i in range(10)]
    return [k.pub.point for k in sks]


def _mask_ops(mod, committee):
    m = mod.Mask(committee)
    out = [m.bytes_len(), len(m)]
    for i, on in ((0, True), (7, True), (8, True), (7, False)):
        m.set_bit(i, on)
        out.append(m.mask_bytes())
    out += [m.count_enabled(), m.index_enabled(), list(m.bit_vector())]
    with pytest.raises(IndexError):
        m.set_bit(10, True)
    with pytest.raises(ValueError):
        m.set_mask(b"\x01")
    m.set_mask(bytes([0xFF, 0x03]))
    out.append(m.count_enabled())
    m.clear()
    m.set_key(mod.RB.pubkey_to_bytes(committee[3]), True)
    out += [m.index_enabled(), m.get_signed_pubkeys()]
    with pytest.raises(KeyError):
        m.set_key(b"\x00" * 48, True)
    for i in (0, 2, 5, 9):
        m.set_bit(i, True)
    out.append(m.aggregate_public(device=False))
    out.append(mod.bits_from_bytes(bytes([0b101, 0b10]), 10))
    with pytest.raises(ValueError):
        mod.bits_from_bytes(b"\x01", 10)
    return out


def test_mask_operations_equal_the_jax_package(committee):
    got = _mask_ops(T_MASK, committee)
    assert got == _mask_ops(J_MASK, committee)
    assert got[2:6] == [bytes([1, 0]), bytes([0b10000001, 0]),
                        bytes([0b10000001, 1]), bytes([1, 1])]


def test_mask_aggregate_through_the_twins_takes_the_host_path(
        committee, port_on_twins):
    m, j = T_MASK.Mask(committee), J_MASK.Mask(committee)
    for i in (1, 4, 6):
        m.set_bit(i, True)
        j.set_bit(i, True)
    before = T_DV.COUNTERS["masked_pubkey_sum"]
    assert m.aggregate_public() == j.aggregate_public(device=False)
    assert T_DV.COUNTERS["masked_pubkey_sum"] == before
    assert T_MASK.Mask([]).aggregate_public() is None


def test_mask_aggregate_on_the_cpu_plain_path_reuses_its_cache(committee):
    """Mask.aggregate_public(device=True) goes through masked_pubkey_sum
    (one dispatch a call, bucket 16 for 10 keys) and keeps the key table
    in its one-slot cache."""
    T_DV.use_device(True, device="cpu")
    try:
        m, j = T_MASK.Mask(committee), J_MASK.Mask(committee)
        for i in (0, 3, 9):
            m.set_bit(i, True)
            j.set_bit(i, True)
        before = T_DV.COUNTERS["masked_pubkey_sum"]
        fallbacks = T_DV.COUNTERS["ref_fallback"]
        assert m.aggregate_public() == j.aggregate_public(device=False)
        table = m._device_pks[0]
        assert tuple(table.shape) == (16, 2, 32)
        m.set_bit(3, False)
        j.set_bit(3, False)
        assert m.aggregate_public() == j.aggregate_public(device=False)
        assert m._device_pks[0] is table
        assert T_DV.COUNTERS["masked_pubkey_sum"] == before + 2
        assert T_DV.COUNTERS["ref_fallback"] == fallbacks
    finally:
        T_DV.use_device(None)
