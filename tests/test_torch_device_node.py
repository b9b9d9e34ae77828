"""The rest of the port's device.py: the breaker-guarded dispatch and its
host fallback, the AUTO switch, agg_verify_on_device, masked_pubkey_sum
with its cache slot, and the program-shape counters.

Two dispatches run the port's real CPU plain path (a quorum check from
payload bytes at bucket 8, and the masked key sum): their verdict and
affine limbs are held against ``harmony_tpu.ref``, the oracle the JAX
package's own tests use for the masked sum.  The rest runs with the
bigint twins (``HARMONY_KERNEL_TWIN=1``) on both packages, whose
verdicts, counters and program names must be equal.
"""

import time

import pytest
import torch

from harmony_tpu import device as JD
from harmony_tpu.ref import bls as J_RB
from harmony_tpu.ref.curve import g1, g2
from harmony_tpu.ref.hash_to_curve import hash_to_g2
from harmony_tpu.ref.params import R_ORDER
from harmony_tpu.resilience import CircuitBreaker as JBreaker
from harmony_tpu_torch import device as TD
from harmony_tpu_torch import faultinject as T_FI
from harmony_tpu_torch.kernels import g1_masked_sum as KG
from harmony_tpu_torch.resilience import CircuitBreaker as TBreaker

SKS = [J_RB.keygen(bytes([70 + i])) for i in range(5)]
PKS = [J_RB.pubkey(sk) for sk in SKS]
PAYLOAD = b"harmony commit: shard 1, block 42"
BITS = [1, 0, 1, 1, 1]


def _agg_sig(bits, payload=PAYLOAD):
    return J_RB.sign(sum(sk for sk, b in zip(SKS, bits) if b) % R_ORDER,
                     payload)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # the twins only where a test asks for them: other files of a test
    # process may have left HARMONY_KERNEL_TWIN set
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    monkeypatch.setattr(TD, "BREAKER", TBreaker("device", 5, 30.0))
    monkeypatch.setattr(JD, "BREAKER", JBreaker("device", 5, 30.0))
    yield
    TD.use_device(None)
    JD.use_device(None)
    TD.set_dispatch_deadline(None)
    JD.set_dispatch_deadline(None)
    T_FI.reset()


# -- _guarded: its three outcomes, as the JAX package's --------------------------


def _guarded_outcomes(dv, **kw):
    """(result, dispatched, ref_fallback delta, breaker failures) of a
    raising dispatch, a dispatch under an OPEN breaker and a dispatch
    that overruns its deadline (``kw``: the port's device argument)."""
    out = []

    def run(dispatch):
        calls = []
        before = dv.COUNTERS["ref_fallback"]

        def counted():
            calls.append(1)
            return dispatch()

        res = dv._guarded("agg_verify", counted, lambda: "fallback", **kw)
        out.append((res, len(calls), dv.COUNTERS["ref_fallback"] - before,
                    dv.BREAKER._failures, dv.BREAKER.state))

    def raises():
        raise RuntimeError("launch failed")

    run(raises)
    run(lambda: "device")
    dv.set_dispatch_deadline(0.001)

    def slow():
        time.sleep(0.01)
        return "device, late"

    run(slow)
    dv.set_dispatch_deadline(None)
    for _ in range(4):
        dv.BREAKER.record_failure()
    run(lambda: "device")  # OPEN: never dispatched
    return out


def test_guarded_outcomes_equal_the_jax_package():
    got = _guarded_outcomes(TD, device=torch.device("cpu"))
    assert got == _guarded_outcomes(JD)
    assert got == [("fallback", 1, 1, 1, "closed"),
                   ("device", 1, 0, 0, "closed"),
                   ("device, late", 1, 0, 1, "closed"),
                   ("fallback", 0, 1, 5, "open")]


def test_a_wrapper_refusing_its_tensors_is_counted_and_answered():
    """A kernel wrapper that raises (here: a table off the CPU that is not
    on CUDA) is a counted, logged fallback with the host's verdict."""
    table = TD.CommitteeTable(PKS, device="meta")
    h = hash_to_g2(PAYLOAD)
    before = TD.COUNTERS["ref_fallback"], KG.LAUNCHES
    assert TD.agg_verify_hashed_on_device(table, BITS, h,
                                          _agg_sig(BITS)) is True
    assert TD.COUNTERS["ref_fallback"] == before[0] + 1
    assert KG.LAUNCHES == before[1]
    assert TD.BREAKER._failures == 1


def test_injected_dispatch_fault_is_one_counted_fallback(monkeypatch):
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    table = TD.CommitteeTable(PKS, device="cpu")
    h, sig = hash_to_g2(PAYLOAD), _agg_sig(BITS)
    T_FI.arm("device.dispatch", times=1)
    before = TD.COUNTERS["ref_fallback"]
    assert TD.agg_verify_hashed_on_device(table, BITS, h, sig) is True
    assert TD.agg_verify_hashed_on_device(table, [1, 1, 1, 1, 1], h,
                                          sig) is False
    assert TD.COUNTERS["ref_fallback"] == before + 1
    assert TD.BREAKER._failures == 0 and TD.BREAKER.state == "closed"


def test_on_the_card_only_an_injected_fault_reaches_the_host():
    """On CUDA a raising dispatch and an OPEN breaker raise DeviceError and
    never run the fallback; an injected fault is the one counted host
    answer.  (Only the device's type is read: no card is needed.)"""
    card = torch.device("cuda")
    host = []

    def fallback():
        host.append(1)
        return "host"

    def raises():
        raise RuntimeError("kernel failed to launch")

    before = TD.COUNTERS["ref_fallback"]
    with pytest.raises(TD.DeviceError, match="kernel failed to launch"):
        TD._guarded("verify", raises, fallback, device=card)
    assert (host, TD.COUNTERS["ref_fallback"], TD.BREAKER._failures) == \
        ([], before, 1)
    T_FI.arm("device.dispatch", times=1)
    assert TD._guarded("verify", lambda: "card", fallback,
                       device=card) == "host"
    assert TD._guarded("verify", lambda: "card", fallback,
                       device=card) == "card"
    assert TD.COUNTERS["ref_fallback"] == before + 1
    for _ in range(5):
        TD.BREAKER.record_failure()
    with pytest.raises(TD.DeviceError, match="breaker open"):
        TD._guarded("verify", lambda: "card", fallback, device=card)
    assert host == [1] and TD.COUNTERS["ref_fallback"] == before + 1


def test_entry_points_bound_for_the_card_raise_here(monkeypatch):
    """Asked for CUDA on a machine without it, with the twins switched on,
    an entry point fails its dispatch and raises; nothing answers from
    the host or the twins."""
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    h = hash_to_g2(PAYLOAD)
    before = TD.COUNTERS["ref_fallback"]
    for call in (
            lambda: TD.verify_on_device(PKS[0], PAYLOAD, g2.mul(h, SKS[0]),
                                        device="cuda"),
            lambda: TD.verify_many_on_device(PKS[:1], [h],
                                             [g2.mul(h, SKS[0])],
                                             device="cuda"),
            lambda: TD.masked_pubkey_sum(PKS, BITS, lambda: "host",
                                         device="cuda")):
        with pytest.raises(TD.DeviceError):
            call()
    assert TD.COUNTERS["ref_fallback"] == before


def test_the_twins_are_off_on_the_card(monkeypatch):
    from harmony_tpu_torch.ops import bls as OB
    from harmony_tpu_torch.ops import twin as TW

    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    assert TD.kernel_twin_active("cpu") and TD._kernels("cpu") is TW
    assert not TD.kernel_twin_active("cuda")
    assert TD._kernels(torch.device("cuda", 0)) is OB
    TD.use_device(True, device="cuda")
    assert not TD.kernel_twin_active()
    TD.use_device(True, device="cpu")
    assert TD.kernel_twin_active()
    TD.use_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert not TD.kernel_twin_active()

    class OnTheCard:
        is_cuda = True

    with pytest.raises(RuntimeError, match="no tensor on the card"):
        TW.verify(OnTheCard(), OnTheCard(), OnTheCard())


# -- devices: explicit, never chosen on their own ------------------------------------


def test_no_cuda_and_no_device_asked_for_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TD.verify_on_device(PKS[0], PAYLOAD, None),
                 lambda: TD.masked_pubkey_sum(PKS, BITS, lambda: None),
                 lambda: TD.get_committee_table([b"k"], PKS[:1])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    TD.use_device(True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.resolve_device()
    TD.use_device(True, device="cpu")
    assert TD.resolve_device() == torch.device("cpu")
    assert TD.resolve_device("meta") == torch.device("meta")


def test_auto_asks_cuda(monkeypatch):
    monkeypatch.setattr(TD, "_AUTO", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert TD.device_enabled() is False
    monkeypatch.setattr(TD, "_AUTO", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TD.device_enabled() is True
    monkeypatch.setattr(TD, "_AUTO", None)
    TD.use_device(True)
    assert TD.device_enabled() is True
    TD.use_device(False)
    assert TD.device_enabled() is False


# -- the entry points through the twins, against the JAX package's ----------------


def _drive(dv, table):
    """Every entry point once through the twins: (verdicts, counter
    deltas, program names used)."""
    h = hash_to_g2(PAYLOAD)
    sig = _agg_sig(BITS)
    seen0 = set(dv._SEEN_PROGRAMS)
    before = {k: dv.COUNTERS[k] for k in ("verify", "agg_verify",
                                          "batch_verify", "ref_fallback")}
    out = [
        dv.agg_verify_hashed_on_device(table, BITS, h, sig),
        dv.agg_verify_hashed_on_device(table, [1, 1, 1, 1, 1], h, sig),
        dv.agg_verify_on_device(table, BITS, PAYLOAD, sig),
        dv.agg_verify_batch_on_device(
            table, [BITS, BITS, [0, 1, 0, 0, 0]], [h, h, h],
            [sig, g2.neg(sig), g2.mul(h, SKS[1])]),
        dv.verify_on_device(PKS[2], PAYLOAD, g2.mul(h, SKS[2])),
        dv.verify_many_on_device(
            PKS[:3], [h] * 3,
            [g2.mul(h, SKS[0]), g2.mul(h, SKS[0]), g2.mul(h, SKS[2])]),
    ]
    deltas = {k: dv.COUNTERS[k] - v for k, v in before.items()}
    return out, deltas, sorted(set(dv._SEEN_PROGRAMS) - seen0)


def test_entry_points_through_the_twins_equal_the_jax_package(monkeypatch):
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    monkeypatch.setattr(TD, "_SEEN_PROGRAMS", set())
    monkeypatch.setattr(JD, "_SEEN_PROGRAMS", set())
    JD.use_device(True)
    TD.use_device(True, device="cpu")
    port = _drive(TD, TD.CommitteeTable(PKS))
    jax = _drive(JD, JD.CommitteeTable(PKS))
    assert port == jax
    assert port[0] == [True, False, True, [True, False, True], True,
                       [True, False, True]]
    assert port[2] == ["agg_verify_b8", "agg_verify_batch_b8x8",
                       "verify_w1", "verify_w8"]


def test_program_first_use_and_metrics(monkeypatch):
    monkeypatch.setattr(TD, "_SEEN_PROGRAMS", set())
    miss, hit = TD.JIT["miss"], TD.JIT["hit"]
    assert TD._program_first_use("masked_sum_w8") is True
    assert TD._program_first_use("masked_sum_w8") is False
    TD.mark_warm("verify_w8")
    assert TD._program_first_use("verify_w8") is False
    assert (TD.JIT["miss"] - miss, TD.JIT["hit"] - hit) == (1, 2)
    text = TD.expose_metrics()
    for family in ("harmony_device_checks_total",
                   'harmony_device_checks_total{kind="masked_pubkey_sum"}',
                   "harmony_device_kernel_twin 0",
                   "harmony_device_dispatch_seconds_bucket",
                   'harmony_device_transfer_bytes_total{direction="h2d"}',
                   'harmony_device_jit_programs_total{cache="miss"}',
                   "harmony_device_jit_compile_seconds"):
        assert family in text


def test_masked_pubkey_sum_twins_take_the_fallback(monkeypatch):
    monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
    before = TD.COUNTERS["masked_pubkey_sum"]
    assert TD.masked_pubkey_sum(PKS, BITS, lambda: "host") == "host"
    assert TD.COUNTERS["masked_pubkey_sum"] == before


# -- the real CPU plain path: two dispatches --------------------------------------


def test_agg_verify_on_device_on_the_cpu_plain_path(monkeypatch):
    monkeypatch.setattr(TD, "_SEEN_PROGRAMS", set())
    table = TD.CommitteeTable(PKS, device="cpu")
    sig = _agg_sig(BITS)
    before = {k: TD.COUNTERS[k] for k in ("agg_verify", "ref_fallback")}
    h2d, miss = TD.TRANSFER["h2d"], TD.JIT["miss"]
    got = TD.agg_verify_on_device(table, BITS, PAYLOAD, sig)
    want = J_RB.verify_aggregate([p for p, b in zip(PKS, BITS) if b],
                                 PAYLOAD, sig)
    assert got is want is True
    assert TD.COUNTERS["agg_verify"] == before["agg_verify"] + 1
    assert TD.COUNTERS["ref_fallback"] == before["ref_fallback"]
    # the bitmap (8 words) and the two G2 points (2 x 2 x 2 x 32 words)
    assert TD.TRANSFER["h2d"] - h2d == 4 * (8 + 2 * 128)
    assert TD.JIT["miss"] == miss + 1
    assert TD._SEEN_PROGRAMS == {"agg_verify_b8"}


def test_masked_pubkey_sum_and_its_cache_on_the_cpu_plain_path(monkeypatch):
    monkeypatch.setattr(TD, "_SEEN_PROGRAMS", set())
    want = None
    for p, b in zip(PKS, BITS):
        if b:
            want = g1.add(want, p)
    cache = [None]
    before = TD.COUNTERS["masked_pubkey_sum"], TD.COUNTERS["ref_fallback"]
    h2d = TD.TRANSFER["h2d"]
    got = TD.masked_pubkey_sum(PKS, BITS, lambda: "host", cache=cache,
                               device="cpu")
    assert got == want
    first_h2d = TD.TRANSFER["h2d"] - h2d
    table = cache[0]
    assert tuple(table.shape) == (8, 2, 32) and table.device.type == "cpu"
    assert first_h2d == table.numel() * 4 + 8 * 4
    # the second call finds the table in the slot: the bitmap alone ships
    bits2 = [0, 1, 0, 0, 1]
    h2d = TD.TRANSFER["h2d"]
    got2 = TD.masked_pubkey_sum(PKS, bits2, lambda: "host", cache=cache,
                                device="cpu")
    assert got2 == g1.add(PKS[1], PKS[4])
    assert cache[0] is table
    assert TD.TRANSFER["h2d"] - h2d == 8 * 4
    assert TD.COUNTERS["masked_pubkey_sum"] == before[0] + 2
    assert TD.COUNTERS["ref_fallback"] == before[1]
    assert TD._SEEN_PROGRAMS == {"masked_sum_w8"}
