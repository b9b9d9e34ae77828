"""The port's sidecar (wire protocol, server, client) against the JAX
package's: a port of the protocol and live-server tests of
tests/test_sidecar.py, with test_engine_routes_checks_through_sidecar, and
one wire-compatibility case, the JAX package's client against the port's
server.  (The native C++ client's test is
``tests/test_torch_sidecar_native.py``.)

The port's server answers on each of its routes: the device path forced
on the CPU through the bigint twins (``HARMONY_KERNEL_TWIN=1``) through
the scheduler or, with the scheduler disarmed, under the exec lock; the
direct branch (the device path off, the accelerator present), with
``ops/bls.py``'s functions swapped for their twins; and the host path.
The verdicts must be the JAX package's.  A check bound for CUDA closes
the connection, and the client raises ``SidecarUnavailable``: never a
verdict.
"""

import threading
import types

import numpy as np
import pytest
import torch

from harmony_tpu import device as J_DV
from harmony_tpu.sidecar import client as J_CL
from harmony_tpu.sidecar import protocol as J_P
from harmony_tpu.sidecar import server as J_SV
from harmony_tpu_torch import bls as T_B
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch import resilience as T_RS
from harmony_tpu_torch import sched as T_SCHED
from harmony_tpu_torch.chain import engine as T_ENG
from harmony_tpu_torch.chain import header as T_HDR
from harmony_tpu_torch.consensus import signature as T_SIG
from harmony_tpu_torch.consensus.mask import Mask
from harmony_tpu_torch.ops import bls as T_OB
from harmony_tpu_torch.ops import twin as T_TWIN
from harmony_tpu_torch.ref import bls as RB
from harmony_tpu_torch.sidecar import client as T_CL
from harmony_tpu_torch.sidecar import protocol as P
from harmony_tpu_torch.sidecar import server as T_SV

MSG = b"0123456789abcdef0123456789abcdef"
ROUTES = ("host", "scheduled", "exec_lock", "direct")


@pytest.fixture(autouse=True)
def _no_twins_unless_asked(monkeypatch):
    """Other files of a test process may have left HARMONY_KERNEL_TWIN
    set; the twins run only where a test asks for them."""
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)


# --- protocol ----------------------------------------------------------------------


def _protocol(P_):
    keys = [bytes([i]) * 48 for i in range(3)]
    items = [(bytes(48), b"m1", bytes(96)), (bytes(48), b"m2", bytes(96))]
    frame = P_.pack_frame(P_.MSG_PING, 7, b"abc")
    traced = P_.pack_frame(P_.MSG_AGG_VERIFY, 8, b"body", b"tc-bytes")
    out = [frame, P_.unpack_frame(frame[4:]), traced,
           P_.split_trace(*P_.unpack_frame(traced[4:])[::2]),
           P_.build_set_committee(5, 2, keys),
           P_.parse_set_committee(P_.build_set_committee(5, 2, keys)),
           P_.build_agg_verify(1, 0, b"payload", b"\x07", bytes(96)),
           P_.parse_agg_verify(
               P_.build_agg_verify(1, 0, b"payload", b"\x07", bytes(96))),
           P_.build_verify_batch(items),
           P_.parse_verify_batch(P_.build_verify_batch(items))]
    bad_calls = [
        lambda: P_.pack_frame(P_.MSG_PING, 1, bytes(P_.MAX_FRAME)),
        lambda: P_.pack_frame(P_.MSG_PING, 1, b"", bytes(256)),
        lambda: P_.unpack_frame(b"\x01"),
        lambda: P_.split_trace(P_.MSG_PING | P_.TRACE_FLAG, b"\x05ab"),
        lambda: P_.parse_set_committee(bytes(16) + bytes(47)),
        lambda: P_.parse_agg_verify(bytes(13)),
        lambda: P_.parse_agg_verify(
            P_.build_agg_verify(1, 0, b"p", b"\x07", bytes(96))[:-1]),
        lambda: P_.parse_verify_batch(b"\xff\xff\x00\x00" + bytes(146)),
        lambda: P_.parse_verify_batch(P_.build_verify_batch(items) + b"x"),
        lambda: P_.build_verify_batch([(bytes(47), b"", bytes(96))]),
        lambda: P_.build_agg_verify(1, 0, b"", b"", bytes(95)),
    ]
    for call in bad_calls:
        with pytest.raises(ValueError) as e:
            call()
        out.append(str(e.value))
    return out


def test_protocol_equals_the_jax_package():
    got = _protocol(P)
    assert got == _protocol(J_P)
    assert got[1] == (P.MSG_PING, 7, b"abc")
    assert got[3] == (P.MSG_AGG_VERIFY, b"tc-bytes", b"body")
    assert got[5] == (5, 2, [bytes([i]) * 48 for i in range(3)])
    assert got[7] == (1, 0, b"payload", b"\x07", bytes(96))
    assert (P.VERSION, P.MAX_FRAME, P.RESP_FLAG) == \
        (J_P.VERSION, J_P.MAX_FRAME, J_P.RESP_FLAG)


# --- the live server, on each route ------------------------------------------------


@pytest.fixture(scope="module")
def committee():
    sks = [RB.keygen(bytes([i])) for i in range(4)]
    pks = [RB.pubkey(sk) for sk in sks]
    sigs = [RB.sign(sk, MSG) for sk in sks]
    return sks, pks, sigs


@pytest.fixture(scope="module")
def server():
    s = T_SV.SidecarServer().start()
    yield s
    s.stop()


@pytest.fixture(scope="module")
def jax_server():
    """The JAX package's server on its host route: the verdicts to equal."""
    J_DV.use_device(False)
    s = J_SV.SidecarServer().start()
    yield s
    s.stop()
    J_DV.use_device(None)


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """The port's server on one route; the JAX package's host route."""
    J_DV.use_device(False)
    T_SCHED.reset()
    name = request.param
    if name in ("scheduled", "exec_lock"):
        monkeypatch.setenv("HARMONY_KERNEL_TWIN", "1")
        T_DV.use_device(True, device="cpu")
        T_SCHED.configure(enabled=name == "scheduled")
    else:
        T_DV.use_device(False, device="cpu")
    direct = {"agg_verify": 0, "verify": 0}
    if name == "direct":
        monkeypatch.setattr(T_SV.SidecarServer, "_accelerated",
                            staticmethod(lambda: True))

        def agg(*a):
            direct["agg_verify"] += 1
            return torch.from_numpy(np.asarray(T_TWIN.agg_verify(*a)))

        def verify(*a):
            direct["verify"] += 1
            return torch.from_numpy(np.asarray(T_TWIN.verify(*a)))

        monkeypatch.setattr(T_OB, "agg_verify", agg)
        monkeypatch.setattr(T_OB, "verify", verify)
    fallbacks = T_DV.COUNTERS["ref_fallback"]
    before = dict(T_DV.COUNTERS.items())
    yield types.SimpleNamespace(name=name, direct=direct, before=before)
    T_SCHED.reset()
    T_DV.use_device(None)
    J_DV.use_device(None)
    assert T_DV.COUNTERS["ref_fallback"] == fallbacks


def _made(route, kind):
    return T_DV.COUNTERS[kind] - route.before[kind]


def test_ping_and_committee_upload(server, committee, route):
    _, pks, _ = committee
    c = T_CL.SidecarClient(server.address)
    assert c.ping() == P.VERSION
    c.set_committee(3, 0, [RB.pubkey_to_bytes(p) for p in pks])
    assert server._get_table(3, 0).serialized == \
        [RB.pubkey_to_bytes(p) for p in pks]
    c.close()


def _agg_cases(pks, sigs):
    agg = RB.sig_to_bytes(RB.aggregate_sigs([sigs[0], sigs[2], sigs[3]]))
    mask = Mask(pks)
    for i in (0, 2, 3):
        mask.set_bit(i, True)
    good = mask.mask_bytes()
    mask.set_bit(1, True)
    return [(MSG, good, agg), (MSG, mask.mask_bytes(), agg),
            (b"other payload", good, agg), (MSG, good, bytes(96)),
            (MSG, good, bytes([0xC0]) + bytes(95))]


def test_agg_verify_over_socket(server, jax_server, committee, route):
    _, pks, sigs = committee
    c = T_CL.SidecarClient(server.address)
    c.set_committee(4, 1, [RB.pubkey_to_bytes(p) for p in pks])
    got = [c.agg_verify(4, 1, *case) for case in _agg_cases(pks, sigs)]
    j = J_CL.SidecarClient(jax_server.address)
    j.set_committee(4, 1, [RB.pubkey_to_bytes(p) for p in pks])
    assert got == [j.agg_verify(4, 1, *case)
                   for case in _agg_cases(pks, sigs)]
    j.close()
    assert got == [True, False, False, False, False]
    with pytest.raises(KeyError):
        c.agg_verify(99, 9, MSG, b"\x0f", bytes(96))
    # a bitmap of the wrong length is a bad request
    with pytest.raises(RuntimeError):
        c.agg_verify(4, 1, MSG, b"\x0f\x00", bytes(96))
    c.close()
    # the well-formed signatures reach the route's device work: three
    # quorum checks (the all-zero and infinity signatures stop before)
    if route.name in ("scheduled", "exec_lock"):
        assert _made(route, "agg_verify") == 3
    elif route.name == "direct":
        assert route.direct["agg_verify"] == 3
    else:
        assert _made(route, "agg_verify") == 0


def test_verify_batch_over_socket(server, jax_server, committee, route):
    _, pks, sigs = committee
    c = T_CL.SidecarClient(server.address)
    items = [(RB.pubkey_to_bytes(pks[i]), MSG, RB.sig_to_bytes(sigs[i]))
             for i in range(3)]
    items.append((RB.pubkey_to_bytes(pks[3]), MSG, RB.sig_to_bytes(sigs[0])))
    items.append((bytes(48), MSG, RB.sig_to_bytes(sigs[0])))
    got = c.verify_batch(items)
    j = J_CL.SidecarClient(jax_server.address)
    assert got == j.verify_batch(items) == [True, True, True, False, False]
    j.close()
    assert c.verify_batch([]) == []
    c.close()
    if route.name in ("scheduled", "exec_lock"):
        assert _made(route, "verify") == 4
    elif route.name == "direct":
        # one chunk of 4 checks, padded to the bucket of 8
        assert route.direct["verify"] == 1


def test_jax_client_talks_to_the_port_server(server, committee, route):
    """Wire compatibility: the JAX package's SidecarClient against the
    port's server, on each of its routes."""
    _, pks, sigs = committee
    c = J_CL.SidecarClient(server.address)
    assert c.ping() == J_P.VERSION
    c.set_committee(5, 0, [RB.pubkey_to_bytes(p) for p in pks])
    assert [c.agg_verify(5, 0, *case) for case in _agg_cases(pks, sigs)] == \
        [True, False, False, False, False]
    futs = [c.agg_verify_begin(5, 0, *case)
            for case in _agg_cases(pks, sigs)[:2]]
    assert [f.result() for f in futs] == [True, False]
    items = [(RB.pubkey_to_bytes(pks[i]), MSG, RB.sig_to_bytes(sigs[i % 2]))
             for i in range(4)]
    assert c.verify_batch(items) == [True, True, False, False]
    c.close()


def test_port_client_talks_to_the_jax_server(committee):
    _, pks, sigs = committee
    J_DV.use_device(False)
    s = J_SV.SidecarServer().start()
    try:
        c = T_CL.SidecarClient(s.address)
        assert c.ping() == P.VERSION
        c.set_committee(6, 0, [RB.pubkey_to_bytes(p) for p in pks])
        assert [c.agg_verify(6, 0, *case)
                for case in _agg_cases(pks, sigs)[:3]] == [True, False, False]
        c.close()
    finally:
        s.stop()
        J_DV.use_device(None)


# --- the engine through the sidecar -------------------------------------------------


def _signed_headers(keys, n, signers=(0, 1, 2)):
    out = []
    for i in range(n):
        h = T_HDR.Header(shard_id=0, block_num=10 + i, epoch=2,
                         view_id=10 + i)
        payload = T_SIG.construct_commit_payload(h.hash(), h.block_num,
                                                 h.view_id, True)
        agg = T_B.aggregate_sigs([keys[j].sign_hash(payload)
                                  for j in signers])
        mask = Mask([k.pub.point for k in keys])
        for j in signers:
            mask.set_bit(j, True)
        out.append((h, agg.bytes, mask.mask_bytes()))
    return out


@pytest.mark.parametrize("armed", (True, False), ids=("sched", "disarmed"))
def test_engine_routes_checks_through_sidecar(server, route, armed):
    """Engine(backend=SidecarClient) pushes the committee once and checks
    header seals through the sidecar only: one by one, and as a replay
    batch pipelined through the scheduler's backend worker (or one call
    at a time with the scheduler disarmed)."""
    keys = [T_B.PrivateKey.generate(bytes([90 + i])) for i in range(4)]
    serialized = [k.pub.bytes for k in keys]
    client = T_CL.SidecarClient(server.address)
    eng = T_ENG.Engine(lambda s, e: T_ENG.EpochContext(serialized),
                       device=False, backend=client)
    (h, sig, bitmap), *rest = _signed_headers(keys, 4)
    assert eng.verify_header_signature(h, sig, bitmap)
    assert eng._backend_committees == {(0, 2)}
    assert eng.verify_header_signature(h, sig, bitmap)
    mask = bytearray(bitmap)
    mask[0] |= 0x08  # claims all four signed
    assert not eng.verify_header_signature(h, sig, bytes(mask))
    T_SCHED.configure(enabled=armed if route.name != "exec_lock" else False)
    items = rest + [(rest[0][0], sig, rest[0][2]), rest[1]]
    assert eng.verify_headers_batch(items) == [True, True, True, False, True]
    assert eng.verify_headers_batch(items) == [True, True, True, False, True]
    assert eng._backend_committees == {(0, 2)}
    client.close()


# --- a check bound for the card --------------------------------------------------------


@pytest.fixture
def bound_for_the_card(monkeypatch):
    """The server's node device set to CUDA on a machine without it.
    Committee tables keep their keys on the meta device but report CUDA,
    so that a check goes all the way to its dispatch, which fails here.
    The exceptions that end the server's connection threads are kept."""
    init = T_DV.CommitteeTable._init

    def on_meta(self, arr, n, device, points):
        init(self, arr, n, "meta", points)
        self.device = torch.device("cuda")

    monkeypatch.setattr(T_DV.CommitteeTable, "_init", on_meta)
    monkeypatch.setattr(T_DV, "BREAKER",
                        T_RS.CircuitBreaker("device", 100, 30.0))
    ended = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: ended.append(args.exc_type))
    T_DV.use_device(True, device="cuda")
    T_SCHED.reset()
    fallbacks = T_DV.COUNTERS["ref_fallback"]
    yield ended
    # the server's connection threads end with the raise: let them finish
    # while their exceptions are still kept
    for t in threading.enumerate():
        if t.name.endswith("(_serve_conn)"):
            t.join(10)
    T_SCHED.reset()
    T_DV.use_device(None)
    assert T_DV.COUNTERS["ref_fallback"] == fallbacks


@pytest.mark.parametrize("armed", (True, False), ids=("sched", "exec_lock"))
def test_a_check_bound_for_the_card_is_never_a_verdict(
        committee, bound_for_the_card, armed):
    """A quorum check and a batch of single checks bound for CUDA raise
    DeviceError in the server, which closes the connection: the client
    raises SidecarUnavailable, and the engine's per-item retry of a
    failed pipelined check ends in that raise, not in False."""
    _, pks, sigs = committee
    T_SCHED.configure(enabled=armed)
    s = T_SV.SidecarServer().start()
    try:
        c = T_CL.SidecarClient(s.address, call_timeout=5.0)
        c.set_committee(7, 0, [RB.pubkey_to_bytes(p) for p in pks])
        with pytest.raises(T_CL.SidecarUnavailable):
            c.agg_verify(7, 0, *_agg_cases(pks, sigs)[0])
        with pytest.raises(T_CL.SidecarUnavailable):
            c.verify_batch([(RB.pubkey_to_bytes(pks[0]), MSG,
                             RB.sig_to_bytes(sigs[0]))])
        keys = [T_B.PrivateKey.generate(bytes([90 + i])) for i in range(4)]
        eng = T_ENG.Engine(lambda *_: T_ENG.EpochContext(
            [k.pub.bytes for k in keys]), device=False, backend=c)
        with pytest.raises(T_CL.SidecarUnavailable):
            eng.verify_headers_batch(_signed_headers(keys, 2))
        assert not eng._verified
        c.close()
    finally:
        s.stop()
    assert bound_for_the_card and set(bound_for_the_card) == \
        {T_DV.DeviceError}
