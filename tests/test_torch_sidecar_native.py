"""The native C++ sidecar client against the port's sidecar server: the
port's copy of ``native/sidecar_client.cpp``, built with g++ (the one
build of this file), driven through ctypes as
``tests/test_sidecar.py``'s native-client test drives the JAX package's
build: ping, a committee upload, a 4-of-4 quorum check and a flipped
bitmap bit.  The same calls against the JAX package's server give the
same answers."""

import ctypes
import os
import subprocess
from pathlib import Path

import pytest

from harmony_tpu.sidecar import server as J_SV
from harmony_tpu_torch import device as T_DV
from harmony_tpu_torch.consensus.mask import Mask
from harmony_tpu_torch.ref import bls as RB
from harmony_tpu_torch.sidecar import protocol as P
from harmony_tpu_torch.sidecar import server as T_SV

REPO = Path(__file__).resolve().parents[1]
SOURCE = REPO / "harmony_tpu_torch" / "native" / "sidecar_client.cpp"
MSG = b"0123456789abcdef0123456789abcdef"


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """The port's copy of the client, compiled with native/Makefile's
    flags into a temporary directory."""
    assert SOURCE.read_bytes() == (REPO / "native" /
                                   "sidecar_client.cpp").read_bytes()
    so = tmp_path_factory.mktemp("sidecar") / "libharmony_sidecar.so"
    subprocess.run(
        [os.environ.get("CXX", "g++"), "-O2", "-Wall", "-Wextra", "-fPIC",
         "-std=c++17", "-shared", "-o", str(so), str(SOURCE)],
        check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.harmony_sidecar_connect_tcp.restype = ctypes.c_void_p
    lib.harmony_sidecar_connect_tcp.argtypes = [ctypes.c_char_p,
                                                ctypes.c_int]
    lib.harmony_sidecar_close.argtypes = [ctypes.c_void_p]
    lib.harmony_sidecar_ping.argtypes = [ctypes.c_void_p]
    lib.harmony_sidecar_set_committee.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.harmony_sidecar_agg_verify.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint16,
        ctypes.c_char_p, ctypes.c_uint16,
        ctypes.c_char_p,
    ]
    return lib


@pytest.fixture(scope="module")
def committee():
    sks = [RB.keygen(bytes([i])) for i in range(4)]
    pks = [RB.pubkey(sk) for sk in sks]
    sigs = [RB.sign(sk, MSG) for sk in sks]
    return sks, pks, sigs


@pytest.fixture(autouse=True)
def _host_path(monkeypatch):
    monkeypatch.delenv("HARMONY_KERNEL_TWIN", raising=False)
    T_DV.use_device(False)
    yield
    T_DV.use_device(None)


def _session(lib, address, committee):
    """Every answer of one native-client session."""
    _, pks, sigs = committee
    host, port = address
    h = lib.harmony_sidecar_connect_tcp(host.encode(), port)
    assert h, "native connect failed"
    try:
        out = [lib.harmony_sidecar_ping(h)]
        keys = b"".join(RB.pubkey_to_bytes(p) for p in pks)
        out.append(lib.harmony_sidecar_set_committee(h, 7, 0, keys, 4))
        agg = RB.aggregate_sigs(sigs)
        mask = Mask(pks)
        for i in range(4):
            mask.set_bit(i, True)
        bm = mask.mask_bytes()
        sig = RB.sig_to_bytes(agg)
        out.append(lib.harmony_sidecar_agg_verify(
            h, 7, 0, MSG, len(MSG), bm, len(bm), sig))
        bad = bytes([bm[0] ^ 0x02])
        out.append(lib.harmony_sidecar_agg_verify(
            h, 7, 0, MSG, len(MSG), bad, len(bad), sig))
        three = RB.sig_to_bytes(RB.aggregate_sigs(sigs[:3]))
        out.append(lib.harmony_sidecar_agg_verify(
            h, 7, 0, MSG, len(MSG), bytes([0x07]), 1, three))
        return out
    finally:
        lib.harmony_sidecar_close(h)


def test_the_native_client_against_the_ports_server(native_lib, committee):
    server = T_SV.SidecarServer().start()
    try:
        got = _session(native_lib, server.address, committee)
    finally:
        server.stop()
    assert got == [P.VERSION, 0, 1, 0, 1]


def test_the_same_answers_from_the_jax_packages_server(native_lib,
                                                       committee):
    answers = []
    for SV in (T_SV, J_SV):
        server = SV.SidecarServer().start()
        try:
            answers.append(_session(native_lib, server.address, committee))
        finally:
            server.stop()
    assert answers[0] == answers[1]
