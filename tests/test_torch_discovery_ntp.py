"""The port's peer discovery (``p2p/discovery.py``) and NTP check
(``ntp.py``) against the JAX package's.

Discovery: the Kademlia routing table files and orders the same
addresses the same way; a mixed localnet (the JAX package's bootnode,
two port hosts and one JAX host, each with its package's ``Discovery``)
finds every peer through the bootnode and PEX and carries gossip; both
stop dialing at their target after the same dials; the port's bootnode
binary serves and exits 0 on SIGTERM.  NTP: the same offset from a fake
NTP server on loopback, the same verdicts for drift, a short reply and
an unreachable server."""

import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from harmony_tpu import ntp as J_NTP
from harmony_tpu.p2p import discovery as J_D
from harmony_tpu.p2p.host import TCPHost as J_Host
from harmony_tpu_torch import ntp as T_NTP
from harmony_tpu_torch.p2p import discovery as T_D
from harmony_tpu_torch.p2p.host import TCPHost as T_Host

REPO = Path(__file__).resolve().parents[1]


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return False


def test_the_routing_table_as_the_jax_packages():
    addrs = [f"127.0.0.1:{9000 + i}" for i in range(300)]
    tables = {}
    for name, D in (("jax", J_D), ("port", T_D)):
        table = D.RoutingTable("127.0.0.1:8999")
        added = [table.add(a) for a in addrs]
        for a in addrs[::7]:
            table.remove(a)
        tables[name] = (
            added, len(table),
            [D.RoutingTable._id(a) for a in addrs[:20]],
            [table._bucket_of(a) for a in addrs[:50]],
            [table.closest(bytes([i]) * 32) for i in (0, 7, 255)],
            table.closest(b"\x5a" * 32, k=3))
    assert tables["port"] == tables["jax"]


def test_a_mixed_localnet_bootstraps_through_one_bootnode():
    """The JAX package's bootnode; hosts of both packages, zero static
    peers: everyone finds everyone, and gossip flows across the links."""
    boot = J_D.run_bootnode(port=0)
    baddr = f"127.0.0.1:{boot.port}"
    hosts = [T_Host(name="p0"), T_Host(name="p1"), J_Host(name="j0")]
    discos = [D.Discovery(h, bootnodes=[baddr], target_peers=3,
                          interval=0.2)
              for D, h in zip((T_D, T_D, J_D), hosts)]
    try:
        for d in discos:
            d.start()
        assert _wait(lambda: all(h.peer_count() >= 3 for h in hosts),
                     timeout=20), [h.peer_count() for h in hosts]
        for h in hosts:
            assert {f"127.0.0.1:{o.port}" for o in hosts if o is not h} \
                <= set(h.known_addrs)
        got = []
        for h in hosts[1:]:
            h.subscribe("t", lambda t, p, f: got.append(p))
        hosts[0].publish("t", b"hello-pex")
        assert _wait(lambda: got.count(b"hello-pex") >= 2)
    finally:
        for d in discos:
            d.stop()
        for h in hosts:
            h.close()
        boot.close()


def test_both_stop_dialing_at_the_target():
    dials = {}
    for name, D, Host in (("jax", J_D, J_Host), ("port", T_D, T_Host)):
        boot = D.run_bootnode(port=0)
        h = Host(name=f"solo-{name}")
        d = D.Discovery(h, bootnodes=[f"127.0.0.1:{boot.port}"],
                        target_peers=1, interval=0.2)
        try:
            d.step()
            assert _wait(lambda: h.peer_count() >= 1)
            first = d.dials
            d.step()
            d.step()
            dials[name] = (first, d.dials)
        finally:
            d.stop()
            h.close()
            boot.close()
    assert dials["port"] == dials["jax"] == (1, 1)


def test_the_bootnode_binary_serves_and_exits_0_on_sigterm():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    free = probe.getsockname()[1]
    probe.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "harmony_tpu_torch.p2p.discovery",
         "--port", str(free)], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    h = T_Host(name="dialer")
    try:
        assert _wait(lambda: any("bootnode listening" in line
                                 for line in list(lines)), timeout=60), (
            "".join(lines), proc.poll())
        h.connect(free)
        assert _wait(lambda: h.peer_count() == 1)
    finally:
        h.close()
        proc.send_signal(signal.SIGTERM)
        proc.wait(20)
        reader.join(10)
    out = "".join(lines)
    assert proc.returncode == 0, out
    assert "Traceback" not in out


class _FakeNTP:
    """An SNTP server on loopback whose transmit time is ``skew_s`` ahead
    of this clock (or a reply of ``short`` bytes)."""

    def __init__(self, skew_s=0.0, short=None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.port = self.sock.getsockname()[1]
        self.skew_s, self.short = skew_s, short
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                data, peer = self.sock.recvfrom(512)
            except OSError:
                return
            now = time.time() + self.skew_s + J_NTP.NTP_EPOCH_DELTA
            secs = int(now)
            frac = int((now - secs) * 2**32)
            reply = b"\x1c" + 39 * b"\x00" + struct.pack("!II", secs, frac)
            self.sock.sendto(reply[:self.short], peer)

    def close(self):
        self.sock.close()


@pytest.mark.parametrize("skew_s", (5.0, -40.0, 0.0))
def test_the_same_offset_from_a_fake_ntp_server(skew_s, monkeypatch):
    server = _FakeNTP(skew_s)
    try:
        offsets = {name: NTP.query_offset("127.0.0.1", server.port,
                                          timeout=5)
                   for name, NTP in (("jax", J_NTP), ("port", T_NTP))}
    finally:
        server.close()
    assert offsets["port"] == pytest.approx(offsets["jax"], abs=0.05)
    assert offsets["port"] == pytest.approx(skew_s, abs=0.05)
    verdicts = []
    for NTP in (J_NTP, T_NTP):
        monkeypatch.setattr(NTP, "query_offset",
                            lambda server, o=offsets["port"]: o)
        verdicts.append(NTP.check_clock("127.0.0.1")[0])
    assert verdicts[0] == verdicts[1] == (abs(skew_s) <= 30.0)


def test_short_replies_and_silence_as_the_jax_package():
    server = _FakeNTP(short=40)
    try:
        got = [NTP.query_offset("127.0.0.1", server.port, timeout=5)
               for NTP in (J_NTP, T_NTP)]
    finally:
        server.close()
    assert got == [None, None]
    silent = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    silent.bind(("127.0.0.1", 0))
    try:
        got = [NTP.query_offset("127.0.0.1", silent.getsockname()[1],
                                timeout=0.3) for NTP in (J_NTP, T_NTP)]
    finally:
        silent.close()
    assert got == [None, None]
    assert T_NTP.MAX_DRIFT_SECONDS == J_NTP.MAX_DRIFT_SECONDS
    assert T_NTP.DEFAULT_SERVER == J_NTP.DEFAULT_SERVER
