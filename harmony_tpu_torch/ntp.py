"""NTP clock-drift sanity check at node startup.

The role of the reference's common/ntp (reference: common/ntp — a
startup query against an NTP pool; excessive local clock drift makes a
validator miss view windows, so the node warns/refuses).  Stdlib UDP
SNTP client; network failure is NOT an error (airgapped/laboratory
deployments run with a warning, as the reference does).

The port's copy of the JAX package's ``ntp.py``.
"""

from __future__ import annotations

import socket
import struct
import time

NTP_EPOCH_DELTA = 2208988800  # 1900 -> 1970
DEFAULT_SERVER = "pool.ntp.org"
MAX_DRIFT_SECONDS = 30.0  # tolerated |offset| before refusing to start


def query_offset(server: str = DEFAULT_SERVER, port: int = 123,
                 timeout: float = 3.0) -> float | None:
    """Clock offset (ntp - local) in seconds, or None when unreachable."""
    packet = b"\x1b" + 47 * b"\x00"  # SNTP v3 client request
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.settimeout(timeout)
            t0 = time.time()
            s.sendto(packet, (server, port))
            data, _ = s.recvfrom(512)
            t3 = time.time()
    except OSError:
        return None
    if len(data) < 48:
        return None
    # transmit timestamp: seconds + fraction at offset 40
    secs, frac = struct.unpack("!II", data[40:48])
    server_time = secs - NTP_EPOCH_DELTA + frac / 2**32
    # midpoint of the round trip approximates when the server stamped
    return server_time - (t0 + t3) / 2


def check_clock(server: str = DEFAULT_SERVER,
                max_drift: float = MAX_DRIFT_SECONDS):
    """(ok, offset): ok is False only for MEASURED excessive drift;
    an unreachable server yields (True, None) with the caller expected
    to log the skipped check."""
    offset = query_offset(server)
    if offset is None:
        return True, None
    return abs(offset) <= max_drift, offset
