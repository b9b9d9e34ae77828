"""Sidecar kernel server: accepts verification batches over a local
socket, executes them on the accelerator, keeps committees device-resident.

Deployment analog of the reference's in-process cgo boundary: the node
(Go, or the Python harness in tests) ships [bitmap || sig || payload]
requests; the server holds the epoch-keyed committee pubkey tables on
device so steady-state traffic is O(bitmap + 96 B) per check
(SURVEY.md §7.3 latency budget).

Single-threaded device occupancy (the scheduler's flush thread, or the
exec lock) with a threaded accept loop; supports TCP and Unix sockets.

The port's copy of the JAX package's ``sidecar/server.py``.  A request
takes one of three routes:

- the device path on (``device.device_enabled()``): through the
  verification scheduler, or with the scheduler disarmed under the exec
  lock through ``device.py``'s breaker-guarded entry points, on the
  node's device;
- the device path off and CUDA present (``_accelerated()``): the direct
  branch, ``ops/bls.py`` on tensors on the card (the node's device where
  one is set).  It bypasses ``device._guarded``: a kernel that fails there
  raises straight through, with no breaker and no host answer;
- neither: the host path (``ref/``), the reference's host mode.

A check bound for CUDA that fails raises (``device.DeviceError`` on the
first route); the error is never a verdict.  It leaves ``_dispatch``,
whose catches are the reference's (malformed requests), and closes the
connection: the client raises ``SidecarUnavailable``.
"""

from __future__ import annotations

import socket
import struct
import threading

import torch

from .. import trace
from ..ref import bls as RB
from ..ref.hash_to_curve import hash_to_g2
from . import protocol as P


class CommitteeTable:
    """Device-resident committee: pubkey tensor + host metadata.  The
    tensors build lazily — the scheduler path uses the padded
    ``device.CommitteeTable`` (shared pinned buckets), the direct branch
    its flat affine tensor, and the host path neither."""

    def __init__(self, pubkeys: list):
        self.serialized = list(pubkeys)
        self.points = [RB.pubkey_from_bytes(pk) for pk in pubkeys]
        self._device_aff = None
        self._dv_table = None

    @property
    def device_aff(self):
        """(N, 2, 32) affine keys on the direct branch's device: the
        node's device where one is set, else CUDA."""
        if self._device_aff is None:
            from .. import device as DV
            from ..ops import interop as I

            self._device_aff = I.g1_batch_affine(self.points).to(
                DV.resolve_device())
        return self._device_aff

    def dv_table(self):
        """The padded device.CommitteeTable the scheduler dispatches
        against (pad keys masked off by zero bitmap bits)."""
        if self._dv_table is None:
            from .. import device as DV

            self._dv_table = DV.CommitteeTable(self.points)
        return self._dv_table

    def __len__(self):
        return len(self.serialized)


class SidecarServer:
    def __init__(self, host="127.0.0.1", port=0, unix_path=None):
        self._committees: dict = {}
        self._lock = threading.Lock()
        self._exec_lock = threading.Lock()
        if unix_path:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.bind(unix_path)
            self.address = unix_path
        else:
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind((host, port))
            self.address = self._sock.getsockname()
        self._sock.listen(16)
        self._stop = threading.Event()
        self._thread = None
        self._conns: set = set()  # live client conns, closed on stop

    # --- lifecycle ---
    def start(self):
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
        )  # graftlint: thread-role=serving
        self._thread.start()
        return self

    def stop(self):
        """Shut down the listener AND every live connection: a stopped
        sidecar must look DEAD to its clients (their reader threads get
        EOF and fail closed), not linger half-alive on old sockets.
        shutdown() before close() matters: a bare close() of a socket
        another thread is blocked recv'ing/accept'ing on is DEFERRED by
        the kernel until that syscall exits — no FIN is ever sent and
        the 'stopped' server keeps serving established connections."""
        self._stop.set()
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for sock in [self._sock] + conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(
                # graftlint: thread-role=transient — per-connection
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn):
        try:
            while True:
                frame = P.read_frame(conn)
                if frame is None:
                    return
                msg_type, req_id, body = frame
                # resume the caller's trace so the device work this
                # request triggers lands under the round that sent it
                msg_type, tc, body = P.split_trace(msg_type, body)
                with trace.resume(tc, "sidecar.serve",
                                  component="sidecar",
                                  msg_type=msg_type):
                    status, resp = self._dispatch(msg_type, body)
                conn.sendall(
                    P.pack_frame(
                        msg_type | P.RESP_FLAG, req_id, bytes([status]) + resp
                    )
                )
        except (ValueError, OSError):
            pass
        finally:
            with self._lock:
                self._conns.discard(conn)
            conn.close()

    # --- request handling ---
    def _dispatch(self, msg_type: int, body: bytes):
        try:
            if msg_type == P.MSG_PING:
                return P.STATUS_OK, P.VERSION.to_bytes(2, "little")
            if msg_type == P.MSG_SET_COMMITTEE:
                return self._on_set_committee(body)
            if msg_type == P.MSG_AGG_VERIFY:
                return self._on_agg_verify(body)
            if msg_type == P.MSG_VERIFY_BATCH:
                return self._on_verify_batch(body)
            return P.STATUS_BAD_REQUEST, b""
        except (ValueError, struct.error):
            # struct.error is NOT a ValueError subclass; short bodies in
            # the parsers raise it and must map to BAD_REQUEST, not kill
            # the connection
            return P.STATUS_BAD_REQUEST, b""

    def _on_set_committee(self, body):
        epoch, shard, keys = P.parse_set_committee(body)
        table = CommitteeTable(keys)
        with self._lock:
            self._committees[(epoch, shard)] = table
        return P.STATUS_OK, b""

    def _get_table(self, epoch, shard):
        with self._lock:
            return self._committees.get((epoch, shard))

    def _on_agg_verify(self, body):
        epoch, shard, payload, bitmap, sig = P.parse_agg_verify(body)
        table = self._get_table(epoch, shard)
        if table is None:
            return P.STATUS_UNKNOWN_COMMITTEE, b""
        n = len(table)
        if len(bitmap) != (n + 7) >> 3:
            return P.STATUS_BAD_REQUEST, b""
        from ..consensus.mask import bits_from_bytes

        bits = bits_from_bytes(bitmap, n)
        from .. import device as DV

        if DV.device_enabled():
            # the sidecar deployment shares the SAME process-wide
            # verification queue the in-process paths use: a live
            # quorum check enters the consensus lane and coalesces
            # with whatever else is pending — the scheduler thread
            # (not a per-connection exec lock) serializes the device
            try:
                sig_pt = RB.sig_from_bytes(sig)
            except ValueError:
                return P.STATUS_OK, bytes([0])
            if sig_pt is None:
                return P.STATUS_OK, bytes([0])
            from .. import sched

            if sched.enabled():
                ok = sched.agg_verify(
                    table.dv_table(), bits, payload, sig_pt,
                    lane=sched.Lane.CONSENSUS,
                )
            else:
                # scheduler disarmed: per-connection threads fall back
                # to the exec lock for device occupancy, as before the scheduler
                with self._exec_lock:
                    ok = DV.agg_verify_on_device(  # graftlint: disable=GL05,GL06 reviewed: exec lock serializes device work by design
                        table.dv_table(), bits, payload, sig_pt
                    )
            return P.STATUS_OK, bytes([1 if ok else 0])
        with self._exec_lock:
            # the exec lock exists to serialize device occupancy; the
            # native-lib init lock it nests is held once, briefly
            ok = self._agg_verify_device(table, bits, payload, sig)  # graftlint: disable=GL05,GL06 reviewed: exec lock serializes device work by design
        return P.STATUS_OK, bytes([1 if ok else 0])

    @staticmethod
    def _accelerated() -> bool:
        """The direct branch's device ops only where CUDA is available;
        elsewhere the host path answers."""
        return torch.cuda.is_available()

    def _agg_verify_device(self, table, bits, payload, sig_bytes):
        try:
            sig = RB.sig_from_bytes(sig_bytes)
        except ValueError:
            return False
        if sig is None:
            return False
        h = hash_to_g2(payload)
        if not self._accelerated():
            agg = None
            from ..ref.curve import g1 as _g1

            for pt, bit in zip(table.points, bits):
                if bit:
                    agg = _g1.add(agg, pt)
            if agg is None:
                return False
            return RB.verify_hashed(agg, h, sig)
        from .. import device as DV
        from ..ops import bls as OB
        from ..ops import interop as I

        dev = DV.resolve_device()
        h_aff = I.g2_affine_to_arr(h).to(dev)
        s_aff = I.g2_affine_to_arr(sig).to(dev)
        return bool(
            OB.agg_verify(
                table.device_aff,
                torch.tensor(bits, dtype=torch.int32, device=dev),
                h_aff, s_aff,
            )
        )

    # pinned device batch widths (shared compiled programs; chunked
    # above the widest — same bucketing discipline as chain/engine.py)
    _VERIFY_BUCKETS = (8, 64)

    def _on_verify_batch(self, body):
        """Batched independent verifies — ONE device program per chunk
        (not host bigint pairings one at a time: the batched ops path is
        the op this service exists to serve).  On
        the device path the batch enters the shared scheduler's sync
        lane, coalescing with in-process traffic."""
        items = P.parse_verify_batch(body)
        results = bytearray(len(items))
        survivors = []  # (index, pk_point, h_point, sig_point)
        for idx, (pk_bytes, payload, sig_bytes) in enumerate(items):
            try:
                pk = RB.pubkey_from_bytes(pk_bytes)
                sig = RB.sig_from_bytes(sig_bytes)
            except ValueError:
                continue
            if sig is None:
                continue
            survivors.append((idx, pk, hash_to_g2(payload), sig))
        from .. import device as DV

        if DV.device_enabled():
            from .. import sched

            if sched.enabled():
                s = sched.scheduler()
                futures = [
                    s.submit_single(pk, h_pt, sig, lane=sched.Lane.SYNC)
                    for _, pk, h_pt, sig in survivors
                ]
                flat = []
                for f in futures:
                    try:
                        flat.append(bool(f.result()))
                    except OSError:  # deadline/shed surfaced: fail the
                        flat.append(False)  # item, not the connection
            else:
                # scheduler disarmed: serialize device occupancy with
                # the exec lock, as before the scheduler
                with self._exec_lock:
                    flat = DV.verify_many_on_device(  # graftlint: disable=GL05,GL06 reviewed: exec lock serializes device work by design
                        [s_[1] for s_ in survivors],
                        [s_[2] for s_ in survivors],
                        [s_[3] for s_ in survivors],
                    )
            for (idx, _, _, _), good in zip(survivors, flat):
                results[idx] = 1 if good else 0
            return (
                P.STATUS_OK,
                len(items).to_bytes(4, "little") + bytes(results),
            )
        if not self._accelerated():
            for idx, pk, h_pt, sig in survivors:
                results[idx] = (
                    1 if RB.verify_hashed(pk, h_pt, sig) else 0
                )
            return (
                P.STATUS_OK,
                len(items).to_bytes(4, "little") + bytes(results),
            )
        from ..ops import bls as OB
        from ..ops import interop as I

        dev = DV.resolve_device()
        widest = self._VERIFY_BUCKETS[-1]
        # _exec_lock serializes device occupancy BY DESIGN: one sidecar
        # program on the accelerator at a time, others queue here
        with self._exec_lock:  # graftlint: disable=GL06 the exec lock exists to serialize device work
            pending = []  # (chunk, ok device array) — sync after dispatch
            for start in range(0, len(survivors), widest):
                chunk = survivors[start:start + widest]
                n = len(chunk)
                padded = next(
                    (b for b in self._VERIFY_BUCKETS if n <= b), widest
                )
                sel = list(range(n)) + [0] * (padded - n)
                pk = I.g1_batch_affine([chunk[i][1] for i in sel])
                hh = I.g2_batch_affine([chunk[i][2] for i in sel])
                sg = I.g2_batch_affine([chunk[i][3] for i in sel])
                ok = OB.verify(  # graftlint: disable=GL06 dispatch under the exec lock is this lock's purpose
                    pk.to(dev), hh.to(dev), sg.to(dev)
                )
                pending.append((chunk, ok))
            # every chunk's program is dispatched; drain results without
            # a device round-trip between submissions (GL07)
            for chunk, ok in pending:
                flat = ok.cpu().numpy()[: len(chunk)]  # graftlint: disable=GL07 reviewed: every chunk dispatched above, this is the drain
                for (idx, _, _, _), good in zip(chunk, flat):
                    results[idx] = 1 if bool(good) else 0
        return P.STATUS_OK, len(items).to_bytes(4, "little") + bytes(results)
