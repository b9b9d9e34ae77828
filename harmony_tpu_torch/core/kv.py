"""Key/value storage: the persistence substrate under rawdb.

The role of the reference's LevelDB layer (reference: core/rawdb over
goleveldb; one DB per shard via internal/shardchain/shardchains.go).
Two implementations behind one tiny interface:

- ``MemKV`` — dict-backed, for tests and ephemeral chains (the
  reference's rawdb.NewMemoryDatabase test pattern);
- ``FileKV`` — a log-structured store: append-only record log with an
  in-memory index, crash-safe reopen by log replay, and explicit
  ``compact()`` that rewrites live records.  Single-writer by design
  (the node owns its shard DB exclusively, as in the reference).

Record format (little-endian): [klen u32][vlen u32 | 0xFFFFFFFF =
tombstone][key][value].

Atomic commit batches (the role of LevelDB's WriteBatch under the
reference's ``rawdb.NewBatch``): a :class:`WriteBatch` stages puts and
deletes, and ``write_batch`` appends them between two marker records

    BEGIN  = [0xFFFFFFFE klen][count vlen]   (no key/value bytes)
    COMMIT = [0xFFFFFFFD klen][count vlen]

Replay applies a batch's records to the index ONLY when its COMMIT
marker (with the matching count) is present — a crash anywhere inside
the batch makes the whole batch invisible on reopen, so rawdb's
multi-record block commits are all-or-nothing.  Real keys can never
collide with the sentinels: a klen ≥ 0xFFFFFFF0 is beyond any
plausible record and is treated as corruption by replay.

Durability knob: ``fsync`` policy ``"none"`` (OS-buffered — default,
test speed), ``"batch"`` (fsync on every batch commit — the deployment
setting: a committed block survives power loss), ``"always"`` (fsync
every write).  IO is UNBUFFERED so crash modeling is honest: every
``write()`` reaches the OS immediately and survives a process kill
(the fsync policy is what covers power loss).

Crash-point injection: the batch commit path fires the
``kv.commit`` faultinject point (key = the store's path) before every
record and marker write —
``python -m harmony_tpu_torch.tools.crash_sweep`` enumerates these
points and kills the write at each one.  A failed batch write (fault
or real IO error) self-heals by truncating back to the batch start,
so a LIVE store never leaves torn bytes ahead of its append position.

The port's copy of the JAX package's ``core/kv.py``.
"""

from __future__ import annotations

import os
import struct
import threading

from .. import faultinject as FI

_TOMB = 0xFFFFFFFF
_BATCH_BEGIN = 0xFFFFFFFE  # klen sentinel: batch start marker
_BATCH_COMMIT = 0xFFFFFFFD  # klen sentinel: batch commit marker
_KLEN_MAX = 0xFFFFFFF0  # any real klen above this is corruption
_HDR = struct.Struct("<II")

FSYNC_POLICIES = ("none", "batch", "always")


class WriteBatch:
    """Staged puts/deletes applied atomically by ``write_batch``.

    Mirrors the db interface's write half (``put``/``delete``) so every
    rawdb accessor writes into a batch unchanged."""

    def __init__(self):
        self._ops: list[tuple[bytes, bytes | None]] = []

    def put(self, key: bytes, value: bytes):
        self._ops.append((bytes(key), bytes(value)))

    def delete(self, key: bytes):
        self._ops.append((bytes(key), None))

    @property
    def ops(self) -> list:
        return list(self._ops)

    def __len__(self):
        return len(self._ops)


def commit_batch(db, batch: WriteBatch) -> None:
    """Apply ``batch`` to ``db`` atomically where the backend supports
    it (``write_batch``), else sequentially (MemKV-shaped stores are
    process-lifetime anyway)."""
    wb = getattr(db, "write_batch", None)
    if wb is not None:
        wb(batch)
        return
    for key, value in batch.ops:
        if value is None:
            db.delete(key)
        else:
            db.put(key, value)


class MemKV:
    """Dict-backed store."""

    def __init__(self):
        self._d: dict[bytes, bytes] = {}

    def get(self, key: bytes):
        return self._d.get(key)

    def put(self, key: bytes, value: bytes):
        self._d[bytes(key)] = bytes(value)

    def delete(self, key: bytes):
        self._d.pop(key, None)

    def has(self, key: bytes) -> bool:
        return key in self._d

    def items(self):
        return list(self._d.items())

    def write_batch(self, batch: WriteBatch):
        for key, value in batch.ops:
            if value is None:
                self._d.pop(key, None)
            else:
                self._d[key] = value

    def flush(self):
        pass

    def close(self):
        pass

    def __len__(self):
        return len(self._d)


class FileKV:
    """Append-only log + in-memory index."""

    def __init__(self, path: str, fsync: str = "none"):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy {fsync!r} not in "
                             f"{FSYNC_POLICIES}")
        self.path = path
        self.fsync = fsync
        self._index: dict[bytes, tuple[int, int]] = {}  # key -> (off, vlen)
        # ONE file position is shared by every reader and the writer:
        # a node is multi-threaded (consensus pump + downloader + RPC
        # + replay), so every file op serializes here — the latent
        # interleaved-seek corruption only ever seen on MemKV-free
        # (durable) topologies
        self._lock = threading.RLock()
        exists = os.path.exists(path)
        # unbuffered: every write() hits the OS immediately, so a
        # process kill loses nothing already written (crash modeling —
        # the fsync policy covers power loss, not buffering luck)
        self._f = open(path, "r+b" if exists else "w+b", buffering=0)
        if exists:
            self._replay()
        self._f.seek(0, os.SEEK_END)

    # -- open/replay --------------------------------------------------------

    def _replay(self):
        """Rebuild the index from the log.  Stops (and truncates) at
        the first torn or implausible record; a batch whose COMMIT
        marker never made it to disk is discarded wholesale."""
        f = self._f
        size = os.fstat(f.fileno()).st_size
        f.seek(0)
        batch_start = None  # file offset of an open batch's BEGIN
        batch_count = 0
        pending: list = []  # (key, voff_or_None, vlen) inside the batch
        while True:
            pos = f.tell()
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                break  # torn tail (or clean EOF)
            klen, vlen = _HDR.unpack(hdr)
            if klen == _BATCH_BEGIN:
                if batch_start is not None:
                    break  # nested BEGIN: corrupt
                batch_start, batch_count, pending = pos, vlen, []
                continue
            if klen == _BATCH_COMMIT:
                if batch_start is None or vlen != len(pending) or (
                    batch_count != len(pending)
                ):
                    break  # marker without its batch, or count mismatch
                for key, voff, vl in pending:
                    if voff is None:
                        self._index.pop(key, None)
                    else:
                        self._index[key] = (voff, vl)
                batch_start, pending = None, []
                continue
            if klen >= _KLEN_MAX:
                break  # implausible key length: corrupt header
            # bounds-check BEFORE reading: a corrupt middle record must
            # not mis-frame (and silently poison) everything after it
            if pos + _HDR.size + klen > size:
                break
            key = f.read(klen)
            if len(key) < klen:
                break
            if vlen == _TOMB:
                if batch_start is not None:
                    pending.append((key, None, 0))
                else:
                    self._index.pop(key, None)
                continue
            voff = f.tell()
            if voff + vlen > size:
                break  # torn / implausible value
            f.seek(vlen, os.SEEK_CUR)
            if batch_start is not None:
                pending.append((key, voff, vlen))
            else:
                self._index[key] = (voff, vlen)
        # drop everything from the failure point — and if the failure
        # is inside an open batch, from the batch's BEGIN marker: the
        # un-committed batch must be invisible to appends too
        cut = pos if batch_start is None else batch_start
        if cut < size:
            f.truncate(cut)
        f.seek(0, os.SEEK_END)

    # -- reads/writes -------------------------------------------------------

    def get(self, key: bytes):
        with self._lock:
            loc = self._index.get(key)
            if loc is None:
                return None
            off, vlen = loc
            end = self._f.tell()
            self._f.seek(off)
            val = self._f.read(vlen)
            self._f.seek(end)
            return val

    def _write_all(self, data: bytes) -> None:
        """Raw-mode (buffering=0) writes may legally be SHORT without
        raising — e.g. a multi-MB state blob on a near-full disk.  A
        silent short write would tear a record while the COMMIT marker
        and fsync still succeed, so every write loops to completion or
        raises."""
        view = memoryview(data)
        while view:
            n = self._f.write(view)
            if not n:
                raise OSError(
                    f"short write to {self.path}: 0 of {len(view)} "
                    "bytes accepted"
                )
            view = view[n:]

    def _append(self, key: bytes, value: bytes | None) -> int | None:
        """One record; returns the value offset (None for tombstones).
        Does NOT touch the index — callers commit index updates."""
        if value is None:
            self._write_all(_HDR.pack(len(key), _TOMB) + key)
            return None
        self._write_all(_HDR.pack(len(key), len(value)) + key)
        voff = self._f.tell()
        self._write_all(value)
        return voff

    def _append_healed(self, key: bytes, value: bytes | None):
        """_append with the same truncate-on-failure self-heal as
        write_batch: a failed single put must not leave torn bytes
        ahead of the append position — replay would truncate there on
        reopen and silently drop every LATER committed batch."""
        start = self._f.tell()
        try:
            return self._append(key, value)
        except BaseException:
            try:
                self._f.truncate(start)
                self._f.seek(0, os.SEEK_END)
            except OSError:
                pass  # reopen replay will discard the torn record
            raise

    def put(self, key: bytes, value: bytes):
        key, value = bytes(key), bytes(value)
        with self._lock:
            voff = self._append_healed(key, value)
            self._index[key] = (voff, len(value))
            if self.fsync == "always":
                os.fsync(self._f.fileno())

    def delete(self, key: bytes):
        with self._lock:
            if key in self._index:
                key = bytes(key)
                self._append_healed(key, None)
                del self._index[key]
                if self.fsync == "always":
                    os.fsync(self._f.fileno())

    def write_batch(self, batch: WriteBatch):
        """Append the whole batch between BEGIN/COMMIT markers; the
        index (and replay) sees all of it or none of it.  On ANY
        failure mid-write — injected crash point or real IO error —
        the log is truncated back to the batch start: a live store
        never carries torn bytes ahead of its append position."""
        ops = batch.ops
        if not ops:
            return
        self._lock.acquire()
        try:
            self._write_batch_locked(ops)
        finally:
            self._lock.release()

    def _write_batch_locked(self, ops):
        start = self._f.tell()
        try:
            FI.fire("kv.commit", key=self.path)
            self._write_all(_HDR.pack(_BATCH_BEGIN, len(ops)))
            locs: list = []
            for key, value in ops:
                FI.fire("kv.commit", key=self.path)
                locs.append(self._append(key, value))
            FI.fire("kv.commit", key=self.path)
            self._write_all(_HDR.pack(_BATCH_COMMIT, len(ops)))
        except BaseException:
            try:
                self._f.truncate(start)
                self._f.seek(0, os.SEEK_END)
            except OSError:
                pass  # reopen replay will discard the torn batch
            raise
        if self.fsync in ("batch", "always"):
            os.fsync(self._f.fileno())
        for (key, value), voff in zip(ops, locs):
            if value is None:
                self._index.pop(key, None)
            else:
                self._index[key] = (voff, len(value))

    def has(self, key: bytes) -> bool:
        with self._lock:
            return key in self._index

    def items(self):
        with self._lock:
            return [(k, self.get(k)) for k in list(self._index)]

    def flush(self):
        with self._lock:
            os.fsync(self._f.fileno())

    def compact(self):
        """Rewrite live records; reclaims tombstones + stale puts."""
        with self._lock:
            tmp = self.path + ".compact"
            live = self.items()
            with open(tmp, "wb") as out:
                for k, v in live:
                    out.write(_HDR.pack(len(k), len(v)) + k + v)
                out.flush()
                os.fsync(out.fileno())
            self._f.close()
            os.replace(tmp, self.path)
            self._f = open(self.path, "r+b", buffering=0)
            self._index.clear()
            self._replay()
            self._f.seek(0, os.SEEK_END)

    # -- lifecycle ----------------------------------------------------------

    def close(self):
        with self._lock:
            if self._f.closed:
                return
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass
            self._f.close()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __len__(self):
        with self._lock:
            return len(self._index)


class ShardedCollection:
    """One DB per shard id (reference: internal/shardchain/
    shardchains.go CollectionImpl)."""

    def __init__(self, factory):
        """factory(shard_id) -> KV store."""
        self._factory = factory
        self._dbs: dict[int, object] = {}

    def shard_db(self, shard_id: int):
        db = self._dbs.get(shard_id)
        if db is None:
            db = self._factory(shard_id)
            self._dbs[shard_id] = db
        return db

    def close_all(self):
        for db in self._dbs.values():
            db.close()
        self._dbs.clear()
