"""ctypes binding for the native C++ KV store (native/kvstore.cpp).

Same interface as kv.FileKV and the SAME on-disk format — a chain
written by one opens under the other.  The native store is the
deployment IO path (the role LevelDB's C++ plays under the reference's
core/rawdb); FileKV stays the dependency-free fallback.

The port's copy of the JAX package's ``core/kv_native.py``.  The
library is the port's own copy of the C++ source,
``harmony_tpu_torch/native/kvstore.cpp``, built at first use with g++
(``native/Makefile``'s flags) into ``harmony_tpu_torch/_build/``
(git-ignored) under a name that carries the hash of the source and the
flags; the build writes a temporary file and renames it into place,
under a file lock, so that concurrent processes neither race nor load a
half-written library.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "kvstore.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's flags for libharmony_kv.so
CXXFLAGS = ("-O2", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")
_lib = None
_load_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libharmony_kv_{digest.hexdigest()[:16]}.so"


def _load():
    global _lib
    with _load_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build_native())))
        return _lib


def _bind(lib):
    lib.kv_open.restype = ctypes.c_void_p
    lib.kv_open.argtypes = [ctypes.c_char_p]
    lib.kv_put.restype = ctypes.c_int
    lib.kv_put.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.kv_get.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.kv_get.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.kv_delete.restype = ctypes.c_int
    lib.kv_delete.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.kv_has.restype = ctypes.c_int
    lib.kv_has.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32,
    ]
    lib.kv_len.restype = ctypes.c_uint64
    lib.kv_len.argtypes = [ctypes.c_void_p]
    lib.kv_write_batch.restype = ctypes.c_int
    lib.kv_write_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint32,
    ]
    lib.kv_config.restype = ctypes.c_int
    lib.kv_config.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.kv_flush.restype = ctypes.c_int
    lib.kv_flush.argtypes = [ctypes.c_void_p]
    lib.kv_compact.restype = ctypes.c_int
    lib.kv_compact.argtypes = [ctypes.c_void_p]
    lib.kv_close.restype = None
    lib.kv_close.argtypes = [ctypes.c_void_p]
    return lib


def build_native() -> Path:
    """The shared library, compiled with g++ if this source and these
    flags have none yet."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "kvstore.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", tmp,
                     str(SOURCE)],
                    check=True, capture_output=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    return so


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeKV:
    """Drop-in for kv.FileKV backed by the C++ store."""

    def __init__(self, path: str, fsync: str = "none"):
        from .kv import FSYNC_POLICIES

        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync policy {fsync!r} not in "
                             f"{FSYNC_POLICIES}")
        lib = _load()
        self._lib = lib
        self._h = lib.kv_open(path.encode())
        if not self._h:
            raise OSError(f"kv_open failed for {path}")
        self.path = path
        self.fsync = fsync
        # the C handle shares one FILE* (file position!) and one
        # returned-value buffer: a node is multi-threaded, so every
        # call serializes here — same discipline as FileKV
        self._lock = threading.RLock()
        # the native store fsyncs batch commits itself; the "always"
        # policy additionally flushes per put/delete from this side
        lib.kv_config(self._h, 1 if fsync in ("batch", "always") else 0)

    def get(self, key: bytes):
        with self._lock:
            vlen = ctypes.c_uint32(0)
            ptr = self._lib.kv_get(
                self._h, key, len(key), ctypes.byref(vlen)
            )
            if not ptr:
                return None
            return ctypes.string_at(ptr, vlen.value)

    def put(self, key: bytes, value: bytes):
        with self._lock:
            if self._lib.kv_put(self._h, key, len(key), value,
                                len(value)) != 0:
                raise OSError("kv_put failed")
            if self.fsync == "always":
                self._lib.kv_flush(self._h)  # fflush + fsync

    def delete(self, key: bytes):
        with self._lock:
            if self._lib.kv_delete(self._h, key, len(key)) != 0:
                raise OSError("kv_delete failed")
            if self.fsync == "always":
                self._lib.kv_flush(self._h)

    def has(self, key: bytes) -> bool:
        with self._lock:
            return bool(self._lib.kv_has(self._h, key, len(key)))

    def write_batch(self, batch):
        """Atomic commit of a kv.WriteBatch — the same BEGIN/COMMIT
        marker grammar as FileKV (the two stores replay each other's
        batches).  Fires the ``kv.commit`` crash point once before the
        native call: the C side is a single append, so the per-record
        crash-point matrix is FileKV's to enumerate."""
        import struct as _struct

        from .. import faultinject as FI
        from .kv import _TOMB

        ops = batch.ops
        if not ops:
            return
        FI.fire("kv.commit", key=self.path)
        out = bytearray()
        for key, value in ops:
            if value is None:
                out += _struct.pack("<II", len(key), _TOMB) + key
            else:
                out += _struct.pack("<II", len(key), len(value))
                out += key + value
        with self._lock:
            if self._lib.kv_write_batch(self._h, bytes(out), len(out),
                                        len(ops)) != 0:
                raise OSError("kv_write_batch failed")

    def flush(self):
        with self._lock:
            self._lib.kv_flush(self._h)

    def compact(self):
        with self._lock:
            if self._lib.kv_compact(self._h) != 0:
                raise OSError("kv_compact failed")

    def close(self):
        with self._lock:
            if self._h:
                self._lib.kv_flush(self._h)
                self._lib.kv_close(self._h)
                self._h = None

    @property
    def closed(self) -> bool:
        return not self._h

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __len__(self):
        with self._lock:
            return int(self._lib.kv_len(self._h))

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
