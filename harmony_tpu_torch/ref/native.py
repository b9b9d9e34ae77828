"""ctypes binding for the native host BLS12-381 library (native/bls381.cpp).

The reference's hot crypto lives in herumi's C++ mcl (reference:
go.mod:27, Makefile:68-70); this module is the analogous fast host path:
about 2 ms pairings instead of the bigint twin's 240 ms, and a native
hash-to-G2 (``g2_map_tai`` and the cofactor ``g2_mul``).  The bigint
modules (ref/fields.py, ref/pairing.py, ref/curve.py) remain the pure
auditable ground truth — this binding exposes the SAME conventions
(identical GT elements, identical sqrt branch choices, identical
hash-map outputs).

The library is the port's own copy of the C++ source,
``harmony_tpu_torch/native/bls381.cpp``, built at first use with g++ into
``harmony_tpu_torch/_build/`` (git-ignored), under a name that carries
the hash of the source and the flags, so that an edited source is
rebuilt.  The build writes a temporary file and renames it into place,
under a file lock, so that concurrent processes neither race nor load a
half-written library.

Interface: reference-style tuples in and out (Fp = int, Fp2 = (c0, c1),
points = affine pairs or None).  Selection knob: HOST_BLS env var —
  auto   (default) use native when the library builds, loads and
         self-tests; pure Python otherwise
  bigint never use it (pure-Python mode for auditing/debugging)
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

from .params import P, R_ORDER

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "bls381.cpp"
BUILD_DIR = _PKG / "_build"
# native/Makefile's flags for the pairing library
CXXFLAGS = ("-O3", "-Wall", "-Wextra", "-fPIC", "-std=c++17", "-shared")

_lib = None
_avail: bool | None = None
_lock = threading.Lock()

_R_BYTES = R_ORDER.to_bytes(32, "big")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXXFLAGS).encode())
    return BUILD_DIR / f"libharmony_bls381_{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library, built if this source and these flags have none yet."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "bls381.lock", "w") as lock:
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


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    lib.hbls_ready.restype = ctypes.c_int
    for name, args, res in [
        ("hbls_g1_mul", [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_int, ctypes.c_char_p], ctypes.c_int),
        ("hbls_g2_mul", [ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_int, ctypes.c_char_p], ctypes.c_int),
        ("hbls_g1_sum", [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                         ctypes.c_char_p], ctypes.c_int),
        ("hbls_g2_sum", [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                         ctypes.c_char_p], ctypes.c_int),
        ("hbls_g1_in_subgroup", [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int], ctypes.c_int),
        ("hbls_g2_in_subgroup", [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int], ctypes.c_int),
        ("hbls_g2_map_tai", [ctypes.c_char_p, ctypes.c_char_p],
         ctypes.c_int),
        ("hbls_fp2_sqrt", [ctypes.c_char_p, ctypes.c_char_p], ctypes.c_int),
        ("hbls_fp_sqrt", [ctypes.c_char_p, ctypes.c_char_p], ctypes.c_int),
        ("hbls_multi_pairing", [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int, ctypes.c_char_p], None),
        ("hbls_pairing_check", [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int], ctypes.c_int),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _lib = lib
    return lib


def available() -> bool:
    """True when the fast native path should be used (see HOST_BLS).
    The first call builds and loads the library."""
    global _avail
    if os.environ.get("HOST_BLS", "auto") == "bigint":
        return False
    if _avail is None:
        with _lock:
            if _avail is None:
                try:
                    _avail = _load().hbls_ready() == 1
                except Exception:  # noqa: BLE001 — no toolchain: bigint path
                    _avail = False
    return _avail


# --- packing ---------------------------------------------------------------

def _pack_g1(pt) -> tuple[bytes, int]:
    if pt is None:
        return bytes(96), 1
    return pt[0].to_bytes(48, "big") + pt[1].to_bytes(48, "big"), 0


def _pack_g2(pt) -> tuple[bytes, int]:
    if pt is None:
        return bytes(192), 1
    x, y = pt
    return (x[0].to_bytes(48, "big") + x[1].to_bytes(48, "big")
            + y[0].to_bytes(48, "big") + y[1].to_bytes(48, "big")), 0


def _unpack_g1(raw: bytes):
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:96], "big"))


def _unpack_g2(raw: bytes):
    return (
        (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:96], "big")),
        (int.from_bytes(raw[96:144], "big"),
         int.from_bytes(raw[144:192], "big")),
    )


def _scalar_bytes(k: int) -> bytes:
    if k == 0:
        return b"\x00"
    return k.to_bytes((k.bit_length() + 7) // 8, "big")


# --- group ops -------------------------------------------------------------

def g1_mul(pt, k: int):
    if pt is None or k == 0:
        return None
    if k < 0:
        pt, k = (pt[0], (-pt[1]) % P), -k
    buf, inf = _pack_g1(pt)
    out = ctypes.create_string_buffer(96)
    sc = _scalar_bytes(k)
    if _lib.hbls_g1_mul(buf, inf, sc, len(sc), out):
        return None
    return _unpack_g1(out.raw)


def g2_mul(pt, k: int):
    if pt is None or k == 0:
        return None
    if k < 0:
        x, y = pt
        pt, k = (x, ((-y[0]) % P, (-y[1]) % P)), -k
    buf, inf = _pack_g2(pt)
    out = ctypes.create_string_buffer(192)
    sc = _scalar_bytes(k)
    if _lib.hbls_g2_mul(buf, inf, sc, len(sc), out):
        return None
    return _unpack_g2(out.raw)


def g1_sum(pts):
    packed, infs = [], []
    for p in pts:
        b, i = _pack_g1(p)
        packed.append(b)
        infs.append(i)
    if not packed:
        return None
    out = ctypes.create_string_buffer(96)
    if _lib.hbls_g1_sum(b"".join(packed), bytes(infs), len(packed), out):
        return None
    return _unpack_g1(out.raw)


def g2_sum(pts):
    packed, infs = [], []
    for p in pts:
        b, i = _pack_g2(p)
        packed.append(b)
        infs.append(i)
    if not packed:
        return None
    out = ctypes.create_string_buffer(192)
    if _lib.hbls_g2_sum(b"".join(packed), bytes(infs), len(packed), out):
        return None
    return _unpack_g2(out.raw)


def g1_in_subgroup(pt) -> bool:
    """On-curve AND r-torsion (rogue-point defense in decompress)."""
    if pt is None:
        return True
    buf, _ = _pack_g1(pt)
    return bool(_lib.hbls_g1_in_subgroup(buf, _R_BYTES, len(_R_BYTES)))


def g2_in_subgroup(pt) -> bool:
    if pt is None:
        return True
    buf, _ = _pack_g2(pt)
    return bool(_lib.hbls_g2_in_subgroup(buf, _R_BYTES, len(_R_BYTES)))


# --- hash-to-curve helpers -------------------------------------------------

def g2_map_tai(x):
    """One try-and-increment step: candidate x in Fp2 -> twist point with
    the canonical (lexicographically smaller) y, or None if x^3 + b is a
    non-square.  Bitwise the twin's map_to_twist body."""
    xb = x[0].to_bytes(48, "big") + x[1].to_bytes(48, "big")
    out = ctypes.create_string_buffer(192)
    if not _lib.hbls_g2_map_tai(xb, out):
        return None
    return _unpack_g2(out.raw)


def fp2_sqrt(a):
    """Deterministic Fp2 sqrt; same root as ref/fields.py::fp2_sqrt."""
    ab = (a[0] % P).to_bytes(48, "big") + (a[1] % P).to_bytes(48, "big")
    out = ctypes.create_string_buffer(96)
    if not _lib.hbls_fp2_sqrt(ab, out):
        return None
    raw = out.raw
    return (int.from_bytes(raw[:48], "big"), int.from_bytes(raw[48:96], "big"))


def fp_sqrt(a):
    ab = (a % P).to_bytes(48, "big")
    out = ctypes.create_string_buffer(48)
    if not _lib.hbls_fp_sqrt(ab, out):
        return None
    return int.from_bytes(out.raw[:48], "big")


# --- pairings --------------------------------------------------------------

def _pack_pairs(pairs):
    g1b, g1i, g2b, g2i = [], [], [], []
    for p, q in pairs:
        b, i = _pack_g1(p)
        g1b.append(b)
        g1i.append(i)
        b, i = _pack_g2(q)
        g2b.append(b)
        g2i.append(i)
    return b"".join(g1b), bytes(g1i), b"".join(g2b), bytes(g2i), len(g1i)


def multi_pairing(pairs):
    """prod_i e(P_i, Q_i) as a ref-tuple Fp12 GT element — bitwise equal
    to ref/pairing.py::multi_pairing (the framework's cubed pairing)."""
    a, b, c, d, n = _pack_pairs(pairs)
    out = ctypes.create_string_buffer(576)
    _lib.hbls_multi_pairing(a, b, c, d, n, out)
    raw = out.raw
    vals = [int.from_bytes(raw[i * 48:(i + 1) * 48], "big")
            for i in range(12)]
    fp2s = [(vals[2 * i], vals[2 * i + 1]) for i in range(6)]
    return ((fp2s[0], fp2s[1], fp2s[2]), (fp2s[3], fp2s[4], fp2s[5]))


def pairing_check(pairs) -> bool:
    """prod_i e(P_i, Q_i) == 1 — the signature-verify decision."""
    a, b, c, d, n = _pack_pairs(pairs)
    return bool(_lib.hbls_pairing_check(a, b, c, d, n))
