"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for sm_90a,
all started together, and the objects are linked into ONE shared library
with a plain C interface, bound with ``ctypes``.  The build runs at first
use, from the sources in the checkout, into ``harmony_tpu_torch/_build/``
(git-ignored), and again whenever a source, a shared header, the flags
or the constants change: the library's name carries their hash.  A failed
build or launch raises; nothing falls back to a plain version.

The modulus, R^3 mod p (which takes the inversion's plain inverse back
into the Montgomery domain), the Montgomery form of 1, the schedules of
|x| (the Miller loop's and the final exponentiation's) and |x - 1|, and
the Frobenius constants reach the kernels through a header generated here
from ``ops/_constants.py`` and ``ops/schedule.py`` and pre-included
(``params_header``); not through ``-D`` flags, because nvcc splits option
values at commas.
"""

import ctypes
import hashlib
import math
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..ops import _constants as C
from ..ops.limbs import N_LIMBS, limbs_to_int
from ..ops.schedule import X_SCHED, XM1_SCHED

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "mont_mul.cu", CSRC / "fp_addsub.cu", CSRC / "fp12_mul.cu",
           CSRC / "fp12_cyclo_sqr.cu", CSRC / "miller_loop.cu",
           CSRC / "fp_inv.cu", CSRC / "g1_masked_sum.cu",
           CSRC / "final_exp.cu", CSRC / "scalar_mul.cu",
           CSRC / "g2_masked_sum.cu")
HEADERS = (CSRC / "fp384.cuh", CSRC / "fp384_split.cuh", CSRC / "fp12.cuh",
           CSRC / "phases.cuh", CSRC / "fp12_plans.cuh", CSRC / "cyclo.cuh",
           CSRC / "miller.cuh", CSRC / "final_exp.cuh", CSRC / "g1.cuh",
           CSRC / "jac.cuh")
BUILD_DIR = _PKG / "_build"


def _words(x: int) -> tuple:
    """x < 2^384 as 12 little-endian words of 32 bits."""
    return tuple((x >> (32 * i)) & 0xFFFFFFFF for i in range(12))


# p, 2^384 mod p (1 in the Montgomery domain) and 2^1152 mod p (R^3) as
# words, and -p^-1 mod 2^32
P_WORDS = _words(C.P_INT)
ONE_MONT_WORDS = _words((1 << 384) % C.P_INT)
R3_WORDS = _words((1 << 1152) % C.P_INT)
P_INV32 = -pow(C.P_INT, -1, 1 << 32) % (1 << 32)
# FROB_GAMMA[k - 1][m] (ops/_constants.py), k = 1..3, m = 0..5, as Fp2
# pairs of words in that order
FROB_WORDS = tuple(w for gammas in C.FROB_GAMMA for pair in gammas
                   for limbs in pair for w in _words(limbs_to_int(limbs)))

_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC"]
# ptxas reports each kernel's registers, stack frame, spills and shared
# memory; build() keeps the report beside the library (report_path)
_COMPILE_FLAGS = ["-Xptxas", "-v"]

# What the kernels take: rows of limbs (one Fp element), lanes of 12 such
# rows (one Fp12 element, ops/__init__.py), the affine points of G1 and of
# the G2 twist, and the Jacobian points of both
FP = (N_LIMBS,)
FP12 = (2, 3, 2, N_LIMBS)
G1_AFFINE = (2, N_LIMBS)
G2_AFFINE = (2, 2, N_LIMBS)
G1_JACOBIAN = (3, N_LIMBS)
G2_JACOBIAN = (3, 2, N_LIMBS)


def _signature(n_ptrs, *extra):
    """ctypes argtypes of an entry point: its tensor pointers (inputs,
    then the output), the count of rows or lanes, ``extra`` scalars, and
    the stream."""
    return ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int64, *extra,
                                          ctypes.c_void_p])


# C entry points and their arguments
_ENTRY_POINTS = {"harmony_mont_mul": _signature(3),
                 "harmony_fp_add": _signature(3),
                 "harmony_fp_sub": _signature(3),
                 "harmony_fp_neg": _signature(2),
                 "harmony_fp12_mul": _signature(3),
                 "harmony_fp12_cyclo_sqr": _signature(2, ctypes.c_int32),
                 "harmony_miller_loop": _signature(3),
                 "harmony_fp_inv": _signature(2),
                 "harmony_g1_masked_sum": _signature(
                     3, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32),
                 "harmony_final_exp": _signature(2),
                 "harmony_scalar_mul_g1": _signature(
                     3, ctypes.c_int64, ctypes.c_int32),
                 "harmony_scalar_mul_g2": _signature(
                     3, ctypes.c_int64, ctypes.c_int32),
                 "harmony_scalar_mul_g1_phases": _signature(
                     4, ctypes.c_int64, ctypes.c_int32),
                 "harmony_scalar_mul_g2_phases": _signature(
                     4, ctypes.c_int64, ctypes.c_int32),
                 "harmony_g2_masked_sum": _signature(
                     4, ctypes.c_int64, ctypes.c_int64),
                 "harmony_g2_masked_sum_phases": _signature(
                     5, ctypes.c_int64, ctypes.c_int64)}

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def params_header() -> str:
    def words(ws):
        return ", ".join(f"0x{w:08x}u" for w in ws)

    def ints(xs):
        return ", ".join(map(str, xs))

    n_dbl, do_add = X_SCHED  # |x|'s schedule: the Miller loop's
    n_sqr, do_mul = XM1_SCHED
    return (f"#define HARMONY_P_WORDS {words(P_WORDS)}\n"
            f"#define HARMONY_P_INV32 0x{P_INV32:08x}u\n"
            f"#define HARMONY_R3_WORDS {words(R3_WORDS)}\n"
            f"#define HARMONY_ONE_MONT_WORDS {words(ONE_MONT_WORDS)}\n"
            f"#define HARMONY_MILLER_DBL {ints(n_dbl)}\n"
            f"#define HARMONY_MILLER_ADD {ints(do_add)}\n"
            f"#define HARMONY_XM1_SQR {ints(n_sqr)}\n"
            f"#define HARMONY_XM1_MUL {ints(do_mul)}\n"
            f"#define HARMONY_FROB_WORDS {words(FROB_WORDS)}\n")


def library_path() -> Path:
    """Where the library for the current sources, flags and constants is
    built."""
    digest = hashlib.sha256()
    for path in SOURCES + HEADERS:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(_FLAGS + _COMPILE_FLAGS).encode()
                  + params_header().encode())
    return BUILD_DIR / f"harmony_kernels_{digest.hexdigest()[:16]}.so"


def report_path() -> Path:
    """The compiler's report (ptxas -v) of the library at library_path()."""
    return library_path().with_suffix(".ptxas.txt")


def _run_all(cmds) -> list:
    """Start every command, then wait for all; raise on the first that
    failed, with its output; return their outputs."""
    procs = []
    try:
        for cmd in cmds:
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    finally:
        outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    return outputs


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                header = Path(tmp) / "harmony_params.h"
                header.write_text(params_header())
                objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
                report = _run_all([[_nvcc(), *_FLAGS, *_COMPILE_FLAGS,
                                    "-include", str(header), "-c", "-o",
                                    str(obj), str(src)]
                                   for src, obj in zip(SOURCES, objs)])
                report_path().write_text("".join(report))
                linked = Path(tmp) / so.name
                _run_all([[_nvcc(), *_FLAGS, "-shared", "-o", str(linked),
                           *map(str, objs)]])
                os.replace(linked, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


# The launch path below runs some 500 times per quorum check, and its
# host time is much of the check's: it is written out per arity and asks
# each tensor only what it must.


def _refuse(entry: str, tail: tuple, *xs: torch.Tensor) -> None:
    """Raise the error that fits operands the kernel does not take."""
    if any(x.dtype is not torch.int32 for x in xs):
        raise TypeError(f"{entry} takes int32, got {[x.dtype for x in xs]}")
    got = [(tuple(x.shape), str(x.device)) for x in xs]
    raise ValueError(f"{entry} takes (..., {', '.join(map(str, tail))}) "
                     f"limbs on one CUDA device, got {got}")


def _takes(a: torch.Tensor, tail: tuple) -> bool:
    """Whether a's trailing axes are ``tail``."""
    return a.dim() >= len(tail) and a.shape[a.dim() - len(tail):] == tail


def _ready(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, with a 16-byte aligned base (the kernels' vector
    loads).  A strided view, such as a tower's ``a[..., 0, :]``, costs one
    copy here."""
    if not x.is_contiguous():
        x = x.contiguous()
    if x.data_ptr() & 15:
        x = x.clone()
    return x


def _launch(entry: str, out: torch.Tensor, count: int, ptrs: tuple,
            extra: tuple = ()) -> None:
    """Launch C entry point ``entry`` on ``count`` rows or lanes, on the
    current stream of ``out``'s device, without synchronising; raise on a
    non-zero ``cudaGetLastError``."""
    fn = getattr(_lib or build(), entry)
    index = out.get_device()
    if index == torch.cuda.current_device():
        err = fn(*ptrs, out.data_ptr(), count, *extra, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*ptrs, out.data_ptr(), count, *extra,
                     _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _raw_stream(index: int) -> int:
    """The current stream of device ``index`` as a cudaStream_t; the same
    call Triton's launcher makes, without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(index)


def binary(entry: str, a: torch.Tensor, b: torch.Tensor,
           tail: tuple = FP) -> torch.Tensor:
    """``entry`` on two (..., *tail) int32 limb tensors on one CUDA
    device, broadcast against each other, into a new tensor: one row
    (``FP``) or lane (``FP12``) per element of the leading axes.  The
    same tensor twice is passed once, uncopied.  Zero rows launch
    nothing."""
    if (a.dtype is not torch.int32 or b.dtype is not torch.int32
            or not a.is_cuda or not b.is_cuda
            or a.get_device() != b.get_device()):
        _refuse(entry, tail, a, b)
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    if not _takes(a, tail):
        _refuse(entry, tail, a, b)
    a, b = (_ready(a),) * 2 if a is b else (_ready(a), _ready(b))
    out = torch.empty_like(a)
    if out.numel():
        _launch(entry, out, out.numel() // math.prod(tail),
                (a.data_ptr(), b.data_ptr()))
    return out


def unary(entry: str, a: torch.Tensor, tail: tuple = FP,
          extra: tuple = ()) -> torch.Tensor:
    """``entry`` on one (..., *tail) int32 limb tensor on a CUDA device,
    with ``extra`` scalar arguments, as ``binary``."""
    if a.dtype is not torch.int32 or not a.is_cuda or not _takes(a, tail):
        _refuse(entry, tail, a)
    a = _ready(a)
    out = torch.empty_like(a)
    if out.numel():
        _launch(entry, out, out.numel() // math.prod(tail), (a.data_ptr(),),
                extra)
    return out
