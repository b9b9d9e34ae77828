"""The hand-written CUDA Montgomery multiply: build, bind and launch.

``csrc/mont_mul.cu`` is compiled with ``nvcc`` for sm_90a into a shared
library with a plain C interface and bound with ``ctypes``.  The build
runs at first use, from the sources in the checkout, into
``harmony_tpu_torch/_build/`` (git-ignored), and again whenever the
source or its flags change (the library's name carries their hash).  A
failed build or launch raises; nothing falls back to the plain version.

``LAUNCHES`` counts kernel launches, so a run can show that its path
went through the kernel.  The plain version of the same function is
``harmony_tpu_torch.ops.fp.mont_mul_reference``.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

from ..ops import _constants as C
from ..ops.limbs import N_LIMBS, int_to_limbs

LAUNCHES = 0

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "mont_mul.cu"
BUILD_DIR = _PKG / "_build"

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC"]


def _params_header() -> str:
    """The modulus for the kernel, from ops/_constants.py.  A header and
    not -D flags: nvcc splits option values at commas."""
    p_limbs = ", ".join(str(int(v)) for v in int_to_limbs(C.P_INT))
    return (f"#define HARMONY_P_LIMBS {p_limbs}\n"
            f"#define HARMONY_P_INV_NEG {C.P_INV_NEG}\n")


def library_path() -> Path:
    """Where the library for the current source, flags and constants is
    built."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(_FLAGS).encode()
        + _params_header().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"mont_mul_{digest}.so"


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            header = so.with_name(f"{so.stem}_params.{os.getpid()}.h")
            header.write_text(_params_header())
            cmd = [_nvcc(), *_FLAGS, "-include", str(header), "-o", str(tmp),
                   str(SOURCE)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            finally:
                header.unlink()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        fn = lib.harmony_mont_mul
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b 2^-384 mod p of canonical (..., 32) int32
    limb tensors on one CUDA device, broadcast against each other.

    Launches on the current stream and does not synchronise.
    """
    global LAUNCHES
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(
            f"mont_mul kernel needs both operands on one CUDA device, "
            f"got {a.device} and {b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError(f"mont_mul kernel takes int32, got {a.dtype}, "
                        f"{b.dtype}")
    a, b = torch.broadcast_tensors(a, b)
    if a.dim() == 0 or a.shape[-1] != N_LIMBS:
        raise ValueError(f"mont_mul kernel takes (..., {N_LIMBS}) limbs, "
                         f"got {tuple(a.shape)}")
    a, b = _aligned(a), _aligned(b)
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    rows = out.numel() // N_LIMBS
    if rows == 0:
        return out
    lib = build()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.harmony_mont_mul(a.data_ptr(), b.data_ptr(),
                                   out.data_ptr(), rows, stream)
    if err != 0:
        raise RuntimeError(f"mont_mul kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
