"""The hand-written CUDA kernel for the Miller loop (``csrc/miller_loop.cu``).

It replaces no TPU kernel: the JAX package's ``ops/pairing.py``
miller_loop is a scan over |x|'s schedule around the Pallas multiply,
which XLA runs as one program.  Run eagerly in PyTorch, one loop was some
3,200 ``fp_addsub``, 560 ``mont_mul`` and 130 ``fp12_mul`` launches and
10,000 other tensor ops; this kernel runs the whole loop in one launch.
Built with the port's other kernels by ``kernels/_build.py``.
``LAUNCHES`` counts the launches.  The plain version is
``harmony_tpu_torch.ops.pairing.miller_loop_reference``.
"""

import math

import torch

from . import _build

LAUNCHES = 0
_ENTRY = "harmony_miller_loop"


def miller_loop(p_aff: torch.Tensor, q_aff: torch.Tensor) -> torch.Tensor:
    """f_{|x|,Q}(P), conjugated, of canonical affine points in the
    Montgomery domain on one CUDA device: P (..., 2, 32) over Fp and Q
    (..., 2, 2, 32) over Fp2, int32 limbs, their leading axes broadcast
    against each other; f is (..., 2, 3, 2, 32), one block per element of
    the leading axes (fewer than 2^31).  Launches on the current stream
    and does not synchronise."""
    global LAUNCHES
    if p_aff.dtype is not torch.int32 or q_aff.dtype is not torch.int32:
        raise TypeError(f"{_ENTRY} takes int32, got {p_aff.dtype} and "
                        f"{q_aff.dtype}")
    if (not p_aff.is_cuda or not q_aff.is_cuda
            or p_aff.get_device() != q_aff.get_device()
            or not _build._takes(p_aff, _build.G1_AFFINE)
            or not _build._takes(q_aff, _build.G2_AFFINE)):
        raise ValueError(
            f"{_ENTRY} takes (..., 2, 32) and (..., 2, 2, 32) limbs on one "
            f"CUDA device, got {tuple(p_aff.shape)} on {p_aff.device} and "
            f"{tuple(q_aff.shape)} on {q_aff.device}")
    lead = torch.broadcast_shapes(p_aff.shape[:-2], q_aff.shape[:-3])
    p = _build._ready(p_aff.expand(*lead, *_build.G1_AFFINE))
    q = _build._ready(q_aff.expand(*lead, *_build.G2_AFFINE))
    out = torch.empty((*lead, *_build.FP12), dtype=torch.int32,
                      device=p.device)
    if out.numel():
        _build._launch(_ENTRY, out, math.prod(lead),
                       (p.data_ptr(), q.data_ptr()))
        LAUNCHES += 1
    return out
