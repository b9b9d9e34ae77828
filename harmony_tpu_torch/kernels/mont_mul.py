"""The hand-written CUDA Montgomery multiply (``csrc/mont_mul.cu``).

Replaces the TPU kernel ``harmony_tpu/ops/fp_pallas.py::_mont_mul_kernel``.
Built with the port's other kernels by ``kernels/_build.py``.
``LAUNCHES`` counts kernel launches, so a run can show that its path went
through the kernel.  The plain version of the same function is
``harmony_tpu_torch.ops.fp.mont_mul_reference``.
"""

import torch

from . import _build

LAUNCHES = 0


def mont_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a b 2^-384 mod p of canonical (..., 32) int32
    limb tensors on one CUDA device, broadcast against each other.

    Launches on the current stream and does not synchronise.
    """
    global LAUNCHES
    out = _build.binary("harmony_mont_mul", a, b)
    if out.numel():  # the call launched the kernel
        LAUNCHES += 1
    return out
