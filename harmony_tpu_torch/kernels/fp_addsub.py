"""The hand-written CUDA kernel for Fp addition, subtraction and negation
(``csrc/fp_addsub.cu``).

It replaces no TPU kernel: the JAX package's ``ops/fp.py`` add, sub and
neg are jnp code that XLA fuses around the Pallas multiply.  Built with
the port's other kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts
the launches of all three operations.  The plain versions are
``harmony_tpu_torch.ops.fp.add_reference``, ``sub_reference`` and
``neg_reference``.
"""

import torch

from . import _build

LAUNCHES = 0


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p of canonical (..., 32) int32 limb tensors on one CUDA
    device, broadcast against each other.  Launches on the current stream
    and does not synchronise; so do ``sub`` and ``neg``."""
    global LAUNCHES
    out = _build.binary("harmony_fp_add", a, b)
    if out.numel():  # the call launched the kernel
        LAUNCHES += 1
    return out


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p, as ``add``."""
    global LAUNCHES
    out = _build.binary("harmony_fp_sub", a, b)
    if out.numel():
        LAUNCHES += 1
    return out


def neg(a: torch.Tensor) -> torch.Tensor:
    """(-a) mod p, with -0 = 0."""
    global LAUNCHES
    out = _build.unary("harmony_fp_neg", a)
    if out.numel():
        LAUNCHES += 1
    return out
