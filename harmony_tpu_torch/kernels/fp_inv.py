"""The hand-written CUDA kernel for Fp inversion (``csrc/fp_inv.cu``).

It replaces no TPU kernel: the JAX package's ``ops/fp.py`` inv is a scan
of Pallas multiplies over the bits of p - 2, which XLA runs inside its
jitted programs.  Run eagerly in PyTorch it was 610 one-row ``mont_mul``
launches in a row; this kernel inverts in one launch, by a binary
extended GCD (the inverse is unique, so the limbs are the chain's).
Built with the port's other kernels by ``kernels/_build.py``.
``LAUNCHES`` counts the launches.  The plain version is
``harmony_tpu_torch.ops.fp.inv_reference``, the Fermat chain.
"""

import torch

from . import _build

LAUNCHES = 0


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^-1 = a^(p - 2) in the Montgomery domain of canonical (..., 32)
    int32 limb tensors on a CUDA device, with inv(0) = 0.  Launches on the
    current stream and does not synchronise."""
    global LAUNCHES
    out = _build.unary("harmony_fp_inv", a)
    if out.numel():  # the call launched the kernel
        LAUNCHES += 1
    return out
