"""The hand-written CUDA kernel for the final exponentiation
(``csrc/final_exp.cu``).

It replaces no TPU kernel: the JAX package's ``ops/pairing.py``
final_exponentiation is jnp code around the Pallas multiply (the easy part
by the tower's inverse and Frobenius maps, then five powers by cyclotomic
squarings in a fori_loop inside a scan), which XLA runs as one program.
Run eagerly in PyTorch, one final exponentiation was 183 kernel launches
and 338 other tensor ops; this kernel runs it in one launch.  Built with
the port's other kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts
the launches.  The plain version is
``harmony_tpu_torch.ops.pairing.final_exponentiation_reference``.
"""

import torch

from . import _build

LAUNCHES = 0


def final_exp(f: torch.Tensor) -> torch.Tensor:
    """f^(3 (p^12 - 1) / r), the cubed pairing's final exponentiation, of
    canonical (..., 2, 3, 2, 32) int32 Fp12 limb tensors in the Montgomery
    domain on a CUDA device, one block per element of the leading axes
    (fewer than 2^31); 0 maps to 0, as in the plain version.  Launches on
    the current stream and does not synchronise."""
    global LAUNCHES
    out = _build.unary("harmony_final_exp", f, _build.FP12)
    if out.numel():  # the call launched the kernel
        LAUNCHES += 1
    return out
