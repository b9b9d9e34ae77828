"""The hand-written CUDA kernel for the Fp12 product (``csrc/fp12_mul.cu``).

It replaces no TPU kernel: the JAX package's ``ops/towers.py`` fp12_mul
(and fp12_sqr) are jnp code around the Pallas multiply, which XLA fuses
into its jitted programs.  Run eagerly in PyTorch, one product was 31
``fp_addsub`` launches, one ``mont_mul`` launch and the stacks and copies
around them; this kernel does all of it in one launch.  Built with the
port's other kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts the
launches, squares included.  The plain versions are
``harmony_tpu_torch.ops.towers.fp12_mul_reference`` and
``fp12_sqr_reference``.
"""

import torch

from . import _build

LAUNCHES = 0


def fp12_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b of canonical (..., 2, 3, 2, 32) int32 Fp12 limb tensors on one
    CUDA device, broadcast against each other; a^2 is ``fp12_mul(a, a)``,
    which reads a once.  Launches on the current stream and does not
    synchronise."""
    global LAUNCHES
    out = _build.binary("harmony_fp12_mul", a, b, _build.FP12)
    if out.numel():  # the call launched the kernel
        LAUNCHES += 1
    return out
