"""The hand-written CUDA kernel for runs of cyclotomic squarings
(``csrc/fp12_cyclo_sqr.cu``).

It replaces no TPU kernel: the JAX package's ``ops/towers.py``
fp12_cyclo_sqr is jnp code around the Pallas multiply, and its
``ops/pairing.py`` runs a fori_loop of them inside a scan, all fused by
XLA.  Run eagerly in PyTorch, one squaring was 47 ``fp_addsub`` launches,
one ``mont_mul`` launch and the stacks around them; this kernel does a
whole run of squarings in one launch.  Built with the port's other
kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts launches.  The
plain version is ``harmony_tpu_torch.ops.towers.fp12_cyclo_sqr_n`` on a
CPU tensor, a loop over ``fp12_cyclo_sqr_reference``.
"""

import torch

from . import _build

LAUNCHES = 0


def fp12_cyclo_sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` Granger-Scott squarings of canonical (..., 2, 3, 2, 32) int32
    Fp12 limb tensors on a CUDA device, in one launch: a^(2^n) for unitary
    a.  Launches on the current stream and does not synchronise."""
    global LAUNCHES
    if not 0 <= n < 2**31:
        raise ValueError(f"the count of squarings must be in [0, 2^31), "
                         f"got {n}")
    out = _build.unary("harmony_fp12_cyclo_sqr", a, _build.FP12, (n,))
    if out.numel():  # the call launched the kernel
        LAUNCHES += 1
    return out
