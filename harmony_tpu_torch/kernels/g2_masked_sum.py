"""The hand-written CUDA kernel for the masked G2 sum
(``csrc/g2_masked_sum.cu``).

It replaces no TPU kernel: it fuses the JAX package's ``ops/curve.py``
masked_sum over Fp2 (a select by the mask, padding and a tree of Jacobian
adds with the doubling fallback), jnp code around the Pallas multiply that
XLA fuses, as ``ops/bls.py`` aggregate_sigs calls it.  Run eagerly in
PyTorch, a sum of 200 signatures is 8 levels of adds, each 10 stacked
product calls over Fp2 and the adds and selects around them; this
kernel is one launch.  Built with the port's other kernels by
``kernels/_build.py``.  ``LAUNCHES`` counts the launches.  The plain
version is ``harmony_tpu_torch.ops.curve.masked_sum_reference`` over
``FP2_OPS``.
"""

import torch

from . import _build

LAUNCHES = 0
_ENTRY = "harmony_g2_masked_sum"
# the widest committee bucket (device.py COMMITTEE_BUCKETS)
MAX_POINTS = 1024


def g2_masked_sum(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The sum of the G2 points whose mask word is 1, as masked_sum over
    Fp2: canonical Jacobian ``points`` (N, 3, 2, 32) in the Montgomery
    domain, int32 limbs on a CUDA device, N <= 1024; ``mask`` (N,) on the
    same device, converted to int32 as masked_sum does.  Returns the
    Jacobian sum (3, 2, 32), (1, 1, 0) where nothing is selected.  One
    block; launches on the current stream and does not synchronise."""
    global LAUNCHES
    if points.dtype is not torch.int32:
        raise TypeError(f"{_ENTRY} takes int32 points, got {points.dtype}")
    n = points.shape[0] if points.dim() else 0
    if (not points.is_cuda or not mask.is_cuda
            or points.get_device() != mask.get_device()
            or points.dim() != 4
            or not _build._takes(points, _build.G2_JACOBIAN)
            or tuple(mask.shape) != (n,) or n > MAX_POINTS):
        raise ValueError(
            f"{_ENTRY} takes points (N, 3, 2, 32) with a mask (N,), N <= "
            f"{MAX_POINTS}, on one CUDA device; got {tuple(points.shape)} "
            f"on {points.device} and {tuple(mask.shape)} on {mask.device}")
    points = _build._ready(points)
    mask = _build._ready(mask.to(torch.int32))
    out = torch.empty(_build.G2_JACOBIAN, dtype=torch.int32,
                      device=points.device)
    _build._launch(_ENTRY, out, 1, (points.data_ptr(), mask.data_ptr()), (n,))
    LAUNCHES += 1
    return out
