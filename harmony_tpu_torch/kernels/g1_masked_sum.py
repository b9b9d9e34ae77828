"""The hand-written CUDA kernel for the masked G1 sum and its affine form
(``csrc/g1_masked_sum.cu``).

It replaces no TPU kernel: it fuses the JAX package's ``ops/curve.py``
masked_sum over Fp (a select by the mask, padding and a tree of Jacobian
adds) and to_affine, jnp code around the Pallas multiply that XLA fuses.
Run eagerly in PyTorch, one quorum check's sum at bucket 256 was 296
launches and 633 other tensor ops; this kernel is one launch.  Built with
the port's other kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts
the launches.  The plain version is
``harmony_tpu_torch.ops.curve.masked_sum_reference`` followed by
``to_affine``.
"""

import math

import torch

from . import _build

LAUNCHES = 0
_ENTRY = "harmony_g1_masked_sum"
# the widest committee bucket (device.py COMMITTEE_BUCKETS): a lane's
# points sit in one block's shared memory
MAX_POINTS = 1024


def g1_masked_sum(points: torch.Tensor, mask: torch.Tensor,
                  affine: bool = True):
    """(sum, affine): the sum of the G1 points whose mask word is 1, as
    masked_sum, and its affine (x, y), infinity as (0, 0), as to_affine;
    affine is None, and the kernel inverts nothing, when ``affine`` is
    False.

    ``points`` are Jacobian (..., 3, 32) or affine (..., 2, 32) with (0, 0)
    for infinity, int32 limbs in the Montgomery domain on a CUDA device;
    ``mask`` is (N,) with points (N, C, 32), or (N, B) with points
    (N, 1, C, 32) (one table for every lane), N <= 1024, on the same
    device, converted to int32 as masked_sum does.  The sum is (3, 32) or
    (B, 3, 32), the affine form (2, 32) or (B, 2, 32).  One block per
    lane; launches on the current stream and does not synchronise."""
    global LAUNCHES
    if points.dtype is not torch.int32:
        raise TypeError(f"{_ENTRY} takes int32 points, got {points.dtype}")
    n = points.shape[0] if points.dim() else 0
    lanes = tuple(mask.shape[1:])
    if (not points.is_cuda or not mask.is_cuda
            or points.get_device() != mask.get_device()
            or mask.dim() not in (1, 2) or mask.shape[0] != n
            or n > MAX_POINTS
            or points.dim() != mask.dim() + 2
            or not (_build._takes(points, _build.G1_JACOBIAN)
                    or _build._takes(points, _build.G1_AFFINE))
            or (points.dim() == 4 and points.shape[1] != 1)):
        raise ValueError(
            f"{_ENTRY} takes points (N, C, 32) with a mask (N,), or "
            f"(N, 1, C, 32) with a mask (N, B), C = 3 or 2, N <= "
            f"{MAX_POINTS}, on one CUDA device; got {tuple(points.shape)} "
            f"on {points.device} and {tuple(mask.shape)} on {mask.device}")
    coords = points.shape[-2]
    points = _build._ready(points)
    mask = _build._ready(mask.to(torch.int32))
    out = torch.empty((*lanes, *_build.G1_JACOBIAN), dtype=torch.int32,
                      device=points.device)
    xy = torch.empty((*lanes, *_build.G1_AFFINE), dtype=torch.int32,
                     device=points.device) if affine else None
    count = math.prod(lanes)
    if count:
        _build._launch(_ENTRY, out, count, (points.data_ptr(),
                                            mask.data_ptr()),
                       (xy.data_ptr() if affine else None, n, coords))
        LAUNCHES += 1
    return out, xy
