"""The hand-written CUDA kernel for the masked G2 sum
(``csrc/g2_masked_sum.cu``).

It replaces no TPU kernel: it fuses the JAX package's ``ops/curve.py``
masked_sum over Fp2 (a select by the mask, padding and a tree of Jacobian
adds with the doubling fallback), jnp code around the Pallas multiply that
XLA fuses, as ``ops/bls.py`` aggregate_sigs calls it.  Run eagerly in
PyTorch, a sum of 200 signatures is 8 levels of adds, each 10 stacked
product calls over Fp2 and the adds and selects around them; this
kernel is one launch, its tree spread over blocks (a block sums 4
leaves, and the last of a group of blocks to finish sums their partials,
by a counter in a workspace that each call allocates).  Built with the
port's other kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts the
launches.  The plain version is
``harmony_tpu_torch.ops.curve.masked_sum_reference`` over ``FP2_OPS``.
"""

import torch

from . import _build

LAUNCHES = 0
_ENTRY = "harmony_g2_masked_sum"
# the widest committee bucket (device.py COMMITTEE_BUCKETS)
MAX_POINTS = 1024
# the workspace of a sum of up to MAX_POINTS (csrc/g2_masked_sum.cu): 128
# words of counters, then 72 words for each of the 256 + 64 + 16 + 4
# partials of its first four stages
WORKSPACE_WORDS = 128 + (256 + 64 + 16 + 4) * 72
# the timed build's record (csrc/g2_masked_sum.cu Clock and Part)
PARTS = ("load", "copy", "round 1", "adds 1", "round 2", "adds 2",
         "round 3", "adds 3", "round 4", "adds 4", "round 5", "doubling",
         "result", "handoff")
CLOCK_WORDS = 4 + len(PARTS)


def g2_masked_sum(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The sum of the G2 points whose mask word is 1, as masked_sum over
    Fp2: canonical Jacobian ``points`` (N, 3, 2, 32) in the Montgomery
    domain, int32 limbs on a CUDA device, N <= 1024; ``mask`` (N,) on the
    same device, converted to int32 as masked_sum does.  Returns the
    Jacobian sum (3, 2, 32), (1, 1, 0) where nothing is selected.  One
    launch (after a memset of its workspace's counters) on the current
    stream; does not synchronise."""
    return _sum(points, mask)


def phase_clocks(points: torch.Tensor, mask: torch.Tensor) -> tuple:
    """The timed build of the kernel on the same arguments: (its sum,
    which must equal the kernel's, and an int64 tensor of CLOCK_WORDS that
    the block that wrote the sum filled: [0] the levels it ran, [1] its
    stages, [2] its SM cycles and [3] its ns from its start to the sum,
    [4 + i] the cycles of PARTS[i] summed over its levels).  Not a launch
    of the kernel: ``LAUNCHES`` does not count it."""
    clocks = torch.zeros(CLOCK_WORDS, dtype=torch.int64,
                         device=points.device)
    return _sum(points, mask, clocks), clocks


def _sum(points, mask, clocks=None):
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
    ws = torch.empty(WORKSPACE_WORDS, dtype=torch.int32, device=points.device)
    ptrs = (points.data_ptr(), mask.data_ptr(), ws.data_ptr())
    if clocks is not None:
        _build._launch(f"{_ENTRY}_phases", out, 1, ptrs + (clocks.data_ptr(),),
                       (n, WORKSPACE_WORDS))
    else:
        _build._launch(_ENTRY, out, 1, ptrs, (n, WORKSPACE_WORDS))
        LAUNCHES += 1
    return out
