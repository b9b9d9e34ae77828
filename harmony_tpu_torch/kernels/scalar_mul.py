"""The hand-written CUDA kernels for scalar multiplication in G1 and G2
(``csrc/scalar_mul.cu``: ``scalar_mul_g1`` and ``scalar_mul_g2``).

They replace no TPU kernel: they fuse the JAX package's ``ops/curve.py``
scalar_mul (a scan of dbl, add and a select by the bit, jnp code around
the Pallas multiply that XLA fuses).  Run eagerly in PyTorch, each of a
signature's 255 steps is 10 stacked product calls over Fp2 and the adds
and selects around them; each kernel runs the whole ladder in one
launch, in constant time (the bits are secret keys).  Built with the
port's other kernels by ``kernels/_build.py``.  ``LAUNCHES`` counts the
launches of each.  The plain version is
``harmony_tpu_torch.ops.curve.scalar_mul_reference``.
"""

import math

import torch

from . import _build

LAUNCHES = {"scalar_mul_g1": 0, "scalar_mul_g2": 0}
# the timed build's record (csrc/scalar_mul.cu kMaxPhases and Clock)
MAX_PHASES = 24
CLOCK_WORDS = 4 + 2 * MAX_PHASES
_TAILS = {"scalar_mul_g1": _build.G1_JACOBIAN,
          "scalar_mul_g2": _build.G2_JACOBIAN}


def scalar_mul_g1(points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """k P in G1 for Jacobian points (..., 3, 32): see ``_scalar_mul``."""
    return _scalar_mul("scalar_mul_g1", points, bits)


def scalar_mul_g2(points: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """k Q in the G2 twist for Jacobian points (..., 3, 2, 32): see
    ``_scalar_mul``."""
    return _scalar_mul("scalar_mul_g2", points, bits)


def phase_clocks(name: str, points: torch.Tensor,
                 bits: torch.Tensor) -> tuple:
    """The timed build of ``name``'s kernel (``scalar_mul_g1`` or
    ``scalar_mul_g2``) on the same arguments: (its result, which must
    equal the kernel's, and an int64 tensor of CLOCK_WORDS that block 0
    filled: [0] phases a step, [1] steps, [2] the ladder's SM cycles, [3]
    its ns, [4 + i] the cycles of phase i summed over the steps, [4 +
    MAX_PHASES + i] its tasks, plus 65536 for a round of products).  Not
    a launch of the kernel: ``LAUNCHES`` does not count it."""
    clocks = torch.zeros(CLOCK_WORDS, dtype=torch.int64,
                         device=points.device)
    return _scalar_mul(name, points, bits, clocks), clocks


def _scalar_mul(name, points, bits, clocks=None):
    """The double-and-add of curve.py scalar_mul: canonical Jacobian
    ``points`` in the Montgomery domain, int32 limbs on a CUDA device;
    ``bits`` MSB first, (L,) for every point or (..., L) with the points'
    leading axes, on the same device, converted to int32 as scalar_mul
    does (a step adds where its bit is 1).  Returns Jacobian points of
    the points' shape, (1, 1, 0) for L = 0.  One block per point (fewer
    than 2^31); launches on the current stream and does not
    synchronise.  With ``clocks`` (``phase_clocks``) it launches the timed
    build instead, which fills them."""
    tail = _TAILS[name]
    if points.dtype is not torch.int32:
        raise TypeError(f"{name} takes int32 points, got {points.dtype}")
    lead = points.shape[:points.dim() - len(tail)]
    if (not points.is_cuda or not bits.is_cuda
            or points.get_device() != bits.get_device()
            or not _build._takes(points, tail)
            or bits.dim() == 0
            or (bits.dim() > 1 and bits.shape[:-1] != lead)):
        raise ValueError(
            f"{name} takes points (..., {', '.join(map(str, tail))}) with "
            f"bits (L,) or (..., L) on one CUDA device; got "
            f"{tuple(points.shape)} on {points.device} and "
            f"{tuple(bits.shape)} on {bits.device}")
    shared = int(bits.dim() == 1)
    points = _build._ready(points)
    bits = _build._ready(bits.to(torch.int32))
    out = torch.empty_like(points)
    lanes = math.prod(lead)
    if lanes and clocks is not None:
        _build._launch(f"harmony_{name}_phases", out, lanes,
                       (points.data_ptr(), bits.data_ptr(),
                        clocks.data_ptr()), (bits.shape[-1], shared))
    elif lanes:
        _build._launch(f"harmony_{name}", out, lanes,
                       (points.data_ptr(), bits.data_ptr()),
                       (bits.shape[-1], shared))
        LAUNCHES[name] += 1
    return out
