"""Host-side conversions between the bigint reference representation and
the batched limb tensors (Montgomery domain) used by ops/.

They run on the host at the API boundary (key loading, hashed payloads,
signatures) and in tests, and return int32 CPU tensors; callers move them
to the device.
"""

import numpy as np
import torch

from ..ref.params import P
from .limbs import int_to_limbs, limbs_to_int

R_MONT = 1 << 384


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def fp_to_arr(a: int, mont: bool = True) -> torch.Tensor:
    return torch.from_numpy(int_to_limbs(a * R_MONT % P if mont else a % P))


def arr_to_fp(arr, mont: bool = True) -> int:
    v = limbs_to_int(_host(arr))
    return v * pow(R_MONT, -1, P) % P if mont else v


def fp2_to_arr(a, mont: bool = True) -> torch.Tensor:
    return torch.stack([fp_to_arr(a[0], mont), fp_to_arr(a[1], mont)])


def arr_to_fp2(arr, mont: bool = True):
    arr = _host(arr)
    return (arr_to_fp(arr[..., 0, :], mont), arr_to_fp(arr[..., 1, :], mont))


def fp6_to_arr(a, mont: bool = True) -> torch.Tensor:
    return torch.stack([fp2_to_arr(c, mont) for c in a])


def arr_to_fp6(arr, mont: bool = True):
    arr = _host(arr)
    return tuple(arr_to_fp2(arr[i], mont) for i in range(3))


def fp12_to_arr(a, mont: bool = True) -> torch.Tensor:
    return torch.stack([fp6_to_arr(c, mont) for c in a])


def arr_to_fp12(arr, mont: bool = True):
    arr = _host(arr)
    return tuple(arr_to_fp6(arr[i], mont) for i in range(2))


def batch(fn, items) -> torch.Tensor:
    """Stack converted items along a leading batch axis."""
    return torch.stack([fn(x) for x in items])


# --- points ----------------------------------------------------------------


def g1_affine_to_arr(pt) -> torch.Tensor:
    """Reference affine G1 point -> (2, 32) affine mont tensor."""
    return torch.stack([fp_to_arr(pt[0]), fp_to_arr(pt[1])])


def g2_affine_to_arr(pt) -> torch.Tensor:
    """Reference affine G2 point -> (2, 2, 32) affine mont tensor."""
    return torch.stack([fp2_to_arr(pt[0]), fp2_to_arr(pt[1])])


def g1_batch_affine(pts) -> torch.Tensor:
    """List of affine G1 points -> (N, 2, 32)."""
    return torch.stack([g1_affine_to_arr(p) for p in pts])


def g2_batch_affine(pts) -> torch.Tensor:
    return torch.stack([g2_affine_to_arr(p) for p in pts])


def g1_affine_to_jacobian_arr(pt) -> torch.Tensor:
    """Reference affine G1 point (or None) -> (3, 32) Jacobian mont tensor."""
    if pt is None:
        # canonical infinity: (1, 1, 0) in Montgomery form
        return torch.stack([fp_to_arr(1), fp_to_arr(1), fp_to_arr(0)])
    return torch.stack([fp_to_arr(pt[0]), fp_to_arr(pt[1]), fp_to_arr(1)])


def g2_affine_to_jacobian_arr(pt) -> torch.Tensor:
    """Reference affine G2 point (or None) -> (3, 2, 32) Jacobian mont."""
    if pt is None:
        one = (1, 0)
        return torch.stack(
            [fp2_to_arr(one), fp2_to_arr(one), fp2_to_arr((0, 0))])
    return torch.stack(
        [fp2_to_arr(pt[0]), fp2_to_arr(pt[1]), fp2_to_arr((1, 0))]
    )


def _jacobian_to_affine(x, y, z, is_fp2: bool):
    if z == 0 or z == (0, 0):
        return None
    from ..ref import fields as F

    if is_fp2:
        zi = F.fp2_inv(z)
        zi2 = F.fp2_mul(zi, zi)
        return (F.fp2_mul(x, zi2), F.fp2_mul(y, F.fp2_mul(zi2, zi)))
    zi = F.fp_inv(z)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 % P * zi % P)


def arr_to_g1_affine(arr):
    arr = _host(arr)
    x = arr_to_fp(arr[..., 0, :])
    y = arr_to_fp(arr[..., 1, :])
    z = arr_to_fp(arr[..., 2, :])
    return _jacobian_to_affine(x, y, z, is_fp2=False)


def arr_to_g2_affine(arr):
    arr = _host(arr)
    x = arr_to_fp2(arr[..., 0, :, :])
    y = arr_to_fp2(arr[..., 1, :, :])
    z = arr_to_fp2(arr[..., 2, :, :])
    return _jacobian_to_affine(x, y, z, is_fp2=True)

