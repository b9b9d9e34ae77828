"""Limb representation helpers: Python/NumPy side.

381-bit field elements are stored as 32 little-endian limbs of 12 bits in
int32, the boundary format the port shares with the JAX package: every
partial product (< 2^24) and every 32-term accumulator (< 2^31) stays
inside int32.
"""

import numpy as np

LIMB_BITS = 12
N_LIMBS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
assert LIMB_BITS * N_LIMBS == 384  # covers 381-bit p with 3 spare bits


def int_to_limbs(x: int) -> np.ndarray:
    """Convert a nonnegative Python int (< 2^384) to limb form."""
    if x < 0 or x >> 384:
        raise ValueError("limb conversion requires 0 <= x < 2^384")
    return np.array(
        [(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(N_LIMBS)],
        dtype=np.int32,
    )


def limbs_to_int(limbs) -> int:
    """Convert limb form back to a Python int (host-side, for tests/IO).

    Accepts any integer dtype and non-canonical (lazy) limbs.
    """
    arr = np.asarray(limbs)
    assert arr.shape[-1] == N_LIMBS
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(arr.tolist()))


def ints_to_limbs(xs) -> np.ndarray:
    """Vectorized int_to_limbs: list of ints -> (len, N_LIMBS) int32."""
    return np.stack([int_to_limbs(x) for x in xs])
