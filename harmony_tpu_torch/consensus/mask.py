"""Participation bitmap over a committee of BLS public keys.

Behavioral parity with the reference's cosigning Mask (reference:
crypto/bls/mask.go:67-196): little-endian bit order (bit i of the bitmap
is bit i&7 of byte i>>3), length-checked SetMask, per-bit enable/disable,
signer extraction.

Device-first redesign: the reference maintains AggregatePublic
incrementally with a G1 Add/Sub per bit flip across the cgo boundary
(mask.go:113-153).  Here the committee lives as ONE device-resident
tensor and the aggregate is a single masked tree-sum on the device (one
``g1_masked_sum`` launch on the card) — O(log N) depth instead of N
sequential cgo calls, recomputed on demand (bit flips are cheap
bookkeeping).  The port's copy of the JAX package's ``consensus/mask.py``.
"""

from __future__ import annotations

import numpy as np

from ..ref import bls as RB
from ..ref import curve as RC


def bits_from_bytes(bitmap: bytes, n: int):
    """Unpack a little-endian participation bitmap to a 0/1 list — THE
    bit-order convention of the whole protocol (bit i = bit i&7 of byte
    i>>3; reference: crypto/bls/mask.go:112-120).  A bitmap too short
    for n raises ValueError (never IndexError — callers catch
    ValueError on untrusted input)."""
    if len(bitmap) < (n + 7) >> 3:
        raise ValueError(
            f"bitmap of {len(bitmap)} bytes cannot cover {n} bits"
        )
    return [(bitmap[i >> 3] >> (i & 7)) & 1 for i in range(n)]


class Mask:
    """Committee bitmap with device-backed aggregation.

    ``publics`` is a list of affine G1 pubkeys (reference tuples).  The
    device tensor is built lazily on first aggregate call and cached.
    """

    def __init__(self, publics):
        self.publics = list(publics)
        self.bitmap = bytearray(self.bytes_len())
        self._device_pks = [None]  # one-slot device-tensor cache
        self._index = {}
        for i, pk in enumerate(self.publics):
            key = RB.pubkey_to_bytes(pk)
            self._index.setdefault(key, i)

    # --- shape ---
    def __len__(self) -> int:
        return len(self.publics)

    def bytes_len(self) -> int:
        return (len(self.publics) + 7) >> 3

    # --- bit ops (little-endian order, mask.go:112-153) ---
    def _check(self, i: int):
        if not 0 <= i < len(self.publics):
            raise IndexError("mask index out of range")

    def bit(self, i: int) -> bool:
        self._check(i)
        return bool(self.bitmap[i >> 3] & (1 << (i & 7)))

    def set_bit(self, i: int, enable: bool):
        self._check(i)
        byte, bit = i >> 3, 1 << (i & 7)
        if enable:
            self.bitmap[byte] |= bit
        else:
            self.bitmap[byte] &= ~bit

    def set_key(self, pubkey_bytes: bytes, enable: bool):
        """Enable/disable by serialized pubkey (mask.go SetKey)."""
        if pubkey_bytes not in self._index:
            raise KeyError("pubkey not in committee")
        self.set_bit(self._index[pubkey_bytes], enable)

    def set_mask(self, mask_bytes: bytes):
        """Replace the bitmap; length must match exactly (mask.go:113-120)."""
        if len(mask_bytes) != self.bytes_len():
            raise ValueError(
                f"mismatching bitmap lengths: expected {self.bytes_len()}, "
                f"got {len(mask_bytes)}"
            )
        self.bitmap = bytearray(mask_bytes)

    def clear(self):
        self.bitmap = bytearray(self.bytes_len())

    def mask_bytes(self) -> bytes:
        return bytes(self.bitmap)

    def count_enabled(self) -> int:
        return sum(self.bit(i) for i in range(len(self.publics)))

    def index_enabled(self):
        return [i for i in range(len(self.publics)) if self.bit(i)]

    def get_signed_pubkeys(self):
        """Enabled pubkeys (mask.go GetSignedPubKeysFromBitmap)."""
        return [self.publics[i] for i in self.index_enabled()]

    def bit_vector(self) -> np.ndarray:
        return np.array(
            [1 if self.bit(i) else 0 for i in range(len(self.publics))],
            dtype=np.int32,
        )

    # --- aggregation ---
    def aggregate_public(self, device: bool = True):
        """The masked aggregate public key, as a reference affine point.

        device=True runs the masked tree-sum on the device through
        ``device.masked_pubkey_sum`` (breaker-guarded, with this mask's
        one-slot cache of the key table); False uses the host path (both
        give the same point).  With the twins active off the card
        (``device.kernel_twin_active``) the host path runs even when a
        caller asks for the device, as in the JAX package."""
        from .. import device as DV

        if (not device or DV.kernel_twin_active()
                or len(self.publics) == 0):
            # native Jacobian sum when available, affine bigint otherwise
            return RB.aggregate_pubkeys(self.get_signed_pubkeys())
        return DV.masked_pubkey_sum(
            self.publics, self.bit_vector(),
            lambda: RB.aggregate_pubkeys(self.get_signed_pubkeys()),
            cache=self._device_pks,
        )
