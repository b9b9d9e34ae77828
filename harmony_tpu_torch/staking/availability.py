"""Validator availability accounting.

Behavioral parity with the reference (reference:
staking/availability/measure.go):

- BlockSigners: split a committee by a header's participation bitmap into
  (signed, missing) — the per-block bookkeeping input (measure.go:40);
- signing counters increment per block for members, per signer for signed
  (measure.go:129-139);
- a validator whose signing ratio is <= 2/3 over the measuring period is
  below threshold and goes inactive (measure.go:18, 141-233).

The port's copy of the JAX package's ``staking/availability.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..numeric import Dec, new_dec

SIGNING_THRESHOLD = new_dec(2).quo(new_dec(3))  # measure.go:18


def block_signers(bitmap: bytes, committee_keys: list):
    """(signed, missing) key lists for one block's participation bitmap
    (little-endian bit order, matching the consensus Mask)."""
    if len(bitmap) != (len(committee_keys) + 7) >> 3:
        raise ValueError("bitmap length mismatch")
    from ..consensus.mask import bits_from_bytes

    bits = bits_from_bytes(bitmap, len(committee_keys))
    signed = [k for k, b in zip(committee_keys, bits) if b]
    missing = [k for k, b in zip(committee_keys, bits) if not b]
    return signed, missing


@dataclass
class Counters:
    """reference: staking ValidatorWrapper.Counters."""

    num_blocks_to_sign: int = 0
    num_blocks_signed: int = 0


def increment_counts(
    counters_by_addr: dict, signed_addrs, member_addrs
) -> None:
    """Per-block increment (measure.go:129-139): every committee member's
    to-sign grows; signers' signed grows."""
    for a in member_addrs:
        counters_by_addr.setdefault(a, Counters()).num_blocks_to_sign += 1
    for a in signed_addrs:
        counters_by_addr.setdefault(a, Counters()).num_blocks_signed += 1


@dataclass
class Computed:
    signed: int
    to_sign: int
    percentage: Dec
    is_below_threshold: bool


def compute_current_signing(
    snapshot: Counters, current: Counters
) -> Computed:
    """Signing ratio over the measuring window = current - snapshot
    (measure.go:141-176)."""
    signed = current.num_blocks_signed - snapshot.num_blocks_signed
    to_sign = current.num_blocks_to_sign - snapshot.num_blocks_to_sign
    if signed < 0 or to_sign < 0:
        raise ValueError("counter went backwards: corrupt snapshot")
    if to_sign == 0:
        return Computed(0, 0, new_dec(0), False)
    pct = new_dec(signed).quo(new_dec(to_sign))
    return Computed(signed, to_sign, pct, is_below_signing_threshold(pct))


def is_below_signing_threshold(quotient: Dec) -> bool:
    """<= 2/3 is failing (measure.go:178-181 uses LTE)."""
    return quotient.lte(SIGNING_THRESHOLD)
