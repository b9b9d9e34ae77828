"""EPoS effective-stake computation.

Behavioral parity with the reference (reference:
staking/effective/calculate.go:55-170):

- each validator's stake spreads equally over its BLS keys (truncating
  division);
- slots sort by raw stake descending (stable; validators pre-sorted by
  address for determinism), the top ``pull`` are the auction winners;
- the median raw stake of the winners bounds every winner's effective
  stake to [median*(1-c), median*(1+c)], c = 0.15 (0.35 once the
  extended-bound fork is active).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..numeric import Dec, zero_dec

C_BOUND = Dec.from_str("0.15")
C_BOUND_V2 = Dec.from_str("0.35")
_TWO = Dec.from_int(2)
_ONE = Dec.from_int(1)


@dataclass
class SlotOrder:
    """One validator's auction bid: total stake spread among its keys
    (reference: staking/effective/calculate.go SlotOrder)."""

    stake: int  # raw integer stake (atto)
    spread_among: list  # BLS pubkeys
    address: bytes = b""


@dataclass
class SlotPurchase:
    addr: bytes
    key: bytes
    raw_stake: Dec
    epos_stake: Dec


def median(purchases: list[SlotPurchase]) -> Dec:
    if not purchases:
        return zero_dec()
    ordered = sorted(
        purchases, key=lambda s: s.raw_stake.raw, reverse=True
    )
    n = len(ordered)
    if n % 2 == 0:
        left, right = ordered[n // 2 - 1], ordered[n // 2]
        return left.raw_stake.add(right.raw_stake).quo(_TWO)
    return ordered[n // 2].raw_stake


def compute(orders: dict, pull: int, exclude_keys=frozenset()):
    """(median, picks): expand orders into per-key slots, take top-``pull``
    by raw stake.  ``exclude_keys`` drops individual BLS keys from the
    auction regardless of whose order lists them — the slashed-key
    exclusion (a double-sign offender's keys must not win a slot in the
    next election even if re-registered under another order)."""
    if not orders:
        return zero_dec(), []
    slots: list[SlotPurchase] = []
    for addr in sorted(orders):  # deterministic address order
        order = orders[addr]
        spread_among = [
            k for k in order.spread_among if k not in exclude_keys
        ]
        n = len(spread_among)
        if n == 0:
            continue
        # QuoInt64 semantics: divide the raw representation, truncating
        spread = Dec(Dec.from_int(order.stake).raw // n)
        for key in spread_among:
            slots.append(
                SlotPurchase(
                    addr=addr, key=key, raw_stake=spread, epos_stake=spread
                )
            )
    slots.sort(key=lambda s: s.raw_stake.raw, reverse=True)
    picks = slots[: min(pull, len(slots))]
    if not picks:
        return zero_dec(), []
    return median(picks), picks


def effective_stake(lo: Dec, hi: Dec, actual: Dec) -> Dec:
    """clamp(actual, [lo, hi]) (reference: calculate.go:165-168)."""
    capped = hi if actual.gt(hi) else actual
    return lo if lo.gt(capped) else capped


def apply(orders: dict, pull: int, extended_bound: bool = False,
          exclude_keys=frozenset()):
    """Full EPoS round: compute winners and clamp their effective stakes."""
    med, picks = compute(orders, pull, exclude_keys)
    c = C_BOUND_V2 if extended_bound else C_BOUND
    hi = _ONE.add(c).mul(med)
    lo = _ONE.sub(c).mul(med)
    for p in picks:
        p.epos_stake = effective_stake(lo, hi, p.raw_stake)
    return med, picks
