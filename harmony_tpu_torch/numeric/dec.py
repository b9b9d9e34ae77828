"""18-decimal fixed-point arithmetic for vote-power math.

Behavioral equivalent of the reference's cosmos-style ``numeric.Dec``
(reference: numeric/decimal.go:51-114): values are integers scaled by
10^18; Mul/Quo chop back to 18 decimals with banker's rounding
(round-half-to-even, reference: numeric/decimal.go chopPrecisionAndRound);
Truncate variants chop toward zero.

Quorum decisions must be bitwise-deterministic across nodes, so this math
stays on the host in exact integers and is never lowered to device floats
(SURVEY.md §2.4 note on numeric).  The port's copy of the JAX package's
``numeric/dec.py``.
"""

from __future__ import annotations

PRECISION = 18
_UNIT = 10**PRECISION
_HALF = 5 * 10 ** (PRECISION - 1)


def _chop_round(x: int) -> int:
    """Divide by 10^18 with banker's rounding (round half to even)."""
    if x < 0:
        return -_chop_round(-x)
    quo, rem = divmod(x, _UNIT)
    if rem < _HALF:
        return quo
    if rem > _HALF:
        return quo + 1
    return quo if quo % 2 == 0 else quo + 1


def _chop_trunc(x: int) -> int:
    if x < 0:
        return -(-x // _UNIT)
    return x // _UNIT


class Dec:
    """Immutable fixed-point decimal: value = raw / 10^18."""

    __slots__ = ("raw",)

    def __init__(self, raw: int):
        self.raw = raw

    # --- constructors ---
    @classmethod
    def from_int(cls, i: int) -> "Dec":
        return cls(i * _UNIT)

    @classmethod
    def from_str(cls, s: str) -> "Dec":
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        if "." in s:
            whole, frac = s.split(".", 1)
            if len(frac) > PRECISION:
                raise ValueError("too many decimal places")
            frac = frac.ljust(PRECISION, "0")
        else:
            whole, frac = s, "0" * PRECISION
        raw = int(whole or "0") * _UNIT + int(frac)
        return cls(-raw if neg else raw)

    @classmethod
    def with_prec(cls, i: int, prec: int) -> "Dec":
        if not 0 <= prec <= PRECISION:
            raise ValueError("precision out of range")
        return cls(i * 10 ** (PRECISION - prec))

    # --- arithmetic ---
    def add(self, o: "Dec") -> "Dec":
        return Dec(self.raw + o.raw)

    def sub(self, o: "Dec") -> "Dec":
        return Dec(self.raw - o.raw)

    def mul(self, o: "Dec") -> "Dec":
        return Dec(_chop_round(self.raw * o.raw))

    def mul_truncate(self, o: "Dec") -> "Dec":
        return Dec(_chop_trunc(self.raw * o.raw))

    def mul_int(self, i: int) -> "Dec":
        return Dec(self.raw * i)

    def quo(self, o: "Dec") -> "Dec":
        # multiply precision twice, truncate-divide, then chop+round
        num = self.raw * _UNIT * _UNIT
        q = abs(num) // abs(o.raw)
        if (num < 0) != (o.raw < 0):
            q = -q
        return Dec(_chop_round(q))

    def quo_truncate(self, o: "Dec") -> "Dec":
        num = self.raw * _UNIT * _UNIT
        q = abs(num) // abs(o.raw)
        if (num < 0) != (o.raw < 0):
            q = -q
        return Dec(_chop_trunc(q))

    def neg(self) -> "Dec":
        return Dec(-self.raw)

    # --- comparisons / predicates ---
    def cmp(self, o: "Dec") -> int:
        return (self.raw > o.raw) - (self.raw < o.raw)

    def gt(self, o: "Dec") -> bool:
        return self.raw > o.raw

    def gte(self, o: "Dec") -> bool:
        return self.raw >= o.raw

    def lt(self, o: "Dec") -> bool:
        return self.raw < o.raw

    def lte(self, o: "Dec") -> bool:
        return self.raw <= o.raw

    def equal(self, o: "Dec") -> bool:
        return self.raw == o.raw

    def is_zero(self) -> bool:
        return self.raw == 0

    def is_negative(self) -> bool:
        return self.raw < 0

    # --- conversions ---
    def truncate_int(self) -> int:
        return _chop_trunc(self.raw)

    def round_int(self) -> int:
        return _chop_round(self.raw)

    def __repr__(self) -> str:
        sign = "-" if self.raw < 0 else ""
        whole, frac = divmod(abs(self.raw), _UNIT)
        return f"{sign}{whole}.{str(frac).zfill(PRECISION)}"

    def __eq__(self, o) -> bool:
        return isinstance(o, Dec) and self.raw == o.raw

    def __hash__(self):
        return hash(self.raw)


def zero_dec() -> Dec:
    return Dec(0)


def one_dec() -> Dec:
    return Dec(_UNIT)


def new_dec(i: int) -> Dec:
    return Dec.from_int(i)
