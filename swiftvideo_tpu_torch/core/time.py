"""Rational time arithmetic.

``TimePoint`` is the universal timestamp of the framework: a rational number
``value / scale`` held in 64-bit integers.  All media timing (pts/dts, clock
ticks, mixer windows) is expressed in TimePoints so that exact arithmetic is
possible across sample rates and frame rates without floating point drift.

Behavioral parity with the reference implementation
(``/root/reference/Sources/SwiftVideo/clock.swift:183-287``):

* ``rescale`` converts between timescales through the lcm of both scales, with
  C-style truncating division.
* ``+``/``-``/``*`` wrap around at 64 bits (Swift ``&+``/``&-``/``&*``), which
  is what makes serial-number-style timestamp rollover (RTMP extended
  timestamps) behave.
* Comparison rescales the left operand to the right operand's scale first.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd

_INT64_MASK = (1 << 64) - 1
_INT64_SIGN = 1 << 63


def _wrap64(v: int) -> int:
    """Wrap an arbitrary int into signed 64-bit two's complement."""
    v &= _INT64_MASK
    return v - (1 << 64) if v & _INT64_SIGN else v


def _tdiv(a: int, b: int) -> int:
    """C-style (truncate toward zero) integer division."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _tmod(a: int, b: int) -> int:
    """C-style remainder: sign follows the dividend."""
    return a - b * _tdiv(a, b)


def lcm64(a: int, b: int) -> int:
    g = gcd(a, b)
    # lhs / gcd &* rhs with 64-bit wrap (clock.swift:202-205)
    return _wrap64(_tdiv(a, g) * b) if g != 0 else 0


@dataclass(frozen=True, slots=True)
class TimePoint:
    """A rational instant or duration: ``value / scale`` seconds."""

    value: int
    scale: int

    def __post_init__(self) -> None:
        object.__setattr__(self, "value", _wrap64(self.value))
        object.__setattr__(self, "scale", _wrap64(self.scale))

    # --- conversions -----------------------------------------------------
    def to_string(self) -> str:
        return f"{self.value}/{self.scale}"

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TimePoint({self.value}, {self.scale})"

    # --- arithmetic (reference clock.swift:228-287) ----------------------
    def __add__(self, rhs: "TimePoint") -> "TimePoint":
        res = rescale(self, rhs.scale)
        return TimePoint(_wrap64(res.value + rhs.value), rhs.scale)

    def __sub__(self, rhs: "TimePoint") -> "TimePoint":
        res = rescale(self, rhs.scale)
        return TimePoint(_wrap64(res.value - rhs.value), rhs.scale)

    def __mul__(self, rhs: int) -> "TimePoint":
        return TimePoint(_wrap64(self.value * rhs), self.scale)

    def __truediv__(self, rhs: int) -> "TimePoint":
        return TimePoint(_tdiv(self.value, rhs), self.scale)

    def __floordiv__(self, rhs: int) -> "TimePoint":
        return TimePoint(_tdiv(self.value, rhs), self.scale)

    def __mod__(self, rhs: "TimePoint") -> "TimePoint":
        res = rescale(self, rhs.scale)
        if rhs.value != 0:
            return TimePoint(_tmod(res.value, rhs.value), rhs.scale)
        return TimePoint(0, rhs.scale)

    def __neg__(self) -> "TimePoint":
        return TimePoint(_wrap64(-self.value), self.scale)

    # --- comparison ------------------------------------------------------
    def __gt__(self, rhs: "TimePoint") -> bool:
        return rescale(self, rhs.scale).value > rhs.value

    def __lt__(self, rhs: "TimePoint") -> bool:
        return rescale(self, rhs.scale).value < rhs.value

    def __ge__(self, rhs: "TimePoint") -> bool:
        return not (self < rhs)

    def __le__(self, rhs: "TimePoint") -> bool:
        return not (self > rhs)

    def __eq__(self, rhs: object) -> bool:
        if not isinstance(rhs, TimePoint):
            return NotImplemented
        return rescale(self, rhs.scale).value == rhs.value

    def __hash__(self) -> int:
        s = simplify(self)
        return hash((s.value, s.scale))


def from_seconds(sec: float, scale: int = 100000) -> TimePoint:
    """TimePoint(Double) convenience init (clock.swift:188-191)."""
    return TimePoint(int(sec * scale), scale)


def rescale(time: TimePoint, scale: int) -> TimePoint:
    """Re-express ``time`` in a new timescale (clock.swift:216-226)."""
    if time.scale != scale and scale > 0 and time.scale > 0:
        cscale = lcm64(scale, time.scale)
        lmul = _tdiv(cscale, time.scale)
        rmul = _tdiv(cscale, scale)
        num = _tdiv(_wrap64(lmul * time.value), rmul if rmul != 0 else 1)
        return TimePoint(num, scale)
    return time


def simplify(time: TimePoint) -> TimePoint:
    g = gcd(time.value, time.scale)
    if g == 0:
        return time
    return TimePoint(_tdiv(time.value, g), _tdiv(time.scale, g))


def seconds(time: TimePoint) -> float:
    return float(time.value) / float(time.scale)


fseconds = seconds


def minimum(lhs: TimePoint, rhs: TimePoint) -> TimePoint:
    return lhs if lhs < rhs else rhs


def maximum(lhs: TimePoint, rhs: TimePoint) -> TimePoint:
    return lhs if lhs > rhs else rhs


def clamp_time(val: TimePoint, low: TimePoint, high: TimePoint) -> TimePoint:
    return minimum(maximum(val, low), high)
