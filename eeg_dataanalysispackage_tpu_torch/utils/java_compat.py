"""Bit-exact java.util.Random + Collections.shuffle reproduction, and
``Double.toString`` number formatting.

The reference shuffles epochs and targets with
``Collections.shuffle(list, new Random(1))`` before the 70/30 split
(PipelineBuilder.java:178-188); reproducing that split exactly
requires Java's 48-bit LCG and Fisher-Yates order, implemented here.
"""

from __future__ import annotations

import math
from typing import List, TypeVar

T = TypeVar("T")

_MULT = 0x5DEECE66D
_ADD = 0xB
_MASK = (1 << 48) - 1


class JavaRandom:
    """java.util.Random: 48-bit linear congruential generator."""

    def __init__(self, seed: int):
        self.seed = (seed ^ _MULT) & _MASK

    def _next(self, bits: int) -> int:
        self.seed = (self.seed * _MULT + _ADD) & _MASK
        # callers only use bits <= 31, so the value is non-negative
        return self.seed >> (48 - bits)

    def next_int(self, bound: int) -> int:
        if bound <= 0:
            raise ValueError("bound must be positive")
        if (bound & -bound) == bound:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            if bits - val + (bound - 1) < (1 << 31):
                return val


def java_shuffle(items: List[T], seed: int) -> List[T]:
    """Collections.shuffle(list, new Random(seed)) — returns a new list.

    Fisher-Yates from the top: for i = n-1 .. 1, swap(i, rnd.nextInt(i+1)).
    """
    rnd = JavaRandom(seed)
    out = list(items)
    for i in range(len(out) - 1, 0, -1):
        j = rnd.next_int(i + 1)
        out[i], out[j] = out[j], out[i]
    return out


def java_shuffle_indices(n: int, seed: int) -> List[int]:
    """Permutation such that shuffled[k] = original[perm[k]]."""
    return java_shuffle(list(range(n)), seed)


def train_test_split_indices(n: int, seed: int = 1, train_frac: float = 0.7):
    """The reference's shuffle + subList split (PipelineBuilder.java:178-188).

    Returns (train_idx, test_idx) into the *original* epoch order.
    """
    perm = java_shuffle_indices(n, seed)
    cut = int(n * train_frac)
    return perm[:cut], perm[cut:]


def java_double_to_string(value: float) -> str:
    """``Double.toString(double)`` formatting (Double.java docs).

    Decimal form for 1e-3 <= |d| < 1e7 (always one digit after the
    point at least), otherwise ``D.DDDE±X`` with an uppercase bare-sign
    exponent; specials are ``NaN`` / ``Infinity`` / ``-0.0``. Digits come
    from Python's shortest-roundtrip repr, which is modern (JDK >= 19)
    ``Double.toString`` digit selection.
    """
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    sign = "-" if math.copysign(1.0, v) < 0 else ""
    a = abs(v)
    if a == 0.0:
        return sign + "0.0"
    r = repr(a)
    if "e" in r:
        mant, _, exp_s = r.partition("e")
        exp = int(exp_s)
    else:
        mant, exp = r, 0
    int_part, _, frac = mant.partition(".")
    digits = int_part + frac
    point = len(int_part) + exp  # the decimal point's position in digits
    stripped = digits.lstrip("0")
    point -= len(digits) - len(stripped)
    digits = stripped.rstrip("0") or "0"
    if -3 < point <= 7:  # 1e-3 <= a < 1e7
        if point <= 0:
            return f"{sign}0.{'0' * -point}{digits}"
        if point >= len(digits):
            return f"{sign}{digits}{'0' * (point - len(digits))}.0"
        return f"{sign}{digits[:point]}.{digits[point:]}"
    return f"{sign}{digits[0]}.{digits[1:] or '0'}E{point - 1}"
