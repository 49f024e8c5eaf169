"""Bit-exact java.util.Random + Collections.shuffle reproduction.

The reference shuffles epochs and targets with
``Collections.shuffle(list, new Random(1))`` before the 70/30 split
(PipelineBuilder.java:178-188); reproducing that split exactly
requires Java's 48-bit LCG and Fisher-Yates order, implemented here.
"""

from __future__ import annotations

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
