"""Marker-window validity and the reference's class-balance scan.

The fused path cuts windows on the card, so the host keeps only the
metadata half of ``OffLineDataProvider.processEEGFiles``
(OffLineDataProvider.java:200-265): which windows exist, and the
order-dependent target/non-target balance scan that decides which of
them are kept.
"""

from __future__ import annotations

import numpy as np


def valid_window_starts(
    positions: np.ndarray, pre: int, n_samples: int
) -> np.ndarray:
    """Boolean validity of ``[pos-pre, pos+post)`` windows.

    Java's Arrays.copyOfRange(arr, from, to) throws only when
    from < 0 or from > arr.length; a ``to`` beyond the end ZERO-PADS.
    So windows starting in-range but running past the end are kept,
    zero-padded — only windows starting before 0 or after the end are
    dropped (the reference's swallowed AIOOBE,
    OffLineDataProvider.java:262-264).
    """
    positions = np.asarray(positions, dtype=np.int64)
    return (positions - pre >= 0) & (positions - pre <= n_samples)


class BalanceState:
    """The reference's sequential class-balance filter.

    A target epoch is kept only while ``n_targets <= n_nontargets``; a
    non-target only while ``n_targets >= n_nontargets``
    (OffLineDataProvider.java:248-260). Order-dependent by design. The
    counters span all files of an info.txt run
    (OffLineDataProvider.java:58-59), so balancing is global over the
    whole run and the provider must keep the info.txt order.
    """

    def __init__(self) -> None:
        self.n_targets = 0
        self.n_nontargets = 0

    def scan(self, is_target: np.ndarray) -> np.ndarray:
        keep = np.zeros(len(is_target), dtype=bool)
        for i, t in enumerate(is_target):
            if t and self.n_targets <= self.n_nontargets:
                keep[i] = True
                self.n_targets += 1
            elif not t and self.n_targets >= self.n_nontargets:
                keep[i] = True
                self.n_nontargets += 1
        return keep
