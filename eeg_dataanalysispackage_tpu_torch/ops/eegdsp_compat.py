"""Reverse-engineered eegdsp discrete-wavelet filter registry.

The reference's feature extractor delegates to the closed-source
``eegdsp`` jar (WaveletTransform.java:108-136). The convention,
identified numerically from the reference's golden checksum
(``FeatureExtractionTest.java:106``):

- registry index ``8`` ("dwt-8") is the 10-tap Daubechies filter in the
  classic 12-decimal-digit truncated table (Daubechies, "Ten Lectures",
  Table 6.1, N=5), ascending order h0..h9;
- wavelet filter: g[j] = -(-1)^j h[L-1-j];
- per level, on the current prefix of length n:
  a[i] = sum_j h[j] * x[(2i+j) mod n], d[i] = sum_j g[j] * x[(2i+j) mod n];
- decompose while n >= len(h), leaving [a6 | d6 | d5 | ...] for n = 512.

Index i maps to the (i+2)-tap Daubechies filter; odd tap counts do not
exist (WaveletTransform.java:114-119). Only index 8 is pinned by a
golden checksum; the other even indices use the same 12-digit
truncation applied to spectral-factorization values.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np

from . import daubechies

# The golden-pinned 10-tap table (index 8), 12 decimal digits exactly
# as the printed tables give them.
DAUB10_H = np.array(
    [
        0.160102397974,
        0.603829269797,
        0.724308528438,
        0.138428145901,
        -0.242294887066,
        -0.032244869585,
        0.077571493840,
        -0.006241490213,
        -0.012580751999,
        0.003335725285,
    ],
    dtype=np.float64,
)

NUM_WAVELETS = 18  # registry indices 0..17 (WaveletTransform.java:161)


def wavelet_name(index: int) -> str:
    return f"Daubechies{index + 2}"


@lru_cache(maxsize=None)
def scaling_filter(index: int) -> np.ndarray:
    """Scaling filter for registry ``index`` (0..17), textbook order.

    Raises ValueError for indices whose tap count is odd.
    """
    if not 0 <= index < NUM_WAVELETS:
        raise ValueError("Wavelet Name must be >= 0 and <= 17")
    taps = index + 2
    if taps % 2:
        raise ValueError(
            f"Exception loading wavelet {wavelet_name(index)}: "
            f"no Daubechies filter with an odd tap count ({taps})"
        )
    if index == 8:
        return DAUB10_H
    h = daubechies.daubechies_scaling(taps // 2)[::-1]
    # same 12-decimal truncation rule as the printed tables
    return np.round(h, 12)


def wavelet_filter(h: np.ndarray) -> np.ndarray:
    """g[j] = -(-1)^j h[L-1-j] (the identified eegdsp convention)."""
    L = len(h)
    signs = np.array([(-1.0) ** (k + 1) for k in range(L)])
    return signs * h[::-1]


def filter_pair(index: int) -> Tuple[np.ndarray, np.ndarray]:
    h = scaling_filter(index)
    return h, wavelet_filter(h)
