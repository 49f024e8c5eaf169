"""Host (numpy, float64) DWT with bit-exact reference accumulation.

The parity implementation of the eegdsp fast wavelet transform (see
``eegdsp_compat``): every inner product is a sequential left-to-right
float64 fold, reproduced with ``np.cumsum``. Here it builds the cascade
operator (``ops/dwt.cascade_matrix``) by running on the identity.
"""

from __future__ import annotations

import numpy as np


def _seq_dot(block: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Sequential left-fold of sum(block * f) over the last axis."""
    return np.cumsum(block * f, axis=-1)[..., -1]


def fwt_periodic(signal: np.ndarray, h: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Full FWT over the last axis in the eegdsp coefficient layout
    ``[a_K | d_K | d_{K-1} | ... | d_1]``; decomposes while the current
    length >= len(h), indices taken mod the current length."""
    a = np.array(signal, dtype=np.float64, copy=True)
    n = a.shape[-1]
    L = len(h)
    details = []
    while n >= L:
        half = n // 2
        idx = (2 * np.arange(half)[:, None] + np.arange(L)[None, :]) % n
        block = a[..., idx]  # (..., half, L)
        details.append(_seq_dot(block, g))
        a = _seq_dot(block, h)
        n = half
    return np.concatenate([a] + details[::-1], axis=-1)
