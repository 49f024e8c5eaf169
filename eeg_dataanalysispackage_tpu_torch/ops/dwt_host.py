"""Host (numpy, float64) DWT with bit-exact reference accumulation.

The parity implementation of the eegdsp fast wavelet transform (see
``eegdsp_compat``): every inner product is a sequential left-to-right
float64 fold, reproduced with ``np.cumsum``. It is what ``fe=dwt-8``
(the reference-parity feature mode) computes, and it builds the cascade
operator (``ops/dwt.cascade_matrix``) by running on the identity.
"""

from __future__ import annotations

import numpy as np

from . import eegdsp_compat


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


def dwt_coefficients(
    signal: np.ndarray, wavelet_index: int = 8, count: int = 16
) -> np.ndarray:
    """First ``count`` entries of the eegdsp coefficient layout — the
    reference's ``getDwtCoefficients()[0:FEATURE_SIZE]``."""
    h, g = eegdsp_compat.filter_pair(wavelet_index)
    return fwt_periodic(signal, h, g)[..., :count]


def l2_normalize_seq(features: np.ndarray) -> np.ndarray:
    """L2-normalize over the last axis with the reference's exact
    arithmetic: sequential sum of squares, sqrt, elementwise divide
    (SignalProcessing.java:38-52). An all-zero row gives Java's 0/0 ->
    NaN; the device paths guard it instead (``ops/dwt.safe_l2_normalize``)."""
    sumsq = np.cumsum(features * features, axis=-1)[..., -1]
    return features / np.sqrt(sumsq)[..., None]
