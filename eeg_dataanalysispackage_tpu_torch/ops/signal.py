"""Signal-processing utilities (reference: Utils/SignalProcessing.java).

Port of the JAX package's ``ops/signal.py``, in float64 numpy:

- :func:`decimate`: stride subsampling, ``output[i] = input[i*factor]``
  (SignalProcessing.java:29-36);
- :func:`normalize`: the reference's in-place L2 divide
  (SignalProcessing.java:38-52), the bit-exact sequential host form
  ``ops.dwt_host.l2_normalize_seq``; the guarded device form is
  ``ops.dwt.safe_l2_normalize`` (both re-exported);
- :func:`bandpass_mask` and :func:`fft_bandpass`: the rfft-mask-irfft
  band-pass of the streaming front end (``parallel/streaming.py`` folds
  the mask into its cascade matrix).
"""

from __future__ import annotations

import numpy as np

from .dwt import safe_l2_normalize
from .dwt_host import l2_normalize_seq

__all__ = [
    "decimate",
    "normalize",
    "l2_normalize_seq",
    "safe_l2_normalize",
    "bandpass_mask",
    "fft_bandpass",
]


def bandpass_mask(n: int, fs: float, low: float, high: float) -> np.ndarray:
    """rfft-domain 0/1 mask keeping [low, high] Hz (inclusive edges)."""
    freqs = np.fft.rfftfreq(n, d=1.0 / fs)
    return ((freqs >= low) & (freqs <= high)).astype(np.float32)


def decimate(signal: np.ndarray, factor: int) -> np.ndarray:
    """Stride subsample over the last axis: keep every ``factor``-th
    sample, output length ``n // factor`` (SignalProcessing.java:29-36)."""
    if factor < 1:
        raise ValueError(f"decimation factor must be >= 1, got {factor}")
    n = signal.shape[-1] // factor
    return signal[..., : n * factor : factor]


def normalize(features: np.ndarray) -> np.ndarray:
    """L2-normalize over the last axis with the reference's exact
    arithmetic (alias of :func:`l2_normalize_seq`)."""
    return l2_normalize_seq(np.asarray(features, dtype=np.float64))


def fft_bandpass(signal, fs: float, low: float, high: float, axis: int = -1) -> np.ndarray:
    """Zero the rfft bins outside [low, high] Hz over ``axis``, in float64,
    returned in the signal's dtype."""
    x = np.asarray(signal)
    n = x.shape[axis]
    mask = bandpass_mask(n, fs, low, high)
    shape = [1] * x.ndim
    shape[axis] = mask.size
    spec = np.fft.rfft(x.astype(np.float64), axis=axis) * mask.reshape(shape)
    return np.fft.irfft(spec, n=n, axis=axis).astype(x.dtype)
