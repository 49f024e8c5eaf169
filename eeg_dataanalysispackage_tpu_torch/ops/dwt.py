"""The eegdsp FWT as one contraction, in PyTorch.

The 6-level cascade is linear, so its first ``count`` coefficients
compose into one (n, count) matrix (:func:`cascade_matrix`); features
are that matrix applied to the analysis window, then L2-normalized.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import dwt_host, eegdsp_compat


@lru_cache(maxsize=None)
def cascade_matrix(wavelet_index: int, n: int, count: int) -> np.ndarray:
    """(n, count) float64 matrix M with coeffs[:count] = signal @ M,
    computed exactly by running the host (bit-parity) transform on the
    identity."""
    eye = np.eye(n, dtype=np.float64)
    h, g = eegdsp_compat.filter_pair(wavelet_index)
    return np.ascontiguousarray(dwt_host.fwt_periodic(eye, h, g)[:, :count])


def safe_l2_normalize(feats: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 normalize with a zero-vector guard: an all-zero row
    stays zero, never NaN."""
    norm = torch.sqrt(torch.sum(feats * feats, dim=-1, keepdim=True))
    return feats / torch.clamp(norm, min=1e-30)


def epoch_features(
    epochs: torch.Tensor,
    wavelet_index: int = 8,
    skip_samples: int = 175,
    epoch_size: int = 512,
    feature_size: int = 16,
) -> torch.Tensor:
    """(B, C, T) float epochs -> (B, C*feature_size) normalized features:
    the analysis window [skip, skip+size) of each channel contracted
    with the cascade matrix, channels concatenated."""
    B, C, _ = epochs.shape
    W = torch.as_tensor(
        cascade_matrix(wavelet_index, epoch_size, feature_size),
        dtype=epochs.dtype, device=epochs.device,
    )
    window = epochs[:, :, skip_samples : skip_samples + epoch_size]
    coeffs = torch.einsum("bct,tk->bck", window, W)
    return safe_l2_normalize(coeffs.reshape(B, C * feature_size))
