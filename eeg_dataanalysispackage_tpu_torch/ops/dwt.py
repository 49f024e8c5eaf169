"""The eegdsp FWT as one contraction, in PyTorch.

The 6-level cascade is linear, so its first ``count`` coefficients
compose into one (n, count) matrix (:func:`cascade_matrix`); features
are that matrix applied to the analysis window, then L2-normalized.

:func:`epoch_features` is the plain version of the epoch-features
kernel (``ops/dwt_cuda.py``). :func:`make_batched_extractor` and
:func:`make_compact_extractor` are the counterparts of the JAX
package's XLA extractors (``fe=dwt-<i>-tpu`` and ``-tpu-compact``):
float32 PyTorch contractions on an explicit device.
:func:`kernel_operator` is the cascade matrix in the form every CUDA
kernel of the package takes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Sequence, Union

import numpy as np
import torch

from . import dwt_host, eegdsp_compat
from ..utils.device import resolve_device


@lru_cache(maxsize=None)
def cascade_matrix(wavelet_index: int, n: int, count: int) -> np.ndarray:
    """(n, count) float64 matrix M with coeffs[:count] = signal @ M,
    computed exactly by running the host (bit-parity) transform on the
    identity."""
    eye = np.eye(n, dtype=np.float64)
    h, g = eegdsp_compat.filter_pair(wavelet_index)
    return np.ascontiguousarray(dwt_host.fwt_periodic(eye, h, g)[:, :count])


#: the analysis window and coefficient count the CUDA kernels compute
#: (``csrc/window_features.cuh``: kEpoch, kFeatures)
KERNEL_EPOCH_SIZE = 512
KERNEL_FEATURE_SIZE = 16


def check_kernel_sizes(kernel: str, epoch_size: int, feature_size: int) -> None:
    """Raise unless the sizes are the ones the CUDA kernels compute."""
    if (epoch_size, feature_size) != (KERNEL_EPOCH_SIZE, KERNEL_FEATURE_SIZE):
        raise ValueError(
            f"the {kernel} kernel computes epoch_size={KERNEL_EPOCH_SIZE}, "
            f"feature_size={KERNEL_FEATURE_SIZE}; got {epoch_size}, {feature_size}"
        )


# a few (wavelet, device) pairs per process; bounded all the same
@lru_cache(maxsize=16)
def kernel_operator(wavelet_index: int, device: torch.device) -> torch.Tensor:
    """The (512, 16) float32 cascade matrix the CUDA kernels take,
    contiguous on ``device``; one tensor per (wavelet, device), which
    callers must not modify."""
    W = cascade_matrix(wavelet_index, KERNEL_EPOCH_SIZE, KERNEL_FEATURE_SIZE)
    return torch.as_tensor(W, dtype=torch.float32).to(device).contiguous()


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


def windowed_features(
    flat: torch.Tensor, wavelet_index: int, count: int
) -> torch.Tensor:
    """(..., n) already-windowed signals -> (..., count) coefficients via
    the composed-cascade contraction."""
    W = torch.as_tensor(
        cascade_matrix(wavelet_index, flat.shape[-1], count),
        dtype=flat.dtype, device=flat.device,
    )
    return flat @ W


def compact_epoch_features(
    ep: torch.Tensor, wavelet_index: int, epoch_size: int, feature_size: int
) -> torch.Tensor:
    """(B, C, epoch_size) pre-windowed epochs -> (B, C*feature_size)
    normalized features."""
    B, C, n = ep.shape
    if n != epoch_size:
        # windowed_features sizes its cascade from the input, so a
        # mis-sliced batch would silently get a different-depth
        # transform; fail loudly instead
        raise ValueError(
            f"compact path built for epoch_size {epoch_size}; "
            f"got windowed batch of width {n}"
        )
    coeffs = windowed_features(ep, wavelet_index, feature_size)
    return safe_l2_normalize(coeffs.reshape(B, C * feature_size))


def make_compact_extractor(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    feature_size: int = 16,
    device: Optional[Union[str, torch.device]] = None,
):
    """``(B, C, epoch_size) -> (B, C*feature_size)`` float32 extractor
    over compact epochs (the analysis window only), on ``device``; takes
    a numpy array or a tensor and returns a tensor on ``device``."""
    dev = resolve_device(device)
    cascade_matrix(wavelet_index, epoch_size, feature_size)  # warm cache

    def extract(epochs) -> torch.Tensor:
        ep = torch.as_tensor(epochs, device=dev).to(torch.float32)
        return compact_epoch_features(ep, wavelet_index, epoch_size, feature_size)

    return extract


def make_batched_extractor(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    channels: Sequence[int] = (1, 2, 3),
    device: Optional[Union[str, torch.device]] = None,
):
    """``(B, n_ch, n_samples) -> (B, len(channels)*feature_size)``
    float32 extractor on ``device``: select the 1-based ``channels``,
    slice each one's analysis window, contract with the cascade matrix,
    concatenate and L2-normalize. Takes a numpy array or a tensor and
    returns a tensor on ``device``. The JAX package's other method, the
    level-by-level filter bank, is selected by no path and not ported."""
    dev = resolve_device(device)
    ch_idx = [c - 1 for c in channels]
    cascade_matrix(wavelet_index, epoch_size, feature_size)  # warm cache

    def extract(epochs) -> torch.Tensor:
        ep = torch.as_tensor(epochs, device=dev).to(torch.float32)
        # channel gather only when the selection isn't the identity — a
        # no-op gather would copy the whole batch
        if ch_idx != list(range(ep.shape[1])):
            ep = ep[:, ch_idx, :]
        return epoch_features(ep, wavelet_index, skip_samples, epoch_size, feature_size)

    return extract
