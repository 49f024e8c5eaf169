"""The eegdsp FWT as one contraction, in PyTorch.

The 6-level cascade is linear, so its first ``count`` coefficients
compose into one (n, count) matrix (:func:`cascade_matrix`); features
are that matrix applied to the analysis window, then L2-normalized.

:func:`epoch_features` is the plain version of the epoch-features
kernel (``ops/dwt_cuda.py``). :func:`make_batched_extractor` and
:func:`make_compact_extractor` are the counterparts of the JAX
package's XLA extractors (``fe=dwt-<i>-tpu`` and ``-tpu-compact``, and
with ``dtype=torch.bfloat16`` their ``-bf16`` spellings): PyTorch
contractions on an explicit device. The JAX package leaves these
products to XLA outside any Pallas kernel, so here they are
``torch.matmul``/``einsum`` (at bf16 they may run on tensor cores).
:func:`kernel_operator` is the cascade matrix as a float32 tensor on
the card, the fused CUDA kernels' operand; ``ops/dwt_cuda.kernel_operand``
lays it out for the epoch-features kernel.
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


#: the main path's analysis window and coefficient count: the fused CUDA
#: kernels' ring engine is built for them (``csrc/window_features.cuh``:
#: kEpoch, kFeatures), every other size runs their generic engine
KERNEL_EPOCH_SIZE = 512
KERNEL_FEATURE_SIZE = 16


def check_feature_size(wavelet_index: int, epoch_size: int, feature_size: int) -> None:
    """Raise ValueError where the cascade of an ``epoch_size`` window has
    fewer than ``feature_size`` coefficients (e.g. 128 at epoch_size 128,
    745 at 750). The JAX package returns all-NaN rows there; no feature
    row exists, so the port refuses."""
    columns = cascade_matrix(wavelet_index, epoch_size, feature_size).shape[1]
    if feature_size > columns:
        raise ValueError(
            f"feature_size {feature_size} exceeds the {columns} coefficients "
            f"the wavelet-{wavelet_index} cascade has for epoch_size {epoch_size}"
        )


# a few (wavelet, sizes, device) keys per process; bounded all the same
@lru_cache(maxsize=16)
def kernel_operator(
    wavelet_index: int, epoch_size: int, feature_size: int, device: torch.device
) -> torch.Tensor:
    """The (epoch_size, feature_size) float32 cascade matrix the CUDA
    kernels take, contiguous on ``device``; one tensor per key, which
    callers must not modify. Raises as :func:`check_feature_size`."""
    check_feature_size(wavelet_index, epoch_size, feature_size)
    W = cascade_matrix(wavelet_index, epoch_size, feature_size)
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
    with the cascade matrix, channels concatenated. Raises as
    :func:`check_feature_size`."""
    check_feature_size(wavelet_index, epoch_size, feature_size)
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
    dtype: torch.dtype = torch.float32,
):
    """``(B, C, epoch_size) -> (B, C*feature_size)`` float32 extractor
    over compact epochs (the analysis window only), on ``device``; takes
    a numpy array or a tensor and returns a tensor on ``device``. The
    contraction and the normalize run in ``dtype`` (float32, or
    bfloat16 for ``-tpu-compact-bf16``)."""
    dev = resolve_device(device)
    cascade_matrix(wavelet_index, epoch_size, feature_size)  # warm cache

    def extract(epochs) -> torch.Tensor:
        ep = torch.as_tensor(epochs).to(device=dev, dtype=dtype)
        feats = compact_epoch_features(ep, wavelet_index, epoch_size, feature_size)
        return feats.to(torch.float32)

    return extract


def make_batched_extractor(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    channels: Sequence[int] = (1, 2, 3),
    device: Optional[Union[str, torch.device]] = None,
    dtype: torch.dtype = torch.float32,
):
    """``(B, n_ch, n_samples) -> (B, len(channels)*feature_size)``
    float32 extractor on ``device``: select the 1-based ``channels``,
    slice each one's analysis window, contract with the cascade matrix,
    concatenate and L2-normalize, in ``dtype`` (float32, or bfloat16 for
    ``-tpu-bf16``). Takes a numpy array or a tensor and returns a
    float32 tensor on ``device``. The JAX package's other method, the
    level-by-level filter bank, is selected by no path and not ported."""
    dev = resolve_device(device)
    ch_idx = [c - 1 for c in channels]
    cascade_matrix(wavelet_index, epoch_size, feature_size)  # warm cache

    def extract(epochs) -> torch.Tensor:
        ep = torch.as_tensor(epochs).to(device=dev, dtype=dtype)
        # channel gather only when the selection isn't the identity — a
        # no-op gather would copy the whole batch
        if ch_idx != list(range(ep.shape[1])):
            ep = ep[:, ch_idx, :]
        feats = epoch_features(ep, wavelet_index, skip_samples, epoch_size, feature_size)
        return feats.to(torch.float32)

    return extract
