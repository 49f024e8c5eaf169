"""The epoch-features kernel's wrapper (``csrc/epoch_features.cu``).

Counterpart of the JAX package's Pallas DWT kernel
(``ops/dwt_pallas.py:44`` ``_make_kernel``, wrapped by
``epoch_features_pallas``): float32 epochs (B, C, T) -> (B, C*16)
L2-normalized features, the analysis window [skip, skip+512) of each
channel contracted with the cascade matrix. The kernel is bound by
bytes on the H100: 6,336 B per epoch at C = 3 (the window read once, the
row written once), 0.062 ms for 32,768 epochs at 3.35 TB/s.

:func:`epoch_features_cuda` checks its inputs, then for CUDA tensors
launches the kernel (and counts the launch in :data:`LAUNCHES`), and for
CPU tensors runs the plain version, ``ops/dwt.epoch_features``. A CUDA
launch that fails raises; nothing falls back to the plain version on
the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, dwt

#: kernel launches made by this process (the wrapper adds one per launch)
LAUNCHES = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("epoch_features")
    fn = lib.epoch_features_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.epoch_features_error_string.argtypes = [ctypes.c_int]
    lib.epoch_features_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (if needed) and load the kernel; returns the library path."""
    _library()
    return cuda_build.library_path("epoch_features")


def _check(epochs: torch.Tensor, skip_samples: int, epoch_size: int) -> None:
    if epochs.dim() != 3 or epochs.dtype != torch.float32:
        raise ValueError(
            f"epochs must be (B, C, T) float32, got {tuple(epochs.shape)} {epochs.dtype}"
        )
    T = epochs.shape[2]
    if skip_samples < 0 or skip_samples + epoch_size > T:
        raise ValueError(
            f"analysis window [{skip_samples}, {skip_samples + epoch_size}) "
            f"exceeds epoch length {T}"
        )
    if not epochs.is_contiguous():
        raise ValueError("epochs must be contiguous")
    if epochs.shape[0] > cuda_build.INT32_MAX or epochs.shape[1] * T > cuda_build.INT32_MAX:
        raise ValueError("the epoch count and the row length must fit in int32")


def epoch_features_cuda(
    epochs: torch.Tensor,
    wavelet_index: int = 8,
    skip_samples: int = 175,
    epoch_size: int = 512,
    feature_size: int = 16,
) -> torch.Tensor:
    """(B, C, T) float32 epochs -> (B, C*feature_size) float32 features;
    see ``ops/dwt.epoch_features`` for the exact function. Channel
    selection is the caller's (``features/wavelet.py`` gathers on the
    host). The kernel computes ``epoch_size=512, feature_size=16``;
    other sizes raise for any tensor off the CPU."""
    global LAUNCHES
    _check(epochs, skip_samples, epoch_size)
    if epochs.device.type == "cpu":
        return dwt.epoch_features(
            epochs, wavelet_index, skip_samples, epoch_size, feature_size
        )
    # off the CPU the sizes are the kernel's, whatever the device
    dwt.check_kernel_sizes("epoch-features", epoch_size, feature_size)
    if epochs.device.type != "cuda":
        raise ValueError(f"unsupported device {epochs.device}")
    B, C, T = epochs.shape
    out = torch.empty((B, C * feature_size), dtype=torch.float32, device=epochs.device)
    if B == 0:
        return out
    operator = dwt.kernel_operator(wavelet_index, epochs.device)
    lib = _library()
    with torch.cuda.device(epochs.device):
        stream = torch.cuda.current_stream(epochs.device).cuda_stream
        rc = lib.epoch_features_launch(
            epochs.data_ptr(), operator.data_ptr(), out.data_ptr(),
            B, C, T, skip_samples, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"epoch_features launch failed: CUDA error {rc} "
            f"({lib.epoch_features_error_string(rc).decode()})"
        )
    LAUNCHES += 1
    return out
