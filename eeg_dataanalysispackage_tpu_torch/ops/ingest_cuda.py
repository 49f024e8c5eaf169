"""The fused ingest kernel's wrapper (``csrc/ingest_features.cu``).

Counterpart of the JAX package's Pallas ingest kernels
(``ops/ingest_pallas.py``: the ``exact``, ``bank128`` and ``aligned8``
formulations of one function): int16 stream + window starts ->
(n, C*16) L2-normalized features in marker order. A float32 stream (a
recording in another binary format, staged already scaled) runs the
kernel's float32-sample instantiation.

:func:`ingest_features` checks its inputs, then for CUDA tensors
launches the kernel (and counts the launch in :data:`LAUNCHES` or
:data:`LAUNCHES_F32`), and
for CPU tensors runs the plain version,
``device_ingest.ingest_features_plain``. A CUDA launch that fails
raises; nothing falls back to the plain version on the card.

Two forms sit on top, mirroring the JAX call sites:
:func:`ingest_features_cuda` (``ingest_pallas.ingest_features_pallas``:
validated positions -> rows in marker order) and
:func:`make_cuda_ingest_featurizer` (the decode rung's
``(raw, res, positions, mask) -> (capacity, C*K)`` form, padded rows
zero).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build, device_ingest, dwt
from ..utils import constants

#: kernel launches made by this process (the wrapper adds one per
#: launch): int16 streams in LAUNCHES, float32 streams in LAUNCHES_F32
LAUNCHES = 0
LAUNCHES_F32 = 0


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("ingest_features")
    for fn in (lib.ingest_features_launch, lib.ingest_features_f32_launch):
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ingest_features_error_string.argtypes = [ctypes.c_int]
    lib.ingest_features_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (if needed) and load the kernel; returns the library path."""
    _library()
    return cuda_build.library_path("ingest_features")


def _check(raw, resolutions, starts, operator, pre, skip_samples) -> None:
    if raw.dim() != 2 or raw.dtype not in (torch.int16, torch.float32):
        raise ValueError(
            f"raw must be (C, S) int16 or float32, got {tuple(raw.shape)} {raw.dtype}"
        )
    C, S = raw.shape
    if resolutions.shape != (C,) or resolutions.dtype != torch.float32:
        raise ValueError(
            f"resolutions must be ({C},) float32, got "
            f"{tuple(resolutions.shape)} {resolutions.dtype}"
        )
    if starts.dim() != 1 or starts.dtype != torch.int32:
        raise ValueError(f"starts must be (n,) int32, got {tuple(starts.shape)} {starts.dtype}")
    shape = (dwt.KERNEL_EPOCH_SIZE, dwt.KERNEL_FEATURE_SIZE)
    if operator.shape != shape or operator.dtype != torch.float32:
        raise ValueError(
            f"operator must be {shape} float32, got "
            f"{tuple(operator.shape)} {operator.dtype}"
        )
    for name, t in (("raw", raw), ("resolutions", resolutions),
                    ("starts", starts), ("operator", operator)):
        if t.device != raw.device:
            raise ValueError(f"{name} is on {t.device}, raw on {raw.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pre < 1 or skip_samples < 0:
        raise ValueError(f"need pre >= 1 and skip_samples >= 0, got {pre}, {skip_samples}")
    if S > cuda_build.INT32_MAX or starts.shape[0] > cuda_build.INT32_MAX:
        raise ValueError("stream length and window count must fit in int32")


def ingest_features(
    raw: torch.Tensor,
    resolutions: torch.Tensor,
    starts: torch.Tensor,
    operator: torch.Tensor,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    skip_samples: int = 175,
) -> torch.Tensor:
    """(C, S) int16 or float32 + (C,) res + (n,) int32 starts + (512, 16)
    operator -> (n, C*16) float32 features; see
    ``device_ingest.ingest_features_plain`` for the exact function.
    Samples at or past ``S`` read 0."""
    global LAUNCHES, LAUNCHES_F32
    _check(raw, resolutions, starts, operator, pre, skip_samples)
    if raw.device.type == "cpu":
        return device_ingest.ingest_features_plain(
            raw, resolutions, starts, operator, pre, skip_samples
        )
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    C, S = raw.shape
    n = starts.shape[0]
    out = torch.empty((n, C * dwt.KERNEL_FEATURE_SIZE), dtype=torch.float32, device=raw.device)
    if n == 0:
        return out
    lib = _library()
    int16 = raw.dtype == torch.int16
    launch = lib.ingest_features_launch if int16 else lib.ingest_features_f32_launch
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = launch(
            raw.data_ptr(), resolutions.data_ptr(), starts.data_ptr(),
            operator.data_ptr(), out.data_ptr(),
            n, C, S, pre, skip_samples, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ingest_features launch failed: CUDA error {rc} "
            f"({lib.ingest_features_error_string(rc).decode()})"
        )
    if int16:
        LAUNCHES += 1
    else:
        LAUNCHES_F32 += 1
    return out


def ingest_features_cuda(
    raw: torch.Tensor,
    resolutions: torch.Tensor,
    positions: np.ndarray,
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    pre: int = constants.PRESTIMULUS_SAMPLES,
) -> torch.Tensor:
    """(C, S) int16 or float32 raw + (n,) marker positions -> (n, C*K) features in
    marker order — the counterpart of ``ingest_pallas.ingest_features_pallas``.
    Positions must be validated (``0 <= position - pre <= S``), as the
    planner guarantees; others raise."""
    starts = np.asarray(positions, dtype=np.int64) - pre
    S = raw.shape[1]
    if starts.size and (starts.min() < 0 or starts.max() > S):
        raise ValueError(
            f"window starts must lie in [0, {S}]; got "
            f"[{int(starts.min())}, {int(starts.max())}]"
        )
    dwt.check_kernel_sizes("fused", epoch_size, feature_size)
    return ingest_features(
        raw,
        resolutions,
        torch.from_numpy(starts.astype(np.int32)).to(raw.device),
        dwt.kernel_operator(wavelet_index, raw.device),
        pre,
        skip_samples,
    )


def make_cuda_ingest_featurizer(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    pre: int = constants.PRESTIMULUS_SAMPLES,
):
    """Callable ``(raw int16 or float32 (C, S), resolutions, positions, mask) ->
    (capacity, C*K)`` over an ``IngestPlan``'s padded positions/mask —
    the decode rung's form. Padded rows start at ``S``, read only zeros
    and come out as zero rows, so one launch covers the whole plan."""
    dwt.check_kernel_sizes("fused", epoch_size, feature_size)

    def featurize(raw, resolutions, positions, mask):
        S = raw.shape[1]
        starts = np.where(
            np.asarray(mask, dtype=bool),
            np.clip(np.asarray(positions, dtype=np.int64) - pre, 0, S),
            S,
        ).astype(np.int32)
        return ingest_features(
            raw, resolutions, torch.from_numpy(starts).to(raw.device),
            dwt.kernel_operator(wavelet_index, raw.device), pre, skip_samples,
        )

    return featurize
