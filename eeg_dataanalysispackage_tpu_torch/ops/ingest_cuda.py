"""The fused ingest kernel's wrapper (``csrc/ingest_features.cu``).

Counterpart of the JAX package's Pallas ingest kernels
(``ops/ingest_pallas.py``: the ``exact``, ``bank128`` and ``aligned8``
formulations of one function, and the ``bank128_bf16`` mode of the
``precision=bf16`` rung): int16 stream + window starts -> (n, C*16)
L2-normalized features in marker order. A float32 stream (a recording
in another binary format, staged already scaled) runs the kernel's
float32-sample instantiation. ``precision=`` picks the rung's
instantiation: ``f32``, ``bf16`` (bfloat16 contraction operands),
``int8`` and ``int4`` (the quantize step as an epilogue).

:func:`ingest_features` checks its inputs, then for CUDA tensors
launches the kernel (and counts the launch in the counter of its
instantiation, below), and for CPU tensors runs the plain version,
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

from . import cuda_build, decode_ingest, device_ingest, dwt
from ..utils import constants

#: kernel launches made by this process (the wrapper adds one per
#: launch), one counter per instantiation: the f32 rung on int16 streams
#: in LAUNCHES and on float32 streams in LAUNCHES_F32; the bf16, int8
#: and int4 rungs (either sample type) in LAUNCHES_BF16, LAUNCHES_INT8
#: and LAUNCHES_INT4
LAUNCHES = 0
LAUNCHES_F32 = 0
LAUNCHES_BF16 = 0
LAUNCHES_INT8 = 0
LAUNCHES_INT4 = 0

#: the counter each (precision, float samples) instantiation adds to
_COUNTERS = {
    ("f32", False): "LAUNCHES", ("f32", True): "LAUNCHES_F32",
    ("bf16", False): "LAUNCHES_BF16", ("bf16", True): "LAUNCHES_BF16",
    ("int8", False): "LAUNCHES_INT8", ("int8", True): "LAUNCHES_INT8",
    ("int4", False): "LAUNCHES_INT4", ("int4", True): "LAUNCHES_INT4",
}


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("ingest_features")
    fn = lib.ingest_features_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ingest_features_error_string.argtypes = [ctypes.c_int]
    lib.ingest_features_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (if needed) and load the kernel; returns the library path."""
    _library()
    return cuda_build.library_path("ingest_features")


def _check(raw, resolutions, starts, operator, pre, skip_samples, precision) -> None:
    if precision not in decode_ingest.PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; use one of {decode_ingest.PRECISIONS}"
        )
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
    precision: str = "f32",
) -> torch.Tensor:
    """(C, S) int16 or float32 + (C,) res + (n,) int32 starts + (512, 16)
    operator -> (n, C*16) float32 features at ``precision``; see
    ``device_ingest.ingest_features_plain`` for the exact function.
    Samples at or past ``S`` read 0."""
    _check(raw, resolutions, starts, operator, pre, skip_samples, precision)
    if raw.device.type == "cpu":
        return device_ingest.ingest_features_plain(
            raw, resolutions, starts, operator, pre, skip_samples, precision
        )
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    C, S = raw.shape
    n = starts.shape[0]
    out = torch.empty((n, C * dwt.KERNEL_FEATURE_SIZE), dtype=torch.float32, device=raw.device)
    if n == 0:
        return out
    lib = _library()
    float_samples = raw.dtype == torch.float32
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rc = lib.ingest_features_launch(
            raw.data_ptr(), resolutions.data_ptr(), starts.data_ptr(),
            operator.data_ptr(), out.data_ptr(),
            n, C, S, pre, skip_samples, int(float_samples),
            decode_ingest.PRECISIONS.index(precision), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"ingest_features launch failed: CUDA error {rc} "
            f"({lib.ingest_features_error_string(rc).decode()})"
        )
    counter = _COUNTERS[(precision, float_samples)]
    globals()[counter] += 1
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
    precision: str = "f32",
) -> torch.Tensor:
    """(C, S) int16 or float32 raw + (n,) marker positions -> (n, C*K) features in
    marker order — the counterpart of ``ingest_pallas.ingest_features_pallas``
    (``precision="bf16"``: its ``bank128_bf16`` mode). Positions must be
    validated (``0 <= position - pre <= S``), as the planner guarantees;
    others raise."""
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
        precision,
    )


def make_cuda_ingest_featurizer(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    precision: str = "f32",
):
    """Callable ``(raw int16 or float32 (C, S), resolutions, positions, mask) ->
    (capacity, C*K)`` over an ``IngestPlan``'s padded positions/mask —
    the decode rung's form, at ``precision`` (one of
    ``decode_ingest.PRECISIONS``). Padded rows start at ``S``, read only
    zeros and come out as zero rows (at every precision), so one launch
    covers the whole plan."""
    dwt.check_kernel_sizes("fused", epoch_size, feature_size)
    if precision not in decode_ingest.PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; use one of {decode_ingest.PRECISIONS}"
        )

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
            precision,
        )

    return featurize
