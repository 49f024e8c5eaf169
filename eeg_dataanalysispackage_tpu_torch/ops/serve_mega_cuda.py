"""The serve megakernel's wrapper (``csrc/serve_mega.cu``).

Counterpart of the JAX package's Pallas megakernel
(``ops/serve_mega.py:259``, ``_make_mega_kernel``): a micro-batch of
int16 windows at a regular stride -> one margin per window, features
kept on chip; at ``precision`` int8 or int4, quantized before the
margin.

:func:`serve_mega_margins` checks its inputs, then for CUDA tensors
launches the kernel (and counts the launch in the counter of its
instantiation: :data:`LAUNCHES`, :data:`LAUNCHES_INT8` or
:data:`LAUNCHES_INT4`), and for CPU tensors runs the plain version,
``serve_mega.serve_mega_margins_plain``. A CUDA launch that fails
raises; nothing falls back to the plain version on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, decode_ingest, dwt, serve_mega

#: kernel launches made by this process (the wrapper adds one per
#: launch), one counter per instantiation: f32, int8, int4
LAUNCHES = 0
LAUNCHES_INT8 = 0
LAUNCHES_INT4 = 0

_COUNTERS = {"f32": "LAUNCHES", "int8": "LAUNCHES_INT8", "int4": "LAUNCHES_INT4"}

EPOCH_SIZE = dwt.KERNEL_EPOCH_SIZE
FEATURE_SIZE = dwt.KERNEL_FEATURE_SIZE


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("serve_mega")
    fn = lib.serve_mega_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.serve_mega_error_string.argtypes = [ctypes.c_int]
    lib.serve_mega_error_string.restype = ctypes.c_char_p
    return lib


def build() -> str:
    """Build (if needed) and load the kernel; returns the library path."""
    _library()
    return cuda_build.library_path("serve_mega")


def _check(stream, resolutions, operator, weights, pre, skip_samples, stride) -> None:
    if stream.dim() != 2 or stream.dtype != torch.int16:
        raise ValueError(
            f"stream must be (C, capacity*stride) int16, got "
            f"{tuple(stream.shape)} {stream.dtype}"
        )
    C, S = stream.shape
    if resolutions.shape != (C,) or resolutions.dtype != torch.float32:
        raise ValueError(
            f"resolutions must be ({C},) float32, got "
            f"{tuple(resolutions.shape)} {resolutions.dtype}"
        )
    if operator.shape != (EPOCH_SIZE, FEATURE_SIZE) or operator.dtype != torch.float32:
        raise ValueError(
            f"operator must be ({EPOCH_SIZE}, {FEATURE_SIZE}) float32, got "
            f"{tuple(operator.shape)} {operator.dtype}"
        )
    if weights.shape != (C * FEATURE_SIZE,) or weights.dtype != torch.float32:
        raise ValueError(
            f"weights must be ({C * FEATURE_SIZE},) float32, got "
            f"{tuple(weights.shape)} {weights.dtype}"
        )
    for name, t in (("stream", stream), ("resolutions", resolutions),
                    ("operator", operator), ("weights", weights)):
        if t.device != stream.device:
            raise ValueError(f"{name} is on {t.device}, stream on {stream.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pre < 1 or skip_samples < 0 or pre + skip_samples + EPOCH_SIZE > stride:
        raise ValueError(
            f"need pre >= 1, skip >= 0 and pre + skip + {EPOCH_SIZE} <= stride; "
            f"got pre {pre}, skip {skip_samples}, stride {stride}"
        )
    if S % stride:
        raise ValueError(f"stream length {S} is not a multiple of the stride {stride}")
    if S > cuda_build.INT32_MAX:
        raise ValueError("stream length must fit in int32")


def serve_mega_margins(
    stream: torch.Tensor,
    resolutions: torch.Tensor,
    operator: torch.Tensor,
    weights: torch.Tensor,
    pre: int,
    skip_samples: int,
    stride: int,
    precision: str = "f32",
) -> torch.Tensor:
    """(C, capacity*stride) int16 + (C,) res + (512, 16) operator +
    (C*16,) weights -> (capacity,) float32 margins before the intercept,
    at ``precision`` (f32, int8 or int4); see
    ``serve_mega.serve_mega_margins_plain`` for the exact function."""
    serve_mega._check_precision(precision)
    _check(stream, resolutions, operator, weights, pre, skip_samples, stride)
    if stream.device.type == "cpu":
        return serve_mega.serve_mega_margins_plain(
            stream, resolutions, operator, weights, pre, skip_samples, stride, precision
        )
    if stream.device.type != "cuda":
        raise ValueError(f"unsupported device {stream.device}")
    C, S = stream.shape
    capacity = S // stride
    out = torch.empty((capacity,), dtype=torch.float32, device=stream.device)
    if capacity == 0:
        return out
    lib = _library()
    with torch.cuda.device(stream.device):
        cuda_stream = torch.cuda.current_stream(stream.device).cuda_stream
        rc = lib.serve_mega_launch(
            stream.data_ptr(), resolutions.data_ptr(), operator.data_ptr(),
            weights.data_ptr(), out.data_ptr(),
            capacity, C, stride, pre, skip_samples,
            decode_ingest.PRECISIONS.index(precision), cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"serve_mega launch failed: CUDA error {rc} "
            f"({lib.serve_mega_error_string(rc).decode()})"
        )
    globals()[_COUNTERS[precision]] += 1
    return out
