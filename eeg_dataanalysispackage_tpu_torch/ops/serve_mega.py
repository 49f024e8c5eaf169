"""The serve-path megakernel: raw window bytes -> margin, one pass.

Port of the JAX package's ``ops/serve_mega.py``. The serving engine lays
each micro-batch out itself, so window ``i`` sits at the static offset
``i * padded_stride(pre, post)`` of one int16 stream, and the whole
request path

    int16 decode -> window cut -> pre-stimulus mean subtract ->
    Db cascade contraction -> 48-dim L2-normalized feature -> linear
    margin

runs as one kernel (``csrc/serve_mega.cu``) whose only output is the
``(capacity,)`` margin vector: the features never reach device memory.
At ``precision="int8"`` or ``"int4"`` the normalized feature row is
quantized per (channel, subband group) before the margin, as the JAX
package's kernel does (``quant.masked_quantize_dequantize``).

:func:`make_serve_mega_program` returns the program: for CUDA tensors it
launches the kernel (``ops/serve_mega_cuda.py``), for CPU tensors it runs
the plain version :func:`serve_mega_margins_plain`. Nothing falls back
from the card to the plain version.

Not ported: the JAX package's lowering and rung decisions
(``default_lowering``, ``accelerator_decision``,
``default_engine_rung``), which read TPU sweep artifacts.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from . import device_ingest, dwt
from ..utils import constants

#: the precisions the megakernel has (bf16 has none: its rung differs in
#: the contraction's operands, not in the finished feature row)
MEGA_PRECISIONS = ("f32", "int8", "int4")

#: warmup parity gate: max abs deviation of mega margins vs the fused
#: rung's margins on the same synthetic windows before the engine
#: refuses the rung. Margins are (unit-norm feature row) . (model
#: weights); the rungs' feature deviation sits in the ~1e-7..1e-6
#: class, so 5e-5 is that envelope with the weight-norm factor of a
#: trained linear model. Override for experiments via
#: EEG_TPU_MEGA_GATE_TOL.
MEGA_GATE_TOL = 5e-5


def mega_gate_tolerance() -> float:
    """The documented mega warmup gate (``MEGA_GATE_TOL``), with the
    experiment override ``EEG_TPU_MEGA_GATE_TOL`` (logged, never
    silent, on an unparseable value)."""
    raw = os.environ.get("EEG_TPU_MEGA_GATE_TOL")
    if raw:
        try:
            return float(raw)
        except ValueError:
            logging.getLogger(__name__).warning(
                "EEG_TPU_MEGA_GATE_TOL=%r is not a float; using the "
                "default gate %g", raw, MEGA_GATE_TOL,
            )
    return MEGA_GATE_TOL


def padded_stride(pre: int, post: int) -> int:
    """The serve stream's per-window stride: the live window (pre +
    post samples) rounded up to whole 128-sample rows. The pad columns
    are zeros the contraction never reads."""
    win = int(pre) + int(post)
    return -(-win // 128) * 128


def serve_mega_margins_plain(
    stream: torch.Tensor,
    resolutions: torch.Tensor,
    operator: torch.Tensor,
    weights: torch.Tensor,
    pre: int,
    skip_samples: int,
    stride: int,
    precision: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch version of the megakernel: (C, capacity*stride)
    int16 stream + (C,) resolutions + (E, K) cascade matrix + (C*K,)
    weights -> (capacity,) float32 margins before the intercept.

    Window ``i`` is cut at ``i * stride``; its features are
    ``device_ingest.ingest_features_plain``'s (scale, baseline mean
    accumulated in float64 and subtracted first, contraction,
    ``safe_l2_normalize``; at ``precision`` int8 or int4 the quantized
    rows), dotted with the weights."""
    _check_precision(precision)
    capacity = stream.shape[1] // stride
    starts = torch.arange(capacity, dtype=torch.int32, device=stream.device) * stride
    feats = device_ingest.ingest_features_plain(
        stream, resolutions, starts, operator, pre, skip_samples, precision
    )
    return feats @ weights


def _check_precision(precision: str) -> None:
    if precision not in MEGA_PRECISIONS:
        raise ValueError(
            f"mega precision {precision!r}; use f32, int8, or int4 "
            f"(bf16 has no mega twin — its cascade runs bf16 "
            f"operands, not quantized f32 rows)"
        )


def make_serve_mega_program(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    n_channels: int = len(constants.CHANNEL_NAMES),
    pre: int = constants.PRESTIMULUS_SAMPLES,
    post: int = constants.POSTSTIMULUS_SAMPLES,
    capacity: int = 64,
    precision: str = "f32",
):
    """The megakernel program for one serving geometry: a callable
    ``(stream (C, capacity*Wp) int16, resolutions (C,) float32,
    weights (C*K,) float32) -> margins (capacity,) float32`` (before the
    intercept), with ``Wp = padded_stride(pre, post)``. Padded windows
    are zero and give margin 0.0; each window's compute is
    row-independent, so its margin is the same whatever batch it rides
    in. ``precision`` int8 or int4 quantizes each window's feature row
    before the margin. Tensors on the card launch the kernel; CPU
    tensors run :func:`serve_mega_margins_plain`."""
    _check_precision(precision)
    if pre < 1:
        raise ValueError(
            "the megakernel's baseline subtract needs pre >= 1 "
            "(pre=0 geometries serve through the host-extractor mode)"
        )
    C, K = int(n_channels), int(feature_size)
    Wp = padded_stride(pre, post)
    live = pre + skip_samples + epoch_size
    if live > Wp:
        raise ValueError(
            f"window geometry (pre {pre} + skip {skip_samples} + "
            f"epoch {epoch_size} = {live}) exceeds the padded stride "
            f"{Wp} (= pre+post rounded to 128)"
        )
    cascade = dwt.cascade_matrix(wavelet_index, epoch_size, feature_size).astype(np.float32)
    operators = {}

    def run(stream: torch.Tensor, resolutions: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
        from . import serve_mega_cuda

        if stream.shape != (C, capacity * Wp):
            raise ValueError(
                f"stream must be ({C}, {capacity * Wp}), got {tuple(stream.shape)}"
            )
        if weights.shape != (C * K,):
            raise ValueError(f"weights must be ({C * K},), got {tuple(weights.shape)}")
        dev = stream.device
        if dev not in operators:
            operators[dev] = torch.from_numpy(cascade).to(dev)
        return serve_mega_cuda.serve_mega_margins(
            stream, resolutions, operators[dev], weights, pre, skip_samples, Wp, precision
        )

    return run


def stage_mega_stream(
    windows, n_channels: int, window_len: int, stride: int,
    capacity: int, dtype=None,
) -> np.ndarray:
    """Lay a micro-batch out at the padded stride: window ``i``'s raw
    samples at columns ``[i*stride, i*stride + window_len)``, pad
    columns and unused capacity rows zero. The megakernel's host-side
    staging counterpart of the engine's fused-stream packing."""
    if dtype is None:
        dtype = np.asarray(windows[0]).dtype
    stream = np.zeros((n_channels, capacity * stride), dtype=dtype)
    for i, w in enumerate(windows):
        w = np.asarray(w)
        if w.shape != (n_channels, window_len):
            raise ValueError(
                f"window {i} has shape {w.shape}, expected "
                f"({n_channels}, {window_len})"
            )
        stream[:, i * stride:i * stride + window_len] = w
    return stream
