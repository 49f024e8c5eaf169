"""The int4 feature rung and the quantized tenant weight stack.

Port of the JAX package's ``ops/quant.py``, both halves:

- **int4 features**: ``precision=int4`` quantizes finished f32 feature
  rows with the int8 rung's per-(row, channel, subband group) symmetric
  scales (``decode_ingest.quantize_dequantize``), at 4-bit levels (qmax
  7), two nibbles per byte in the shipped representation. Gated per run
  by :data:`INT4_GATE_TOL` (override ``EEG_TPU_INT4_GATE_TOL``) with
  per-run auto-disable, as the bf16 and int8 rungs are.
- **the quantized weight stack**: ``weights_precision=int8|int4`` of the
  multiplexed engine (``serve/multiplex.py``) keeps the (d, 128) f32
  host mirror as master and makes the resident stack its packed int8 or
  int4 payload plus one scale a lane (:func:`quantize_weight_stack`,
  host numpy, byte-equal to the JAX package's). Per-lane scales: a lane
  is one tenant's model, so a swap on one lane leaves every other
  lane's bytes and scale unchanged. The warmup gate holds the quantized
  margins against the f32 stack's at :func:`weights_gate_tolerance`.
  :func:`dequantize_weight_stack` is the stack's plain dequantize (the
  kernels K6-w8 and K6-w4 dequantize term by term, equal to it bit for
  bit).

Not ported: ``accelerator_decision``, which reads TPU sweep artifacts.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from . import decode_ingest

#: int4 feature gate: the worst rounding error is group_max / 14 <=
#: ~7.2e-2 on L2-normalized rows; 1.5e-1 is the JAX package's bound.
INT4_GATE_TOL = 1.5e-1

#: symmetric 4-bit quantization levels: q in [-7, 7], stored +8 as a
#: nibble in [1, 15] (0 never occurs: a cheap corruption tripwire).
INT4_QMAX = 7.0

#: the weight-stack precisions of the multiplexed engine; f32 ships the
#: host mirror as it is
WEIGHTS_PRECISIONS = ("f32", "int8", "int4")

#: headroom factor on the weight-stack gate's arithmetic envelope
#: (|delta margin| <= ||f||_2 * ||delta w||_2 <= sqrt(d) * s_max / 2 for
#: L2-normalized feature rows), the JAX package's
WEIGHTS_GATE_HEADROOM = 4.0


def int4_gate_tolerance() -> float:
    """:data:`INT4_GATE_TOL`, or the override ``EEG_TPU_INT4_GATE_TOL``
    (an unparseable value is logged)."""
    return decode_ingest._env_tolerance("EEG_TPU_INT4_GATE_TOL", INT4_GATE_TOL)


def quantize_dequantize_int4(rows: torch.Tensor, feature_size: int):
    """The int4 rung's round trip (qmax 7): ``(dequantized rows (n, C*K),
    scales (n_groups, n, C))``; see ``decode_ingest.quantize_dequantize``."""
    return decode_ingest.quantize_dequantize(rows, feature_size, INT4_QMAX)


def int4_feature_path(rows: torch.Tensor, feature_size: int) -> torch.Tensor:
    """The int4 rung applied to finished f32 rows: the dequantized rows."""
    return quantize_dequantize_int4(rows, feature_size)[0]


def pack_int4_rows(q) -> np.ndarray:
    """Pack integer 4-bit levels ``q (n, d) in [-7, 7]`` two nibbles per
    byte along the column axis (d even): byte j of a row carries column
    2j in its low nibble and 2j+1 in its high nibble, each stored +8, so
    a wire value lies in [1, 15] and a zero byte is corruption."""
    q = np.asarray(q)
    if q.ndim != 2 or q.shape[1] % 2:
        raise ValueError(f"int4 packing needs an (n, even) matrix, got {q.shape}")
    shifted = q.astype(np.int32) + 8
    if shifted.size and (shifted.min() < 1 or shifted.max() > 15):
        raise ValueError(f"int4 levels out of [-7, 7]: [{q.min()}, {q.max()}]")
    return (shifted[:, 0::2] | (shifted[:, 1::2] << 4)).astype(np.uint8)


def unpack_int4_rows(packed) -> np.ndarray:
    """Inverse of :func:`pack_int4_rows`: ``(n, d//2) uint8`` -> ``(n, d)``
    int32 levels in [-7, 7]."""
    p = np.asarray(packed, np.uint8).astype(np.int32)
    lo = (p & 0xF) - 8
    hi = (p >> 4) - 8
    return np.stack([lo, hi], axis=2).reshape(p.shape[0], -1)


def quantize_int4_packed(rows, feature_size: int):
    """The shipped int4 representation of finished feature rows:
    ``(packed (n, C*K//2) uint8, scales (n_groups, n, C) float32)``, on
    the host. :func:`dequantize_int4_packed` gives back exactly
    :func:`quantize_dequantize_int4`'s rows."""
    q, scales = decode_ingest.quantize_levels(
        torch.as_tensor(np.asarray(rows, np.float32)), feature_size, INT4_QMAX
    )
    return pack_int4_rows(q.numpy().astype(np.int8)), scales.numpy()


def dequantize_int4_packed(packed, scales, feature_size: int) -> np.ndarray:
    """float32 rows from the packed int4 representation: bit for bit the
    round trip's output."""
    q = unpack_int4_rows(packed).astype(np.float32)
    n = q.shape[0]
    K = int(feature_size)
    C = q.shape[1] // K
    x = q.reshape(n, C, K)
    outs = [
        x[:, :, lo:hi] * np.asarray(scales[i], np.float32)[..., None]
        for i, (lo, hi) in enumerate(decode_ingest.subband_group_bounds(K))
    ]
    return np.concatenate(outs, axis=2).reshape(n, C * K)


def subband_lane_masks(n_channels: int, feature_size: int) -> tuple:
    """The (channel, subband) groups of the channel-major ``(C*K,)``
    feature layout as disjoint 0/1 float32 lane masks."""
    bounds = decode_ingest.subband_group_bounds(int(feature_size))
    d = int(n_channels) * int(feature_size)
    masks = []
    for c in range(int(n_channels)):
        base = c * int(feature_size)
        for lo, hi in bounds:
            m = np.zeros((d,), np.float32)
            m[base + lo:base + hi] = 1.0
            masks.append(m)
    return tuple(masks)


def masked_quantize_dequantize(feats: torch.Tensor, masks, qmax: float) -> torch.Tensor:
    """Grouped symmetric quantize -> dequantize through disjoint lane
    masks: the same float32 function as the reshape-based round trips,
    in full-row operations (each lane receives exactly one group's
    ``m * (q * s)`` plus zeros)."""
    out = torch.zeros_like(feats)
    a = feats.abs()
    for m in masks:
        mv = torch.as_tensor(m, dtype=feats.dtype, device=feats.device)
        s = (a * mv).amax(dim=1, keepdim=True)
        s = torch.clamp(s / torch.full_like(s, qmax), min=1e-30)
        q = torch.clamp(torch.round(feats / s), -qmax, qmax)
        out = out + mv * (q * s)
    return out


def _weights_qmax(precision: str) -> float:
    if precision == "int8":
        return 127.0
    if precision == "int4":
        return INT4_QMAX
    raise ValueError(
        f"weights_precision {precision!r} has no quantized form; use "
        f"one of {WEIGHTS_PRECISIONS[1:]}"
    )


def quantize_weight_stack(w_host, precision: str):
    """Quantize the multiplexed engine's (d, 128) f32 host mirror into
    the resident payload: ``(packed, scales (128,) float32)``, packed
    ``(d, 128) int8`` for int8 or ``(d//2, 128) uint8`` for int4 (row 2i
    in the low nibble, 2i+1 in the high, each stored +8). Host numpy,
    the JAX package's operations in its order (a float32 division by the
    scales, rounding half to even), so the bytes equal its. Scales are
    per lane (``max|w[:, lane]| / qmax``): one lane's quantization never
    depends on another's weights."""
    w = np.asarray(w_host, np.float32)
    qmax = _weights_qmax(precision)
    s = np.max(np.abs(w), axis=0) / qmax  # (lanes,)
    s = np.maximum(s, 1e-30).astype(np.float32)
    q = np.clip(np.rint(w / s[None, :]), -qmax, qmax)
    if precision == "int8":
        return q.astype(np.int8), s
    if w.shape[0] % 2:
        raise ValueError(
            f"int4 weight packing needs an even row count, got {w.shape[0]}"
        )
    shifted = q.astype(np.int32) + 8
    packed = (shifted[0::2, :] | (shifted[1::2, :] << 4)).astype(np.uint8)
    return packed, s


def dequantize_weight_stack(packed, scales, precision: str, n_rows: int) -> torch.Tensor:
    """Inverse of :func:`quantize_weight_stack` in torch, on the payload's
    device: ``(d, 128)`` float32, element ``float(q) * scale`` (int4:
    ``(float(nibble) - 8) * scale``), the JAX package's operations. The
    plain version of K6-w8 and K6-w4's term-by-term dequantize."""
    packed = torch.as_tensor(packed)
    scales = torch.as_tensor(scales, dtype=torch.float32, device=packed.device)
    if precision == "int8":
        return packed.to(torch.float32) * scales[None, :]
    if precision == "int4":
        lo = (packed & 0xF).to(torch.float32) - 8.0
        hi = (packed >> 4).to(torch.float32) - 8.0
        vals = torch.stack([lo, hi], dim=1).reshape(int(n_rows), packed.shape[1])
        return vals * scales[None, :]
    raise ValueError(
        f"weights_precision {precision!r} has no quantized form; use "
        f"one of {WEIGHTS_PRECISIONS[1:]}"
    )


def weights_gate_tolerance(precision: str, w_host) -> float:
    """The quantized stack's warmup margin gate: the envelope
    ``sqrt(d) * s_max / 2`` of the margin error (L2-normalized feature
    rows, symmetric rounding of each weight within half its lane's
    scale, ``s_max`` the largest lane scale of the current stack) times
    :data:`WEIGHTS_GATE_HEADROOM`. ``EEG_TPU_WEIGHTS_GATE_TOL`` overrides
    with an absolute tolerance (0 shuts the gate: the drill); an
    unparseable value is logged and the envelope used."""
    raw = os.environ.get("EEG_TPU_WEIGHTS_GATE_TOL")
    if raw:
        try:
            return float(raw)
        except ValueError:
            logging.getLogger(__name__).warning(
                "EEG_TPU_WEIGHTS_GATE_TOL=%r is not a float; using "
                "the derived envelope gate", raw,
            )
    w = np.asarray(w_host, np.float32)
    qmax = _weights_qmax(precision)
    s_max = (float(np.max(np.abs(w))) if w.size else 0.0) / qmax
    s_max = max(s_max, 1e-30)
    return WEIGHTS_GATE_HEADROOM * math.sqrt(w.shape[0]) * s_max / 2.0


def resident_weight_bytes(packed, scales) -> int:
    """Bytes the quantized stack keeps resident: the packed matrix and
    its per-lane scales."""
    return int(np.asarray(packed).nbytes + np.asarray(scales).nbytes)
