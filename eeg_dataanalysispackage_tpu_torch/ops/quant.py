"""The int4 feature rung.

Port of the feature half of the JAX package's ``ops/quant.py``:
``precision=int4`` quantizes finished f32 feature rows with the int8
rung's per-(row, channel, subband group) symmetric scales
(``decode_ingest.quantize_dequantize``), at 4-bit levels (qmax 7), two
nibbles per byte in the shipped representation. Gated per run by
:data:`INT4_GATE_TOL` (override ``EEG_TPU_INT4_GATE_TOL``) with per-run
auto-disable, as the bf16 and int8 rungs are.

The weight-stack half (``weights_precision=int8|int4`` of the
multiplexed engine) belongs to multi-tenant serving and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from . import decode_ingest

#: int4 feature gate: the worst rounding error is group_max / 14 <=
#: ~7.2e-2 on L2-normalized rows; 1.5e-1 is the JAX package's bound.
INT4_GATE_TOL = 1.5e-1

#: symmetric 4-bit quantization levels: q in [-7, 7], stored +8 as a
#: nibble in [1, 15] (0 never occurs: a cheap corruption tripwire).
INT4_QMAX = 7.0


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
