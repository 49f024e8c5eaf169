"""The feature precision ladder: rungs, gate tolerances, quantizers.

Port of the precision half of the JAX package's ``ops/decode_ingest.py``
(``PRECISIONS``, the bf16 and int8 gate tolerances, the per-subband
int8 quantizer and the per-run accuracy gate). The decode rung's slice
formulation, its window planner and its platform decisions are not
ported: on the card every fused spelling runs the one CUDA ingest
kernel, whose ``precision=`` instantiations compute these rungs
(``ops/ingest_cuda.py``).

The quantizers here are the plain versions of the kernels' quantize
step (``csrc/window_features.cuh``: ``quantize_feature``), in the same
float32 operations and order: per (row, channel, subband group)
``s = max|g| / qmax`` (IEEE division), ``s = max(s, 1e-30)``,
``q = clip(round_half_even(g / s), -qmax, qmax)`` as an integer,
``out = q * s``.
The divisor is a tensor on the rows' device, never a Python scalar:
PyTorch's CUDA division by a scalar multiplies by its reciprocal, which
is not the same float32 function.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: the feature precision ladder, loosest last: f32 is the ~1e-7 rung
#: contract; bf16 runs the cascade contraction on bfloat16 operands with
#: float32 accumulation; int8 and int4 quantize the finished f32 feature
#: rows per subband (int4: ``ops/quant.py``). Every non-f32 rung runs
#: behind a per-run measured-deviation gate with auto-disable.
PRECISIONS = ("f32", "bf16", "int8", "int4")

#: bf16 feature gate: max abs deviation of bf16-rung features from the
#: f32 rows on the same windows before the rung auto-disables (the JAX
#: package's documented bound; override with EEG_TPU_BF16_GATE_TOL).
BF16_GATE_TOL = 5e-3

#: int8 feature gate: symmetric per-(channel, subband) scales put the
#: worst rounding error at group_max / 254 <= ~4e-3 on L2-normalized
#: rows; 2e-2 is the JAX package's bound (override with
#: EEG_TPU_INT8_GATE_TOL).
INT8_GATE_TOL = 2e-2

#: symmetric 8-bit quantization levels: q in [-127, 127]
INT8_QMAX = 127.0


def _env_tolerance(name: str, default: float) -> float:
    """``default``, or the float in the environment variable ``name``;
    an unparseable value is logged, never silently ignored."""
    raw = os.environ.get(name)
    if raw:
        try:
            return float(raw)
        except ValueError:
            logger.warning(
                "%s=%r is not a float; using the default gate %g", name, raw, default,
            )
    return default


def requested_precision(query_map) -> str:
    """A run's precision rung: ``precision=``, else ``EEG_TPU_PRECISION``,
    else f32; a rung outside :data:`PRECISIONS` raises the JAX package's
    message."""
    precision = query_map.get("precision") or os.environ.get("EEG_TPU_PRECISION") or "f32"
    if precision not in PRECISIONS:
        raise ValueError(f"precision= must be f32, bf16, int8, or int4, got {precision!r}")
    return precision


def bf16_gate_tolerance() -> float:
    """:data:`BF16_GATE_TOL`, or the override ``EEG_TPU_BF16_GATE_TOL``."""
    return _env_tolerance("EEG_TPU_BF16_GATE_TOL", BF16_GATE_TOL)


def int8_gate_tolerance() -> float:
    """:data:`INT8_GATE_TOL`, or the override ``EEG_TPU_INT8_GATE_TOL``."""
    return _env_tolerance("EEG_TPU_INT8_GATE_TOL", INT8_GATE_TOL)


def precision_gate_tolerance(precision: str) -> float:
    """The measured-deviation gate of one non-f32 precision rung."""
    if precision == "bf16":
        return bf16_gate_tolerance()
    if precision == "int8":
        return int8_gate_tolerance()
    if precision == "int4":
        from . import quant

        return quant.int4_gate_tolerance()
    raise ValueError(
        f"precision {precision!r} has no accuracy gate (f32 IS the reference)"
    )


def subband_group_bounds(feature_size: int):
    """The per-subband column groups of one channel's ``feature_size``
    coefficients, as half-open ``((lo, hi), ...)``: the eegdsp cascade
    layout ``[aK | dK | ... | d1]``, i.e. (0,1), (1,2), (2,4), (4,8),
    (8,16) for K = 16. Each group gets its own scale, so the coarse
    approximation coefficient does not crush the fine detail bands."""
    if feature_size < 1:
        raise ValueError(f"feature_size must be >= 1, got {feature_size}")
    bounds = [(0, 1)]
    lo = 1
    while lo < feature_size:
        hi = min(feature_size, lo * 2)
        bounds.append((lo, hi))
        lo = hi
    return tuple(bounds)


def quantize_levels(rows: torch.Tensor, feature_size: int, qmax: float):
    """Symmetric per-(row, channel, subband group) quantization of
    ``(n, C*K)`` float32 feature rows at ``qmax`` levels. Returns
    ``(levels (n, C*K) float32 integers in [-qmax, qmax], scales
    (n_groups, n, C))``. Scales are per row, so a row's levels do not
    depend on the other rows; rounding is deterministic (half to even)."""
    n = rows.shape[0]
    K = int(feature_size)
    C = rows.shape[1] // K
    x = rows.reshape(n, C, K)
    levels, scales = [], []
    for lo, hi in subband_group_bounds(K):
        g = x[:, :, lo:hi]
        m = g.abs().amax(dim=2)
        s = m / torch.full_like(m, qmax)
        s = torch.clamp(s, min=1e-30)  # all-zero group: 0 / s stays 0
        q = torch.clamp(torch.round(g / s[..., None]), -qmax, qmax)
        # integer levels, as the JAX package's int8 cast makes them: a
        # level of -0.0 becomes 0.0, so q * s carries no negative zero
        levels.append(q.to(torch.int8).to(torch.float32))
        scales.append(s)
    return torch.cat(levels, dim=2).reshape(n, C * K), torch.stack(scales)


def quantize_dequantize(rows: torch.Tensor, feature_size: int, qmax: float):
    """:func:`quantize_levels`, then back to float32 (``q * s``): returns
    ``(dequantized rows (n, C*K), scales (n_groups, n, C))``. An all-zero
    group stays exactly zero."""
    q, scales = quantize_levels(rows, feature_size, qmax)
    n = rows.shape[0]
    K = int(feature_size)
    C = rows.shape[1] // K
    q = q.reshape(n, C, K)
    outs = [q[:, :, lo:hi] * scales[i][..., None]
            for i, (lo, hi) in enumerate(subband_group_bounds(K))]
    return torch.cat(outs, dim=2).reshape(n, C * K), scales


def quantize_dequantize_int8(rows: torch.Tensor, feature_size: int):
    """The int8 rung's round trip (qmax 127): see :func:`quantize_dequantize`."""
    return quantize_dequantize(rows, feature_size, INT8_QMAX)


def int8_feature_path(rows: torch.Tensor, feature_size: int) -> torch.Tensor:
    """The int8 rung applied to finished f32 rows: the dequantized rows."""
    return quantize_dequantize_int8(rows, feature_size)[0]


def feature_precision_gate(
    rows,
    f32_rows,
    precision: str = "bf16",
    tolerance: Optional[float] = None,
) -> dict:
    """The per-run accuracy gate of every non-f32 rung: max abs deviation
    of the rung's rows from the f32 rows on the same windows, against the
    rung's tolerance. Returns ``{"precision", "max_abs_dev",
    "tolerance", "ok", "rows_checked"}``."""
    tol = precision_gate_tolerance(precision) if tolerance is None else float(tolerance)
    if isinstance(rows, torch.Tensor):
        rows = rows.detach().cpu().numpy()
    if isinstance(f32_rows, torch.Tensor):
        f32_rows = f32_rows.detach().cpu().numpy()
    rows = np.asarray(rows, np.float32)
    f32_rows = np.asarray(f32_rows, np.float32)
    if rows.shape != f32_rows.shape:
        raise ValueError(f"gate rows misaligned: {rows.shape} vs {f32_rows.shape}")
    dev = float(np.max(np.abs(rows - f32_rows))) if rows.size else 0.0
    return {
        "precision": str(precision),
        "max_abs_dev": dev,
        "tolerance": tol,
        "ok": bool(dev <= tol),
        "rows_checked": int(rows.shape[0]),
    }
