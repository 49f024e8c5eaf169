"""On-device ingest: raw recording samples -> features, with no host epochs.

Division of labour:

- host: marker metadata only — stimulus digits, window validity (Java's
  copyOfRange rules) and the order-dependent class-balance scan, which
  depend only on the marker sequence, never on sample values —
  producing an :class:`IngestPlan`;
- device: everything touching the waveform. The unscaled int16 samples
  (or, for other binary formats, the scaled float32 samples) are staged
  to the card once per recording (:func:`stage_raw`), and
  the fused featurizer (``ops/ingest_cuda.py``) scales, cuts, baseline-
  corrects, contracts and normalizes in one kernel.

:func:`ingest_features_plain` is that kernel's plain PyTorch version
(the gather featurizer of the JAX package's
``make_device_ingest_featurizer``), at each ``precision=`` rung; the
kernel's wrapper takes it for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernel against it.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import decode_ingest, dwt, plan_cache, quant
from ..epochs import extractor
from ..epochs.extractor import BalanceState
from ..io.brainvision import Marker, Recording
from ..utils import constants
from ..utils.device import host_to_device


def _round_capacity(n: int, multiple: int) -> int:
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


def stage_raw(
    recording: Recording,
    channel_indices: Sequence[int],
    device: torch.device,
    sample_multiple: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Stage a recording's channels on ``device`` for fused ingest.

    Returns (raw (C, S_padded), resolutions float32 (C,), n_samples).
    INT_16 recordings stage their UNSCALED int16 samples (half the
    float32 transfer bytes); other formats fall back to the already
    scaled float32 channels with unit resolutions, as the JAX package
    does. The sample axis is zero-padded up to a multiple of
    ``sample_multiple``. The channels are written straight into one
    zero-padded host buffer, pinned on a card, which reaches the card by
    one non-blocking copy on the current stream (the overlap producer's
    own under ``overlap=true``); PyTorch's caching host allocator hands
    the pinned block out again only once that copy has run. The padding
    is semantically free: window validity is decided against the true
    ``n_samples``, and windows overhanging the end read zeros exactly as
    Java's copyOfRange zero-pads.
    """
    device = torch.device(device)
    pinned = device.type == "cuda"
    C, n_samples = len(channel_indices), recording.num_samples
    padded = _round_capacity(n_samples, sample_multiple)
    try:
        host = torch.empty((C, padded), dtype=torch.int16, pin_memory=pinned)
        recording.raw_int16(channel_indices, out=host.numpy())
        res = recording.resolutions(channel_indices)
    except TypeError:
        host = torch.empty((C, padded), dtype=torch.float32, pin_memory=pinned)
        host.numpy()[:, :n_samples] = recording.read_channels(channel_indices)
        res = np.ones(C, dtype=np.float32)
    host.numpy()[:, n_samples:] = 0
    return host.to(device, non_blocking=pinned), host_to_device(res, device), n_samples


@dataclasses.dataclass
class IngestPlan:
    """Host-side metadata for one recording's device ingest.

    Arrays are padded to ``capacity`` (a multiple of 64); ``mask``
    marks the real rows.
    """

    positions: np.ndarray  # (capacity,) int32 marker positions (kept rows)
    mask: np.ndarray  # (capacity,) bool — True for real epochs
    targets: np.ndarray  # (n_kept,) float64 of {0.0, 1.0}
    stimulus_indices: np.ndarray  # (n_kept,) int

    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def n_kept(self) -> int:
        return int(self.mask.sum())


def plan_ingest(
    markers: Sequence[Marker],
    guessed_number: int,
    n_samples: int,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    post: int = constants.POSTSTIMULUS_SAMPLES,
    balance: Optional[BalanceState] = None,
    capacity_multiple: int = 64,
) -> IngestPlan:
    """Marker metadata -> padded ingest plan.

    Reference semantics (OffLineDataProvider.java:200-265): every
    marker is considered; windows starting out of range are dropped
    (start < 0 or start > n_samples); the label is 1.0 iff
    stimulus_index + 1 == guessed_number; the global balance scan
    decides retention.

    The plan is memoized in ``ops/plan_cache`` (``ingest_plan``), keyed
    on the in-range marker positions and stimulus indices, the guessed
    number, the capacity multiple and the balance counters the scan
    starts from; a hit returns the cached plan and leaves ``balance``
    at the counters the scan ended with.
    """
    del post  # the window length never decides retention
    positions = np.array([m.position for m in markers], dtype=np.int64)
    stim_idx = np.array([m.stimulus_index() for m in markers], dtype=int)

    valid = extractor.valid_window_starts(positions, pre, n_samples)
    positions, stim_idx = positions[valid], stim_idx[valid]

    balance = balance or BalanceState()
    entering = (balance.n_targets, balance.n_nontargets)
    key = plan_cache.digest(
        positions, stim_idx,
        extra=(int(guessed_number), int(capacity_multiple), *entering),
    )
    plan, leaving = _PLANS.get_or_build(
        key, lambda: _build_plan(positions, stim_idx, guessed_number, capacity_multiple,
                                 entering),
    )
    balance.n_targets, balance.n_nontargets = leaving
    return plan


#: the memo of :func:`plan_ingest`
_PLANS = plan_cache.cache("ingest_plan")


def _build_plan(positions: np.ndarray, stim_idx: np.ndarray, guessed_number: int,
                capacity_multiple: int, entering: Tuple[int, int]):
    """:func:`plan_ingest`'s work on the in-range markers: the balance
    scan from the ``entering`` counters, then the padded plan. Returns
    ``(plan, counters the scan ends with)``."""
    is_target = (stim_idx + 1) == guessed_number
    balance = BalanceState()
    balance.n_targets, balance.n_nontargets = entering
    keep = balance.scan(is_target)

    kept = positions[keep]
    if kept.size and kept.max() > np.iinfo(np.int32).max:
        raise ValueError(
            f"marker position {int(kept.max())} exceeds int32 range; "
            "corrupt .vmrk?"
        )
    capacity = _round_capacity(kept.shape[0], capacity_multiple)
    padded = np.zeros(capacity, dtype=np.int32)
    padded[: kept.shape[0]] = kept
    mask = np.zeros(capacity, dtype=bool)
    mask[: kept.shape[0]] = True
    plan = IngestPlan(
        positions=padded,
        mask=mask,
        targets=is_target[keep].astype(np.float64),
        stimulus_indices=stim_idx[keep],
    )
    return plan, (balance.n_targets, balance.n_nontargets)


@lru_cache(maxsize=None)
def ingest_matrix(
    wavelet_index: int = 8,
    epoch_size: int = 512,
    skip_samples: int = 175,
    feature_size: int = 16,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    window_len: Optional[int] = None,
    fold_baseline: bool = True,
) -> np.ndarray:
    """(window_len, feature_size) float32 operator E composing the
    per-window reference chain into one matrix:

        features = (x - mean(x[:pre])) @ W_pad = x @ E,
        E = W_pad - (1/pre) * ones[:pre] (x) colsum(W)

    with W_pad the cascade matrix placed at rows
    ``[pre + skip, pre + skip + epoch_size)``. ``fold_baseline=False``
    returns just ``W_pad``: float32 kernels subtract the window mean
    explicitly instead, because the folded form cancels catastrophically
    on real EEG DC offsets.
    """
    live = pre + skip_samples + epoch_size
    wl = live if window_len is None else window_len
    if wl < live:
        raise ValueError(f"window_len {wl} < live window {live}")
    W = dwt.cascade_matrix(wavelet_index, epoch_size, feature_size)
    E = np.zeros((wl, feature_size), dtype=np.float64)
    E[pre + skip_samples : live] = W
    if fold_baseline:
        E[:pre] -= W.sum(axis=0) / pre
    return E.astype(np.float32)


def ingest_features_plain(
    raw: torch.Tensor,
    resolutions: torch.Tensor,
    starts: torch.Tensor,
    operator: torch.Tensor,
    pre: int = constants.PRESTIMULUS_SAMPLES,
    skip_samples: int = 175,
    precision: str = "f32",
) -> torch.Tensor:
    """Plain PyTorch version of the fused ingest kernel.

    ``raw`` (C, S) int16 or float32, ``resolutions`` (C,) float32, ``starts``
    (n,) int32 window starts (``position - pre``), ``operator`` (E, K)
    float32 cascade matrix. Per window and channel: scale the samples by
    the resolution; read ``[start, start + pre)`` (baseline) and
    ``[start + pre + skip, start + pre + skip + E)`` (analysis), with
    samples at or past ``S`` reading 0; subtract the baseline mean from
    the analysis samples; contract with ``operator``; concatenate the
    channels and L2-normalize. Returns (n, C*K) float32 in input order.

    The baseline mean is accumulated in float64. For int16 samples the
    int16 x resolution products of one window sum exactly there, so the
    mean is the same whatever the summation order — the kernel does the
    same, and the two agree on it bit for bit at any DC offset. For
    float32 samples the sum need not be exact, and the kernel's mean may
    differ from this one by an ulp.

    ``precision``: ``"bf16"`` rounds the centred samples and the operator
    to bfloat16 and contracts them in float32 (products of bf16 values
    are exact in float32); ``"int8"`` and ``"int4"`` quantize the
    finished f32 rows (``decode_ingest.int8_feature_path``,
    ``quant.int4_feature_path``).
    """
    C, S = raw.shape
    E, K = operator.shape
    n = starts.shape[0]
    dev = raw.device
    offsets = torch.cat([
        torch.arange(pre, device=dev),
        pre + skip_samples + torch.arange(E, device=dev),
    ])
    idx = starts.to(torch.int64)[:, None] + offsets[None, :]  # (n, pre+E)
    inside = (idx >= 0) & (idx < S)
    samples = raw[:, idx.clamp(0, max(S - 1, 0))]  # (C, n, pre+E)
    scaled = samples.to(torch.float32) * resolutions[:, None, None]
    scaled = torch.where(inside, scaled, torch.zeros((), device=dev))
    base = scaled[..., :pre].to(torch.float64).mean(dim=-1).to(torch.float32)
    z = scaled[..., pre:] - base[..., None]  # (C, n, E)
    if precision == "bf16":
        z = z.to(torch.bfloat16).to(torch.float32)
        operator = operator.to(torch.bfloat16).to(torch.float32)
    coeffs = torch.einsum("cne,ek->nck", z, operator)
    rows = dwt.safe_l2_normalize(coeffs.reshape(n, C * K))
    if precision == "int8":
        return decode_ingest.int8_feature_path(rows, K)
    if precision == "int4":
        return quant.int4_feature_path(rows, K)
    return rows
