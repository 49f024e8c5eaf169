"""Sliding windows over continuous EEG (the seizure workload's front end).

Port of the JAX package's ``epochs/sliding.py``, host numpy as there.
Epilepsy recordings have no stimuli: a fixed window slides over the
continuous signal and each window is labeled from clinician-annotated
seizure **intervals**. The output is the :class:`~.extractor.EpochBatch`
of the marker-locked path, so feature extraction, classifiers,
statistics and serving take it unchanged.

Interval annotations are ordinary ``.vmrk`` markers of type ``Seizure``
with the description ``on`` / ``off``::

    Mk12=Seizure,on,84000,1,0
    Mk13=Seizure,off,91500,1,0

An onset without a matching ``off`` runs to the end of the recording;
other marker types are ignored.

Labeling: window ``[s, s+window)`` is positive iff the fraction of its
samples inside any seizure interval is ``>= label_overlap`` (default
0.5). There is no balance scan and no baseline correction: class
imbalance is the workload's defining property, and a continuous window
has no prestimulus segment.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from ..io.brainvision import Marker
from . import extractor

#: the .vmrk marker type that carries interval annotations
SEIZURE_MARKER_KIND = "Seizure"


@dataclasses.dataclass(frozen=True)
class SlidingConfig:
    """One sliding-window configuration: ``window`` and ``stride`` in
    samples, ``label_overlap`` the in-interval fraction at which a window
    labels positive."""

    window: int = 512
    stride: int = 256
    label_overlap: float = 0.5

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.stride < 1:
            raise ValueError(f"stride must be >= 1, got {self.stride}")
        if not (0.0 < self.label_overlap <= 1.0):
            raise ValueError(
                f"label_overlap must be in (0, 1], got {self.label_overlap}"
            )


def seizure_intervals(markers: Sequence[Marker], n_samples: int) -> List[Tuple[int, int]]:
    """Ordered ``[start, end)`` sample intervals from the Seizure markers.

    Markers pair in position order: each ``on`` opens an interval, the
    next ``off`` closes it. A dangling ``on`` closes at ``n_samples``; an
    ``off`` with no open interval is ignored. Intervals are clamped to
    ``[0, n_samples)`` and empty ones dropped.
    """
    events = sorted(
        ((m.position, m.stimulus.strip().lower())
         for m in markers if m.kind == SEIZURE_MARKER_KIND),
        key=lambda e: e[0],
    )
    out: List[Tuple[int, int]] = []
    open_start = None
    for pos, what in events:
        if what == "on":
            if open_start is None:
                open_start = pos
        elif what == "off" and open_start is not None:
            if pos > open_start:
                out.append((max(0, open_start), min(int(pos), int(n_samples))))
            open_start = None
    if open_start is not None and open_start < n_samples:
        out.append((max(0, int(open_start)), int(n_samples)))
    return [iv for iv in out if iv[1] > iv[0]]


def window_starts(n_samples: int, window: int, stride: int) -> np.ndarray:
    """Start samples of every FULL window: 0, stride, ... while
    ``start + window <= n_samples`` (a trailing partial window is
    dropped)."""
    if n_samples < window:
        return np.zeros((0,), dtype=np.int64)
    return np.arange(0, n_samples - window + 1, stride, dtype=np.int64)


def overlap_fractions(
    starts: np.ndarray, window: int, intervals: Sequence[Tuple[int, int]]
) -> np.ndarray:
    """Per-window fraction of samples inside any interval (the intervals
    of :func:`seizure_intervals` do not overlap, so their overlaps sum)."""
    starts = np.asarray(starts, dtype=np.int64)
    covered = np.zeros(starts.shape, dtype=np.float64)
    for lo, hi in intervals:
        overlap = np.minimum(starts + window, hi) - np.maximum(starts, lo)
        covered += np.maximum(overlap, 0)
    return covered / float(window)


def extract_sliding_epochs(
    channels: np.ndarray, markers: Sequence[Marker], config: SlidingConfig
) -> extractor.EpochBatch:
    """Scaled ``(n_channels, n_samples)`` float64 channels
    (``Recording.read_channels``) and their interval annotations ->
    labeled windows: ``epochs`` the raw ``(n, n_channels, window)``
    float64 slices, ``targets`` the 0/1 overlap labels, and
    ``stimulus_indices`` the window start samples (the serving path cuts
    the same windows from them)."""
    channels = np.asarray(channels, dtype=np.float64)
    n_samples = channels.shape[1]
    starts = window_starts(n_samples, config.window, config.stride)
    if len(starts) == 0:
        return extractor.EpochBatch(
            epochs=np.zeros((0, channels.shape[0], config.window), dtype=np.float64),
            targets=np.zeros((0,), dtype=np.float64),
            stimulus_indices=np.zeros((0,), dtype=int),
        )
    intervals = seizure_intervals(markers, n_samples)
    fractions = overlap_fractions(starts, config.window, intervals)
    targets = (fractions >= config.label_overlap).astype(np.float64)
    # one strided gather for every window: (n, C, window)
    idx = starts[:, None] + np.arange(config.window)[None, :]
    epochs = np.ascontiguousarray(channels[:, idx].transpose(1, 0, 2))
    return extractor.EpochBatch(
        epochs=epochs, targets=targets, stimulus_indices=starts.astype(int),
    )
