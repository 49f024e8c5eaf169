"""Per-subband wavelet statistics (the seizure workload's ``fe=``).

Port of the JAX package's ``features/subband.py``. The P300 extractor
(``features/wavelet.py``) keeps the first 16 raw DWT coefficients; the
seizure workload takes, per decomposition subband, summary statistics
(energy, mean, standard deviation) of the detail and approximation
coefficients. The ``fe=`` grammar selects it::

    fe=dwt-<family>:level=<L>[:stats=<s1>,<s2>,...]

e.g. ``fe=dwt-4:level=4:stats=energy,std``. ``family`` is the 0..17
eegdsp wavelet index of the plain ``dwt-<n>`` names
(``ops/eegdsp_compat.py``); ``level`` is the decomposition depth (each
level halves the length and needs at least ``len(filter)`` samples);
``stats`` defaults to ``energy``.

Feature layout: channel-major, then subband (``[a_L, d_L, ..., d_1]``:
approximation first, details coarsest to finest), then stat; the row is
L2-normalized by the reference's sequential fold
(``ops/dwt_host.l2_normalize_seq``).

Everything is float64 numpy on the host, as in the JAX package, whose
rows these equal bit for bit: :meth:`SubbandWaveletFeatures.extract_batch`
returns a numpy array, and its callers move the rows to the run's device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import base
from ..ops import dwt_host, eegdsp_compat
from ..utils.device import resolve_device

#: the per-subband statistics the grammar accepts, in canonical order
STAT_NAMES = ("energy", "mean", "std")


class SubbandWaveletFeatures(base.FeatureExtraction):
    """DWT decomposition and per-subband statistics per channel.

    ``device`` is kept for the registry's calling convention (and is the
    device the run's callers move the rows to); the extraction itself
    runs on the host."""

    def __init__(
        self,
        name: int = 8,
        level: int = 4,
        stats: Sequence[str] = ("energy",),
        channels: Tuple[int, ...] = (1, 2, 3),
        device: Optional[Union[str, torch.device]] = None,
    ):
        if not (0 <= int(name) <= 17):
            # the reference's WaveletTransform validation range
            raise ValueError("Wavelet Name must be >= 0 and <= 17")
        if int(level) < 1:
            raise ValueError(f"level must be >= 1, got {level}")
        stats = tuple(stats)
        if not stats:
            raise ValueError("stats set must not be empty")
        for s in stats:
            if s not in STAT_NAMES:
                raise ValueError(
                    f"unknown subband stat {s!r}; choose from {'/'.join(STAT_NAMES)}"
                )
        if len(set(stats)) != len(stats):
            raise ValueError(f"stats set repeats an entry: {stats}")
        self.name = int(name)
        self.level = int(level)
        self.stats = stats
        self.channels = tuple(channels)  # 1-based, like WaveletTransform
        self.device = resolve_device(device)

    def cache_id(self) -> Tuple:
        """The full extractor configuration: wavelet family, level, stat
        set and channel selection (the JAX package's tuple)."""
        return ("dwt-subband", self.name, self.level, self.stats, self.channels)

    @property
    def feature_dimension(self) -> int:
        # level details + the final approximation, per channel, per stat
        return len(self.channels) * (self.level + 1) * len(self.stats)

    def _decompose(self, signal: np.ndarray) -> list:
        """``[a_L, d_L, ..., d_1]`` subband arrays over the last axis (the
        cascade of ``dwt_host.fwt_subbands``, depth-bounded); a window too
        short for the requested level raises."""
        h, g = eegdsp_compat.filter_pair(self.name)
        a, details = dwt_host.fwt_subbands(
            np.asarray(signal, dtype=np.float64), h, g, max_levels=self.level
        )
        if len(details) < self.level:
            raise ValueError(
                f"window of {signal.shape[-1]} samples supports only "
                f"{len(details)} decomposition levels for wavelet "
                f"family {self.name} ({len(h)} taps); "
                f"level={self.level} requested"
            )
        return [a] + details[::-1]

    def extract_batch(self, epochs: np.ndarray) -> np.ndarray:
        """(n, C, T) epochs -> (n, feature_dimension) float64 numpy rows."""
        x = np.asarray(epochs, dtype=np.float64)
        ch_idx = [c - 1 for c in self.channels]
        if ch_idx != list(range(x.shape[1])):
            x = x[:, ch_idx, :]
        cols = []
        for band in self._decompose(x):  # each (n, C, band_len)
            for stat in self.stats:
                if stat == "energy":
                    # the reference's sequential sum-of-squares fold
                    cols.append(dwt_host._seq_dot(band, band))
                elif stat == "mean":
                    cols.append(band.mean(axis=-1))
                else:  # std (population)
                    cols.append(band.std(axis=-1))
        # (n, C, bands*stats) -> channel-major flatten, band/stat inner
        flat = np.stack(cols, axis=-1).reshape(x.shape[0], -1)
        return dwt_host.l2_normalize_seq(flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, SubbandWaveletFeatures) and self.cache_id() == other.cache_id()

    def __hash__(self) -> int:
        return hash(self.cache_id())

    def __repr__(self) -> str:
        return (
            f"DWT-SUBBAND: FAMILY: {self.name} LEVEL: {self.level} "
            f"STATS: {','.join(self.stats)}"
        )
