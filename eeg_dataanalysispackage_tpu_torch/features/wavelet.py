"""DWT feature extraction (the reference's ``fe=dwt-8``).

Parity surface of ``FeatureExtraction/WaveletTransform.java``: per
channel, take ``epoch[ch][skip : skip+epoch_size]``, run the eegdsp
FWT, keep the first ``feature_size`` coefficients, concatenate over
channels, L2-normalize the whole vector (WaveletTransform.java:108-141).
Constructor defaults and setter validation ranges mirror
WaveletTransform.java:47-87,160-212.

Backends (``extract_batch`` returns a tensor on the extractor's device):

- ``host`` (``fe=dwt-8``): numpy float64 with the reference's exact
  accumulation order (``ops/dwt_host.py``), bit-equal to the JAX
  package's host backend; float64 features. An all-zero epoch gives
  Java's NaN row.
- ``xla`` (``fe=dwt-8-tpu``): the cascade contraction in PyTorch on the
  device (``ops/dwt.make_batched_extractor``), float32.
- ``xla-compact`` (``fe=dwt-8-tpu-compact``): the same contraction over
  epochs whose channels and analysis window were cut on the host before
  the copy, so only the window crosses to the device; float32.
- ``pallas`` (``fe=dwt-8-pallas``): the epoch-features CUDA kernel
  (``ops/dwt_cuda.py``) on a CUDA device, its plain version on the CPU;
  float32.
- ``xla-bf16`` and ``xla-compact-bf16`` (``fe=dwt-8-tpu-bf16``,
  ``-tpu-compact-bf16``): the two contractions in bfloat16, the JAX
  package's dtype sequence: the epochs (for the compact form, the window
  sliced first and cast to float32) are cast to bfloat16 on the host, so
  only the bf16 buffer crosses to the device; the cascade matrix is
  bf16, the product and the L2 normalize run in bf16, and the rows come
  back as float32. About 2e-3 from the float32 features (the JAX
  package's ``BF16_GATE_TOL`` is 5e-3).

The float32 backends cast float64 epochs to float32 on the host, before
the copy: the rounding matches the JAX package's and the copy is half
the bytes.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from . import base
from ..ops import dwt, dwt_cuda, dwt_host
from ..utils import constants
from ..utils.device import resolve_device

BACKENDS = ("host", "xla", "xla-compact", "pallas", "xla-bf16", "xla-compact-bf16")


class WaveletTransform(base.FeatureExtraction):
    DOWN_SMPL_FACTOR = 1  # WaveletTransform.java:57 (unused, always 1)

    def __init__(
        self,
        name: int = 8,
        epoch_size: int = 512,
        skip_samples: int = 175,
        feature_size: int = 16,
        channels: tuple = (1, 2, 3),
        backend: str = "host",
        device: Optional[Union[str, torch.device]] = None,
    ):
        self._extractor = None
        self.set_wavelet_name(name)
        self.set_epoch_size(epoch_size)
        self.set_skip_samples(skip_samples)
        self.set_feature_size(feature_size)
        self.channels = tuple(channels)  # 1-based, WaveletTransform.java:47
        self.backend = backend  # property: validates, drops the extractor
        self.device = resolve_device(device)

    @property
    def backend(self) -> str:
        return self._backend

    @backend.setter
    def backend(self, value: str) -> None:
        if value not in BACKENDS:
            raise ValueError(f"unknown backend {value!r}; use one of {BACKENDS}")
        self._backend = value
        self._extractor = None

    # -- setters with the reference's validation ranges ---------------

    def set_wavelet_name(self, name: int) -> None:
        if 0 <= name <= 17:
            self.name = name
            self._extractor = None
        else:
            raise ValueError("Wavelet Name must be >= 0 and <= 17")

    def set_epoch_size(self, epoch_size: int) -> None:
        if 0 < epoch_size <= constants.POSTSTIMULUS_SAMPLES:
            self.epoch_size = epoch_size
            self._extractor = None
        else:
            raise ValueError(
                f"Epoch Size must be > 0 and <= {constants.POSTSTIMULUS_SAMPLES}"
            )

    def set_skip_samples(self, skip_samples: int) -> None:
        if 0 < skip_samples <= constants.POSTSTIMULUS_SAMPLES:
            self.skip_samples = skip_samples
            self._extractor = None
        else:
            raise ValueError(
                f"Skip Samples must be > 0 and <= {constants.POSTSTIMULUS_SAMPLES}"
            )

    def set_feature_size(self, feature_size: int) -> None:
        if 0 < feature_size <= 1024:
            self.feature_size = feature_size
            self._extractor = None
        else:
            raise ValueError("Feature Size must be > 0 and <= 1024")

    # -- extraction ----------------------------------------------------

    @property
    def feature_dimension(self) -> int:
        # WaveletTransform.java:149-152
        return self.feature_size * len(self.channels) // self.DOWN_SMPL_FACTOR

    def _selected(self, x: np.ndarray) -> np.ndarray:
        """``x`` with the configured channels, skipping the no-op gather."""
        ch_idx = [c - 1 for c in self.channels]
        return x if ch_idx == list(range(x.shape[1])) else x[:, ch_idx, :]

    def extract_batch(self, epochs: np.ndarray) -> torch.Tensor:
        n_samples = np.asarray(epochs).shape[-1]
        if self.skip_samples + self.epoch_size > n_samples:
            # the Java reference fails loudly here (AIOOBE); don't let
            # slicing silently truncate the analysis window
            raise ValueError(
                f"skip_samples ({self.skip_samples}) + epoch_size "
                f"({self.epoch_size}) exceeds the epoch length ({n_samples})"
            )
        if self.backend == "host":
            x = np.asarray(epochs, dtype=np.float64)
            sl = x[:, [c - 1 for c in self.channels],
                   self.skip_samples : self.skip_samples + self.epoch_size]
            coeffs = dwt_host.dwt_coefficients(sl, self.name, self.feature_size)
            feats = dwt_host.l2_normalize_seq(coeffs.reshape(x.shape[0], -1))
            return torch.from_numpy(feats).to(self.device)
        bf16 = self.backend.endswith("-bf16")
        dtype = torch.bfloat16 if bf16 else torch.float32
        if self.backend in ("xla-compact", "xla-compact-bf16"):
            if self._extractor is None:
                self._extractor = dwt.make_compact_extractor(
                    self.name, self.epoch_size, self.feature_size, device=self.device,
                    dtype=dtype,
                )
            # slice on the host and before the float32 copy: only the
            # window crosses to the device (bf16: cast on the host too)
            x = self._selected(np.asarray(epochs))
            x = np.ascontiguousarray(
                x[:, :, self.skip_samples : self.skip_samples + self.epoch_size],
                dtype=np.float32,
            )
            return self._extractor(torch.from_numpy(x).to(dtype))
        if self.backend in ("xla", "xla-bf16"):
            if self._extractor is None:
                self._extractor = dwt.make_batched_extractor(
                    self.name, self.epoch_size, self.skip_samples, self.feature_size,
                    channels=self.channels, device=self.device, dtype=dtype,
                )
            if bf16:
                # the epochs cast to bf16 on the host, from their own
                # dtype: the device-resident buffer is the bf16 one
                return self._extractor(torch.from_numpy(np.asarray(epochs)).to(dtype))
            x = np.ascontiguousarray(epochs, dtype=np.float32)
            return self._extractor(torch.from_numpy(x))
        # pallas: the channel gather on the host, as the JAX package does
        x = np.ascontiguousarray(self._selected(np.asarray(epochs, np.float32)))
        return dwt_cuda.epoch_features_cuda(
            torch.from_numpy(x).to(self.device), self.name, self.skip_samples,
            self.epoch_size, self.feature_size,
        )

    def cache_id(self) -> tuple:
        """Full config identity: wavelet family, window geometry,
        coefficient count, channel set and precision class, as the JAX
        package keys it. The backend itself is absent (the float32 and
        better backends compute the same features to rung tolerance),
        but the bf16 backends key apart: their features are ~2e-3 from
        the float32 ones."""
        precision = "bf16" if self.backend.endswith("-bf16") else "f32"
        return (
            "dwt", self.name, self.epoch_size, self.skip_samples,
            self.feature_size, tuple(self.channels), precision,
        )

    # -- config equality (WaveletTransform.java:223-244) ---------------

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, WaveletTransform)
            and self.epoch_size == other.epoch_size
            and self.skip_samples == other.skip_samples
            and self.name == other.name
            and self.feature_size == other.feature_size
        )

    def __hash__(self) -> int:
        result = self.epoch_size
        for v in (self.skip_samples, self.name, self.feature_size):
            result = 31 * result + v
        return result

    def __repr__(self) -> str:
        return (
            f"DWT: EPOCH_SIZE: {self.epoch_size} FEATURE_SIZE: "
            f"{self.feature_size} WAVELETNAME: {self.name} "
            f"SKIP_SAMPLES: {self.skip_samples}"
        )
