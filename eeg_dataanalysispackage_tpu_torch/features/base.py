"""Feature-extraction plugin boundary.

The counterpart of the reference's ``IFeatureExtraction`` seam
(IFeatureExtraction.java:33-34), batched: an extractor maps
``(n, channels, samples)`` epochs to ``(n, feature_dim)`` feature rows
in one call, as a tensor on the extractor's device.
"""

from __future__ import annotations

import abc

import numpy as np
import torch


class FeatureExtraction(abc.ABC):
    """Batched feature extractor."""

    @abc.abstractmethod
    def extract_batch(self, epochs: np.ndarray) -> torch.Tensor:
        """(n, channels, samples) -> (n, feature_dim) on the extractor's
        device."""

    @property
    @abc.abstractmethod
    def feature_dimension(self) -> int:
        """Length of one feature vector (``getFeatureDimension``)."""

    def extract_features(self, epoch: np.ndarray) -> torch.Tensor:
        """Single-epoch adapter matching the reference signature."""
        return self.extract_batch(np.asarray(epoch)[None])[0]

    def cache_id(self) -> tuple:
        """The extractor's full static configuration as a hashable tuple:
        every knob that changes the feature values. Concrete extractors
        override; the default refuses."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a feature-cache "
            f"config identity"
        )
