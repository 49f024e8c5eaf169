"""Classifier plugin boundary (reference: Classification/IClassifier.java).

The reference's seam — ``set_config`` with opaque ``config_*`` string
maps, train, test, save, load (IClassifier.java:43-85) — over feature
rows that already lie on the device.
"""

from __future__ import annotations

import abc
from typing import Dict

import numpy as np
import torch

from . import stats


class Classifier(abc.ABC):
    """Batched classifier over extracted feature rows."""

    # True for classifiers whose reference counterpart builds stats
    # from MulticlassMetrics' confusion matrix only (the MLlib paths)
    confusion_only_stats: bool = True

    def __init__(self) -> None:
        self.config: Dict[str, str] = {}

    def set_config(self, config: Dict[str, str]) -> None:
        self.config = dict(config)

    def test_features(
        self, features: torch.Tensor, targets: np.ndarray
    ) -> stats.ClassificationStatistics:
        """Evaluate on feature rows; the one place statistics are built
        from predictions."""
        predictions = self.predict(features).cpu().numpy()
        return stats.ClassificationStatistics.from_arrays(
            predictions,
            np.asarray(targets, dtype=np.float64),
            confusion_only=self.confusion_only_stats,
        )

    @abc.abstractmethod
    def fit(self, features: torch.Tensor, labels: torch.Tensor) -> None:
        """(n, d) features + (n,) {0,1} labels -> trained state."""

    @abc.abstractmethod
    def predict(self, features: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n,) float64 predicted labels on the features' device."""

    @abc.abstractmethod
    def save(self, path: str) -> None: ...

    @abc.abstractmethod
    def load(self, path: str) -> None: ...
