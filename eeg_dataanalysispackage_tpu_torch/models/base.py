"""Classifier plugin boundary (reference: Classification/IClassifier.java).

The reference's seam — ``set_feature_extraction``, ``train``, ``test``,
``set_config`` with opaque ``config_*`` string maps, ``save``, ``load``
(IClassifier.java:43-85). ``train`` and ``test`` take host epochs and
run the classifier's feature extractor on them; ``fit`` and
``test_features`` take feature rows that already lie on the device.
"""

from __future__ import annotations

import abc
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import stats
from ..features import base as features_base


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Classifier(abc.ABC):
    """Batched classifier over extracted feature rows."""

    # True for classifiers whose reference counterpart builds stats
    # from MulticlassMetrics' confusion matrix only (the MLlib paths)
    confusion_only_stats: bool = True

    def __init__(self) -> None:
        self.config: Dict[str, str] = {}
        self.fe: Optional[features_base.FeatureExtraction] = None
        #: wall seconds spent by train/test, by step: featurize, fit,
        #: predict (each device step ends in a sync)
        self.timings: Dict[str, float] = {}

    def set_config(self, config: Dict[str, str]) -> None:
        self.config = dict(config)

    def set_feature_extraction(self, fe: features_base.FeatureExtraction) -> None:
        self.fe = fe

    def train(self, epochs: np.ndarray, targets: np.ndarray,
              fe: features_base.FeatureExtraction) -> None:
        """Extract features from host ``epochs`` with ``fe`` and fit on
        them: the features reach :meth:`fit` as float32 rows on the
        extractor's device, as the JAX engine casts them."""
        self.fe = fe
        features = self._extract(epochs)
        t0 = time.perf_counter()
        labels = torch.as_tensor(
            np.asarray(targets, dtype=np.float64), dtype=torch.float32,
            device=features.device,
        )
        self.fit(features.to(torch.float32), labels)
        _sync(features.device)
        self._tick("fit", t0)

    def test(self, epochs: np.ndarray, targets: np.ndarray) -> stats.ClassificationStatistics:
        """Extract features from host ``epochs`` and evaluate on them."""
        features = self._extract(epochs)
        t0 = time.perf_counter()
        statistics = self.test_features(features, targets)
        self._tick("predict", t0)
        return statistics

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

    def _tick(self, step: str, t0: float) -> None:
        self.timings[step] = self.timings.get(step, 0.0) + time.perf_counter() - t0

    def _extract(self, epochs) -> torch.Tensor:
        if self.fe is None:
            raise ValueError("feature extraction not set")
        t0 = time.perf_counter()
        arr = np.asarray(epochs, dtype=np.float64)
        if arr.ndim == 2:  # single epoch
            arr = arr[None]
        features = self.fe.extract_batch(arr)
        _sync(features.device)
        self._tick("featurize", t0)
        return features

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
