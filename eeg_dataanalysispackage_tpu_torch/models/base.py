"""Classifier plugin boundary (reference: Classification/IClassifier.java).

The reference's seam — ``set_feature_extraction``, ``train``, ``test``,
``set_config`` with opaque ``config_*`` string maps, ``save``, ``load``
(IClassifier.java:43-85). ``train`` and ``test`` take host epochs and
run the classifier's feature extractor on them; ``fit`` and
``test_features`` take feature rows that already lie on the device.
``fit_elastic`` and ``train_elastic`` are their checkpointed forms
(``elastic=true``): the SGD family and the network override
``fit_elastic`` with chunked training; every other classifier trains
monolithically, with a logged note.
"""

from __future__ import annotations

import abc
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import stats
from ..features import base as features_base

logger = logging.getLogger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Classifier(abc.ABC):
    """Batched classifier over extracted feature rows."""

    # True for classifiers whose reference counterpart builds stats
    # from MulticlassMetrics' confusion matrix only (the MLlib paths)
    confusion_only_stats: bool = True

    #: the dtype :meth:`train` casts the extracted rows to before
    #: :meth:`fit`: float32, as the JAX engines cast them; None keeps the
    #: extractor's own dtype, as the JAX package hands it to every
    #: ``fit`` (the tree families bin float64 host features)
    fit_dtype: Optional[torch.dtype] = torch.float32

    def __init__(self) -> None:
        self.config: Dict[str, str] = {}
        self.fe: Optional[features_base.FeatureExtraction] = None
        #: wall seconds spent by train/test, by step: featurize, fit,
        #: predict (each device step ends in a sync)
        self.timings: Dict[str, float] = {}
        #: the (n,) float64 predictions of the last test_features call
        self.last_predictions: Optional[np.ndarray] = None

    def set_config(self, config: Dict[str, str]) -> None:
        self.config = dict(config)

    def set_feature_extraction(self, fe: features_base.FeatureExtraction) -> None:
        self.fe = fe

    def train(self, epochs: np.ndarray, targets: np.ndarray,
              fe: features_base.FeatureExtraction) -> None:
        """Extract features from host ``epochs`` with ``fe`` and fit on
        them: the features reach :meth:`fit` on the extractor's device,
        cast to :attr:`fit_dtype` where it is set."""
        self.fe = fe
        features = self._extract(epochs)
        t0 = time.perf_counter()
        labels = torch.as_tensor(
            np.asarray(targets, dtype=np.float64), dtype=torch.float32,
            device=features.device,
        )
        if self.fit_dtype is not None:
            features = features.to(self.fit_dtype)
        self.fit(features, labels)
        _sync(features.device)
        self._tick("fit", t0)

    def train_elastic(self, epochs: np.ndarray, targets: np.ndarray,
                      fe: features_base.FeatureExtraction, manager, **elastic_kwargs) -> None:
        """:meth:`train` routed through :meth:`fit_elastic`: the host epoch
        path's checkpointed, restartable training."""
        self.fe = fe
        features = self._extract(epochs)
        t0 = time.perf_counter()
        labels = torch.as_tensor(
            np.asarray(targets, dtype=np.float64), dtype=torch.float32,
            device=features.device,
        )
        if self.fit_dtype is not None:
            features = features.to(self.fit_dtype)
        self.fit_elastic(features, labels, manager, **elastic_kwargs)
        _sync(features.device)
        self._tick("fit", t0)

    def fit_elastic(self, features: torch.Tensor, labels: torch.Tensor, manager,
                    save_every: int = 1, max_restarts: int = 3, sentinel=None,
                    chunk_iters: int = 10, probe_on_failure: bool = True) -> None:
        """:meth:`fit` with mid-train checkpoints where the training loop
        has steps; a classifier whose training is one opaque program (the
        tree growers) trains monolithically: there is no intermediate
        state to checkpoint."""
        del manager, save_every, max_restarts, sentinel, chunk_iters, probe_on_failure
        logger.info(
            "%s has no steppable training loop; elastic mode trains "
            "monolithically (no mid-train checkpoints)", type(self).__name__,
        )
        self.fit(features, labels)

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
        from predictions (kept in :attr:`last_predictions`)."""
        predictions = self.predict(features).cpu().numpy()
        self.last_predictions = predictions
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
        if isinstance(features, np.ndarray):
            # a host extractor's rows (features/subband.py) go to its device
            features = torch.from_numpy(features).to(self.fe.device)
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
