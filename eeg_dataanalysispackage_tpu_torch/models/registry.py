"""``train_clf=`` / ``load_clf=`` registry.

The reference's classifier switch (PipelineBuilder.java:156-169) for the
families ported so far (logreg, svm, nn); unknown names raise the
reference's message.
"""

from __future__ import annotations

from typing import Callable, Dict

from . import base, linear, nn

_REGISTRY: Dict[str, Callable[[], base.Classifier]] = {
    "logreg": linear.LogisticRegressionClassifier,
    "svm": linear.SVMClassifier,
    "nn": nn.NeuralNetworkClassifier,
}

#: the JAX package's other families, not yet ported (see ROADMAP.md)
NOT_PORTED = ("dt", "rf", "dt-tpu", "rf-tpu", "gbt", "gbt-tpu")


def create(name: str) -> base.Classifier:
    if name in NOT_PORTED:
        raise ValueError(f"classifier {name!r} is not yet ported; see ROADMAP.md")
    if name not in _REGISTRY:
        raise ValueError("Unsupported classifier argument")
    return _REGISTRY[name]()
