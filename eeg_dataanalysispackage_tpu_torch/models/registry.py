"""``train_clf=`` / ``load_clf=`` registry.

The reference's classifier switch (PipelineBuilder.java:156-169): svm,
logreg, dt, rf, nn, and the JAX package's gbt and ``-tpu`` tree growers
(``models/trees_device.py``, on the features' device); unknown names
raise the reference's message.
"""

from __future__ import annotations

from typing import Callable, Dict

from . import base, linear, nn, trees

_REGISTRY: Dict[str, Callable[[], base.Classifier]] = {
    "logreg": linear.LogisticRegressionClassifier,
    "svm": linear.SVMClassifier,
    "dt": trees.DecisionTreeClassifier,
    "rf": trees.RandomForestClassifier,
    "dt-tpu": lambda: trees.DecisionTreeClassifier(backend="device"),
    "rf-tpu": lambda: trees.RandomForestClassifier(backend="device"),
    "gbt": trees.GradientBoostedTreesClassifier,
    "gbt-tpu": lambda: trees.GradientBoostedTreesClassifier(backend="device"),
    "nn": nn.NeuralNetworkClassifier,
}

#: the JAX package's classifier families not yet ported (see ROADMAP.md)
NOT_PORTED: tuple = ()


def create(name: str) -> base.Classifier:
    if name in NOT_PORTED:
        raise ValueError(f"classifier {name!r} is not yet ported; see ROADMAP.md")
    if name not in _REGISTRY:
        raise ValueError("Unsupported classifier argument")
    return _REGISTRY[name]()
