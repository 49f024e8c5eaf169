"""Logistic-regression and SVM classifiers (MLlib-SGD semantics).

Parity surfaces of ``Classification/LogisticRegressionClassifier.java``
and ``Classification/SVMClassifier.java``: the same ``config_*`` keys
gate custom vs default hyperparameters exactly as the reference's
all-present checks do (LogisticRegressionClassifier.java:104-112,
SVMClassifier.java:95-109); prediction is MLlib's strict
``margin > threshold`` (both predict 0.0 at exactly the threshold).

Models persist as one ``.npz`` in the JAX package's layout (weights,
config JSON, kind, intercept, margin_threshold), so a model saved by
either package loads into the other: :meth:`to_numpy_state` and
:meth:`from_numpy_state` are the interchange.
"""

from __future__ import annotations

import io
import json
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import base, sgd
from ..io import modelfiles


class LinearModel(nn.Module):
    """margin = features . weight + intercept."""

    def __init__(self, weight: torch.Tensor, intercept: float = 0.0):
        super().__init__()
        self.register_buffer("weight", weight)
        self.intercept = float(intercept)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return features.to(self.weight.dtype) @ self.weight + self.intercept


class _LinearClassifier(base.Classifier):
    loss: str = "logistic"
    # config keys that must ALL be present to use custom hyperparams
    required_keys: tuple = ()

    def __init__(self) -> None:
        super().__init__()
        self.model: Optional[LinearModel] = None
        # natively trained models keep MLlib's default threshold (prob
        # 0.5 <=> margin 0); loaded models adopt the saved value
        self.margin_threshold: float = 0.0

    def _sgd_config(self) -> sgd.SGDConfig:
        raise NotImplementedError

    def _class_weights(self) -> dict:
        """``config_weight_pos`` / ``config_weight_neg``; absent means 1.0."""
        return {
            "weight_pos": float(self.config.get("config_weight_pos", 1.0)),
            "weight_neg": float(self.config.get("config_weight_neg", 1.0)),
        }

    def fit(self, features: torch.Tensor, labels: torch.Tensor) -> None:
        weight = sgd.train_linear(features, labels, self._sgd_config())
        self.model = LinearModel(weight)
        self.margin_threshold = 0.0

    def margin(self, features: torch.Tensor) -> torch.Tensor:
        """(n,) margins on the features' device (float64 for float64
        weights, as the JAX package computes imported MLlib models)."""
        if self.model is None:
            raise ValueError("model not trained or loaded")
        return self.model.to(features.device)(features)

    def predict(self, features: torch.Tensor) -> torch.Tensor:
        return (self.margin(features) > self.margin_threshold).to(torch.float64)

    # -- interchange ----------------------------------------------------

    def to_numpy_state(self) -> dict:
        if self.model is None:
            raise ValueError("model not trained or loaded")
        return {
            "weights": self.model.weight.detach().cpu().numpy(),
            "intercept": float(self.model.intercept),
            "margin_threshold": float(self.margin_threshold),
            "config": dict(self.config),
            "kind": self.__class__.__name__,
        }

    def from_numpy_state(self, state: dict) -> None:
        kind = str(state["kind"])
        if kind != self.__class__.__name__:
            raise ValueError(
                f"model state was saved by {kind}, not {self.__class__.__name__}"
            )
        self.model = LinearModel(
            torch.from_numpy(np.array(state["weights"])),
            float(state.get("intercept", 0.0)),
        )
        self.margin_threshold = float(state.get("margin_threshold", 0.0))
        self.config = dict(state.get("config", {}))

    def save(self, path: str) -> None:
        if self.config.get("config_model_format") == "mllib":
            raise ValueError(
                "config_model_format=mllib (MLlib model directories) is "
                "not yet ported; see ROADMAP.md"
            )
        state = self.to_numpy_state()
        modelfiles.delete_local_dir_target(path)
        buf = io.BytesIO()
        np.savez(
            buf,
            weights=state["weights"],
            config=json.dumps(state["config"]),
            kind=state["kind"],
            intercept=np.float64(state["intercept"]),
            margin_threshold=np.float64(state["margin_threshold"]),
        )
        fname = path if path.endswith(".npz") else path + ".npz"
        modelfiles.atomic_write_bytes(fname, buf.getvalue())

    def load(self, path: str) -> None:
        if os.path.isdir(path):
            raise ValueError(
                f"{path} is a directory; MLlib model directories are not "
                "yet ported; see ROADMAP.md"
            )
        fname = path if path.endswith(".npz") else path + ".npz"
        data = np.load(io.BytesIO(modelfiles.read_model_bytes(fname)), allow_pickle=False)
        state = {
            "weights": data["weights"],
            "config": json.loads(str(data["config"])),
            "kind": str(data["kind"]),
        }
        # absent in archives older than the interchange fields: those
        # models were trained natively, where both are zero
        for key in ("intercept", "margin_threshold"):
            if key in data.files:
                state[key] = float(data[key])
        self.from_numpy_state(state)


class LogisticRegressionClassifier(_LinearClassifier):
    loss = "logistic"
    required_keys = (
        "config_num_iterations",
        "config_step_size",
        "config_mini_batch_fraction",
    )

    def _sgd_config(self) -> sgd.SGDConfig:
        c = self.config
        if all(k in c for k in self.required_keys):
            # the static train(rdd, iters, step, frac) path constructs
            # LogisticRegressionWithSGD(step, iters, 0.0, frac): no reg
            return sgd.SGDConfig(
                num_iterations=int(c["config_num_iterations"]),
                step_size=float(c["config_step_size"]),
                mini_batch_fraction=float(c["config_mini_batch_fraction"]),
                reg_param=0.0,
                loss="logistic",
                **self._class_weights(),
            )
        # the default constructor LogisticRegressionWithSGD(1.0, 100,
        # 0.01, 1.0): SquaredL2Updater with regParam 0.01
        return sgd.SGDConfig(
            num_iterations=100, step_size=1.0, mini_batch_fraction=1.0,
            reg_param=0.01, loss="logistic", **self._class_weights(),
        )


class SVMClassifier(_LinearClassifier):
    loss = "hinge"
    required_keys = (
        "config_num_iterations",
        "config_step_size",
        "config_reg_param",
        "config_mini_batch_fraction",
    )

    def _sgd_config(self) -> sgd.SGDConfig:
        c = self.config
        if all(k in c for k in self.required_keys):
            return sgd.SGDConfig(
                num_iterations=int(c["config_num_iterations"]),
                step_size=float(c["config_step_size"]),
                mini_batch_fraction=float(c["config_mini_batch_fraction"]),
                reg_param=float(c["config_reg_param"]),
                loss="hinge",
                **self._class_weights(),
            )
        # MLlib SVMWithSGD().run defaults
        return sgd.SGDConfig(
            num_iterations=100, step_size=1.0, mini_batch_fraction=1.0,
            reg_param=0.01, loss="hinge", **self._class_weights(),
        )
