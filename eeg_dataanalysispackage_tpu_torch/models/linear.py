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
:meth:`from_numpy_state` are the interchange. ``config_model_format=mllib``
saves a Spark 1.6 MLlib model directory instead
(:meth:`_LinearClassifier.export_mllib_dir`, ``io/mllib_format.py``), and
:meth:`_LinearClassifier.load` adopts such a directory: its float64
weights keep the JAX package's host float64 margin, bit for bit.
"""

from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import base, sgd
from ..io import mllib_format, modelfiles


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

    def fit_elastic(self, features: torch.Tensor, labels: torch.Tensor, manager,
                    save_every: int = 1, max_restarts: int = 3, sentinel=None,
                    chunk_iters: int = 10, probe_on_failure: bool = True) -> None:
        """MLlib-SGD training with mid-train checkpoint/restore
        (``sgd.train_linear_elastic``): a transient failure restores the
        latest chunk carry; absolute iteration indices keep the weights
        equal to :meth:`fit`'s."""
        weight = sgd.train_linear_elastic(
            features, labels, self._sgd_config(), manager, chunk_iters=chunk_iters,
            save_every=save_every, max_restarts=max_restarts, sentinel=sentinel,
            probe_on_failure=probe_on_failure,
        )
        self.model = LinearModel(weight)
        self.margin_threshold = 0.0

    def margin(self, features: torch.Tensor) -> torch.Tensor:
        """(n,) margins on the features' device. Float64 weights (an
        imported MLlib model) keep the JAX package's predict: the rows
        widened to float64 on the host, ``x @ w + intercept`` in numpy,
        so the margins equal its bit for bit."""
        if self.model is None:
            raise ValueError("model not trained or loaded")
        if self.model.weight.dtype == torch.float64:
            x = features.detach().cpu().numpy().astype(np.float64)
            m = x @ self.model.weight.detach().cpu().numpy() + self.model.intercept
            return torch.from_numpy(m).to(features.device)
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
        # a stale directory at the raw target is deleted first
        # (LogisticRegressionClassifier.java:144-147)
        if self.config.get("config_model_format") == "mllib":
            # save_clf=true&config_model_format=mllib writes the
            # Spark-loadable model directory instead of the npz
            modelfiles.delete_local_dir_target(path)
            self.export_mllib_dir(path)
            return
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
        modelfiles.write_model_bytes(fname, buf.getvalue())

    def load(self, path: str) -> None:
        if mllib_format.is_model_dir(path):
            self._load_mllib_dir(path)
            return
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

    def export_mllib_dir(self, path: str) -> None:
        """Write this model as a Spark 1.6 MLlib model directory (the
        artifact ``LogisticRegressionModel.load`` / ``SVMModel.load``
        consumes, LogisticRegressionClassifier.java:150-152). Weights
        widen float32 -> float64 exactly; the margin threshold maps back
        to the class's saved-threshold convention."""
        if self.model is None:
            raise ValueError("model not trained or loaded")
        mllib_format.write_glm(
            path,
            self._mllib_class,
            self.model.weight.detach().cpu().numpy().astype(np.float64),
            intercept=self.model.intercept,
            threshold=self._from_margin_threshold(self.margin_threshold),
        )

    def _load_mllib_dir(self, path: str) -> None:
        """Adopt an MLlib model directory, with the JAX package's checks
        and messages: the class tag, a binary model, a set threshold."""
        m = mllib_format.read_glm(path)
        if m.model_class != self._mllib_class:
            raise ValueError(
                f"model dir at {path} holds {m.model_class}, but "
                f"{self.__class__.__name__} loads {self._mllib_class}"
            )
        if m.num_classes != 2:
            # multinomial logreg packs (numClasses-1) weight blocks;
            # the binary margin would misread them
            raise NotImplementedError(
                f"multinomial MLlib model (numClasses="
                f"{m.num_classes}) is not supported; the reference "
                f"pipeline is binary"
            )
        # a cleared threshold (MLlib clearThreshold, raw-score mode) has
        # no label semantics; the pipeline always classifies
        if m.threshold is None:
            raise ValueError(
                "model dir was saved with a cleared threshold (raw "
                "scores); set one before exporting"
            )
        # float64 weights route margin() to the host float64 predict
        self.model = LinearModel(torch.from_numpy(m.weights), m.intercept)
        self.margin_threshold = self._to_margin_threshold(m.threshold)


class LogisticRegressionClassifier(_LinearClassifier):
    loss = "logistic"
    required_keys = (
        "config_num_iterations",
        "config_step_size",
        "config_mini_batch_fraction",
    )
    _mllib_class = mllib_format.GLM_LOGREG

    @staticmethod
    def _to_margin_threshold(saved: float) -> float:
        # LogisticRegressionModel stores a probability threshold:
        # sigmoid(margin) > p <=> margin > logit(p); p=1 and p=0 are the
        # constant classifiers they mean in MLlib
        if saved >= 1.0:
            return float("inf")
        if saved <= 0.0:
            return float("-inf")
        return float(np.log(saved / (1.0 - saved)))

    @staticmethod
    def _from_margin_threshold(margin: float) -> float:
        # the inverse: sigmoid maps +/-inf to 1.0 / 0.0
        return float(1.0 / (1.0 + np.exp(-margin)))

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
    _mllib_class = mllib_format.GLM_SVM

    # SVMModel's threshold is a margin (SVMModel.predictPoint)
    _to_margin_threshold = staticmethod(float)
    _from_margin_threshold = staticmethod(float)

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
