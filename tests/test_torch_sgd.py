"""The port's SGD engine against the JAX package's, on the same numpy
inputs: final weights within 1e-5 (both float32; the matrix-vector
products and norms sum in different orders)."""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import linear as jax_linear
from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd
from eeg_dataanalysispackage_tpu_torch.models import linear, sgd


def _data(n=240, d=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)  # feature rows are unit-norm
    y = (rng.rand(n) < 0.5).astype(np.float64)
    x[y == 1, :4] += 0.2  # a weak signal, so the losses do work
    return x, y


CONFIGS = [
    dict(loss="logistic", reg_param=0.01),  # the logreg default
    dict(loss="hinge", reg_param=0.01),  # the svm default
    dict(loss="logistic", num_iterations=37, step_size=0.5),
    dict(loss="hinge", num_iterations=60, step_size=2.0, reg_param=0.1),
    dict(loss="logistic", weight_pos=3.0, weight_neg=0.5, reg_param=0.01),
    dict(loss="hinge", step_size=0.01, convergence_tol=0.05),  # stops early
    dict(loss="logistic", convergence_tol=0.0, num_iterations=150),
]


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_weights_match_jax_engine(kwargs):
    x, y = _data()
    got = sgd.train_linear(
        torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig(**kwargs)
    ).numpy()
    want = jax_sgd.train_linear(x, y, jax_sgd.SGDConfig(**kwargs))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cls", ["LogisticRegressionClassifier", "SVMClassifier"])
@pytest.mark.parametrize(
    "config",
    [
        {},
        {"config_num_iterations": "40", "config_step_size": "0.7",
         "config_mini_batch_fraction": "1.0", "config_reg_param": "0.05"},
        {"config_num_iterations": "40"},  # incomplete: the defaults apply
    ],
)
def test_classifier_configs_match_jax(cls, config):
    x, y = _data(seed=1)
    ours = getattr(linear, cls)()
    theirs = getattr(jax_linear, cls)()
    ours.set_config(config)
    theirs.set_config(config)
    assert ours._sgd_config() == sgd.SGDConfig(**vars(theirs._sgd_config()))
    ours.fit(torch.from_numpy(x), torch.from_numpy(y).float())
    theirs.fit(x, y)
    np.testing.assert_allclose(
        ours.model.weight.numpy(), theirs.weights, rtol=0, atol=1e-5
    )


def test_mini_batch_sampling_is_not_ported_yet():
    x, y = _data(n=10)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sgd.train_linear(
            torch.from_numpy(x), torch.from_numpy(y),
            sgd.SGDConfig(mini_batch_fraction=0.5),
        )


def test_empty_training_set_keeps_zero_weights():
    w = sgd.train_linear(torch.zeros((0, 48)), torch.zeros(0), sgd.SGDConfig())
    assert w.shape == (48,) and not w.any()
