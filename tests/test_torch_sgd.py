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
    """Mini-batch sampling, refused until the threefry streams were
    ported, now runs: the weights of a fraction-0.5 run within 1e-5 of
    the JAX package's, and the run really samples (unlike full batch)."""
    x, y = _data(n=10)
    config = dict(mini_batch_fraction=0.5)
    got = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y),
                           sgd.SGDConfig(**config)).numpy()
    want = jax_sgd.train_linear(x, y, jax_sgd.SGDConfig(**config))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    full = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig()).numpy()
    assert np.abs(got - full).max() > 1e-3


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
@pytest.mark.parametrize("fraction", [0.3, 0.5])
def test_mini_batch_masks_equal_jax(seed, fraction):
    """Iteration t's mask, bit for bit the JAX engine's
    ``uniform(fold_in(PRNGKey(seed), t), (n,)) < fraction``."""
    import jax

    config = sgd.SGDConfig(mini_batch_fraction=fraction, seed=seed)
    for t in (1, 2, 7, 100):
        for n in (1, 7, 2135):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            want = (np.asarray(jax.random.uniform(key, (n,))) < np.float32(fraction))
            got = sgd.mini_batch_mask(config, t, n, device="cpu").numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("fraction", [0.3, 0.5])
@pytest.mark.parametrize("kwargs", [
    dict(loss="logistic"), dict(loss="hinge", reg_param=0.01),
    dict(loss="logistic", reg_param=0.01, weight_pos=3.0, weight_neg=0.5),
    dict(loss="hinge", convergence_tol=0.0, num_iterations=60, step_size=0.5),
], ids=["logistic", "hinge", "weighted", "no-early-stop"])
def test_mini_batch_weights_match_jax_engine(kwargs, fraction):
    x, y = _data()
    config = dict(kwargs, mini_batch_fraction=fraction)
    got = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y),
                           sgd.SGDConfig(**config)).numpy()
    want = jax_sgd.train_linear(x, y, jax_sgd.SGDConfig(**config))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("clf", ["logreg", "svm"])
def test_mini_batch_pipeline_statistics_equal_jax(clf, tmp_path):
    """``config_mini_batch_fraction=0.5`` through both builders: the
    report text is equal."""
    import os
    import sys

    from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    info = _synthetic.write_session(str(tmp_path), n_markers=120)
    q = (f"info_file={info}&fe=dwt-8-fused&train_clf={clf}&config_num_iterations=60"
         "&config_step_size=1.0&config_reg_param=0.01&config_mini_batch_fraction=0.5")
    assert str(PipelineBuilder(q, device="cpu").execute()) == str(JaxBuilder(q).execute())


def test_empty_training_set_keeps_zero_weights():
    w = sgd.train_linear(torch.zeros((0, 48)), torch.zeros(0), sgd.SGDConfig())
    assert w.shape == (48,) and not w.any()


# -- the chunked partial-fit seam (the serving lifecycle's) -----------------


def _train_linear_before_the_chunked_seam(features, labels, config):
    """The port's monolithic loop as it stood before the chunked seam
    shared its step: ``train_linear`` must keep its bytes."""
    f32 = np.float32
    x = features.to(torch.float32)
    y = labels.to(device=x.device, dtype=torch.float32)
    n, d = x.shape
    w = torch.zeros(d, dtype=torch.float32, device=x.device)
    class_w = (y * config.weight_pos + (1.0 - y) * config.weight_neg
               if config.weighted else None)
    scale = f32(1.0) / f32(n)
    tol = float(f32(config.convergence_tol))
    n_updates = 0
    for t in range(1, int(config.num_iterations) + 1):
        margin = x @ w
        if config.loss == "logistic":
            mult = torch.sigmoid(margin) - y
        else:
            y_signed = 2.0 * y - 1.0
            mult = torch.where(y_signed * margin < 1.0, -y_signed,
                               torch.zeros((), device=x.device))
        if class_w is not None:
            mult = mult * class_w
        g = x.T @ mult
        step_t = f32(config.step_size) / np.sqrt(f32(t))
        decay = f32(1.0) - step_t * f32(config.reg_param)
        w_cand = w * float(decay) - float(step_t * scale) * g
        if n_updates >= 1:
            diff = torch.linalg.vector_norm(w - w_cand)
            bound = tol * torch.clamp(torch.linalg.vector_norm(w_cand), min=1.0)
            if bool(diff < bound):
                return w_cand
        w = w_cand
        n_updates += 1
    return w


@pytest.mark.parametrize("kwargs", CONFIGS)
def test_train_linear_keeps_its_bytes(kwargs):
    x, y = _data(seed=4)
    config = sgd.SGDConfig(**kwargs)
    got = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), config)
    want = _train_linear_before_the_chunked_seam(torch.from_numpy(x), torch.from_numpy(y),
                                                 config)
    assert got.numpy().tobytes() == want.numpy().tobytes()


CHUNK_CONFIGS = [
    dict(loss="logistic", num_iterations=30, step_size=0.5, convergence_tol=0.0),
    dict(loss="hinge", num_iterations=30, step_size=1.0, reg_param=0.01, convergence_tol=0.0),
    dict(loss="logistic", num_iterations=30, reg_param=0.01, weight_pos=3.0, weight_neg=0.5,
         convergence_tol=0.0),
    # the early stop fires mid-run: the chunked carry freezes there too
    dict(loss="hinge", num_iterations=30, step_size=0.01, convergence_tol=0.05),
    # mini-batch sampling: absolute iteration indices draw the same masks
    dict(loss="logistic", num_iterations=30, mini_batch_fraction=0.5, convergence_tol=0.0),
    dict(loss="hinge", num_iterations=30, mini_batch_fraction=0.3, reg_param=0.01),
]


@pytest.mark.parametrize("kwargs", CHUNK_CONFIGS)
def test_chunked_partial_fit_replays_the_monolithic_trajectory(kwargs):
    """Chunks of 10 iterations over the whole matrix with an all-ones
    mask give the monolithic ``train_linear`` weights byte for byte (the
    JAX package's test_lifecycle pin, on the port)."""
    x, y = _data(n=32, d=8, seed=3)
    config = sgd.SGDConfig(**kwargs)
    whole = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), config)
    carry = sgd.partial_fit_carry(8, device="cpu")
    mask = np.ones(32, np.float32)
    for t0 in range(0, 30, 10):
        carry = sgd.partial_fit_linear(carry, t0, x, y, config, 10, sample_mask=mask,
                                       device="cpu")
    assert carry[0].numpy().tobytes() == whole.numpy().tobytes()


def _ring(n_live, cap=64, d=48, seed=5):
    """A fixed-capacity feedback ring: ``n_live`` rows live, the rest zero
    and masked out."""
    x, y = _data(n=cap, d=d, seed=seed)
    mask = np.zeros(cap, np.float32)
    mask[:n_live] = 1.0
    x[n_live:] = 0.0
    y[n_live:] = 0.0
    return x, y.astype(np.float32), mask


@pytest.mark.parametrize("kwargs", [
    dict(loss="logistic", reg_param=0.01),
    dict(loss="hinge", reg_param=0.01),
    dict(loss="logistic", step_size=0.7, weight_pos=3.0, weight_neg=0.5),
    dict(loss="hinge", step_size=2.0, reg_param=0.1, weight_pos=0.5, weight_neg=2.0),
])
@pytest.mark.parametrize("warm", [False, True])
def test_partial_fit_matches_jax_over_chunks(kwargs, warm):
    """Several chunks over a half-filled ring that fills up between them,
    from a zero or a warm start: weights within 1e-5 of the JAX package's
    after every chunk, the same converged flag and update count."""
    config = dict(kwargs, convergence_tol=0.0)
    rng = np.random.RandomState(11)
    w0 = rng.randn(48).astype(np.float32) * 0.1 if warm else None
    ours = sgd.partial_fit_carry(48, weights=w0, device="cpu")
    theirs = jax_sgd.partial_fit_carry(48, weights=w0)
    t = 0
    for n_live in (16, 32, 48, 64):
        x, y, mask = _ring(n_live)
        ours = sgd.partial_fit_linear(ours, t, x, y, sgd.SGDConfig(**config), 20,
                                      sample_mask=mask, device="cpu")
        theirs = jax_sgd.partial_fit_linear(theirs, t, x, y, jax_sgd.SGDConfig(**config), 20,
                                            sample_mask=mask)
        t += 20
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(theirs[0]), rtol=0, atol=1e-5)
        assert ours[1] == bool(theirs[1]) and ours[2] == int(theirs[2])


def test_partial_fit_with_an_empty_mask_leaves_the_carry():
    """A chunk over a ring with no live row neither decays nor updates,
    as the JAX package's (count == 0)."""
    x, y, mask = _ring(0)
    w0 = np.linspace(-1, 1, 48).astype(np.float32)
    config = sgd.SGDConfig(reg_param=0.5, convergence_tol=0.0)
    w, converged, n_updates = sgd.partial_fit_linear(
        sgd.partial_fit_carry(48, weights=w0, device="cpu"), 0, x, y, config, 5,
        sample_mask=mask, device="cpu")
    theirs = jax_sgd.partial_fit_linear(jax_sgd.partial_fit_carry(48, weights=w0), 0, x, y,
                                        jax_sgd.SGDConfig(reg_param=0.5, convergence_tol=0.0),
                                        5, sample_mask=mask)
    assert w.numpy().tobytes() == w0.tobytes() == np.asarray(theirs[0]).tobytes()
    assert (converged, n_updates) == (False, 0) == (bool(theirs[1]), int(theirs[2]))


def test_partial_fit_carry_and_device_contract():
    w, converged, n_updates = sgd.partial_fit_carry(5, device="cpu")
    assert w.dtype == torch.float32 and not w.any() and (converged, n_updates) == (False, 0)
    w0 = np.arange(5, dtype=np.float64)
    w, _c, _n = sgd.partial_fit_carry(5, weights=w0, device="cpu")
    assert w.dtype == torch.float32 and w.tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            sgd.partial_fit_carry(5)
    # a mini-batch chunk (refused until the threefry streams were ported)
    # samples within the ring's live rows, as the JAX package's does
    x, y, mask = _ring(4, cap=8, d=4)
    config = dict(mini_batch_fraction=0.5, convergence_tol=0.0)
    got = sgd.partial_fit_linear(sgd.partial_fit_carry(4, device="cpu"), 0, x, y,
                                 sgd.SGDConfig(**config), 3, sample_mask=mask, device="cpu")
    want = jax_sgd.partial_fit_linear(jax_sgd.partial_fit_carry(4), 0, x, y,
                                      jax_sgd.SGDConfig(**config), 3, sample_mask=mask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    assert (got[1], got[2]) == (bool(want[1]), int(want[2]))
