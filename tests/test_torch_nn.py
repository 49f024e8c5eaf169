"""The port's neural-network classifier against the JAX package's.

The same numpy inputs through the JAX package's ``models/nn.py`` (flax +
optax under XLA) and the port's ``models/nn.py`` (torch): ``model.init``'s
parameters (Dense kernels bit-equal for xavier, sigmoid, uniform and zero;
he_normal within 4 ulp of the float32 erf_inv map; the LSTM's orthogonal
kernels within 1e-6), 20 training iterations of every updater and of CG
from the JAX package's initial parameters (with dropout and class
weights), pretraining and a ``graves_lstm`` stack (parameters within 1e-5
abs), save files byte-identical and loadable by either package, and
``train_clf=nn`` through the pipeline on the synthetic session.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import nn as jax_nn
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.models import nn, registry
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.utils import threefry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

TOL = 1e-5
NEAR = 1e-4  # a test row may flip only if its prediction lies this close to 0.5

BASE = {
    "config_seed": "7",
    "config_num_iterations": "20",
    "config_learning_rate": "0.05",
    "config_momentum": "0.9",
    "config_weight_init": "xavier",
    "config_updater": "sgd",
    "config_optimization_algo": "stochastic_gradient_descent",
    "config_pretrain": "false",
    "config_backprop": "true",
    "config_loss_function": "xent",
}

#: configuration A: the JAX package's test_nn_pipeline
CONFIG_A = (
    "&config_seed=1&config_num_iterations=50&config_learning_rate=0.1"
    "&config_momentum=0.9&config_weight_init=xavier&config_updater=nesterovs"
    "&config_optimization_algo=stochastic_gradient_descent"
    "&config_pretrain=false&config_backprop=true&config_loss_function=xent"
    "&config_layer1_layer_type=dense&config_layer1_n_out=8"
    "&config_layer1_drop_out=0.0&config_layer1_activation_function=relu"
    "&config_layer2_layer_type=output&config_layer2_n_out=2"
    "&config_layer2_drop_out=0.0&config_layer2_activation_function=softmax"
)


def layer(i, ltype, n_out, act, drop="0.0"):
    return {
        f"config_layer{i}_layer_type": ltype,
        f"config_layer{i}_n_out": str(n_out),
        f"config_layer{i}_drop_out": drop,
        f"config_layer{i}_activation_function": act,
    }


def make_data(n=64, d=12, seed=3, time=None):
    rng = np.random.RandomState(seed)
    shape = (n, d) if time is None else (n, time, d)
    x = rng.randn(*shape).astype(np.float32)
    flat = x if time is None else x[:, -1]
    y = (flat[:, 0] + 0.5 * flat[:, 1] > 0).astype(np.float64)
    return x, y


def to_numpy(tree):
    """A flax tree as nested numpy dicts, in its own key order
    (``jax.tree_util.tree_map`` would sort the keys)."""
    return {k: to_numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def jax_init(cfg, x):
    """The parameters the JAX package's fit starts from (its model.init)."""
    theirs = jax_nn.NeuralNetworkClassifier()
    theirs.set_config(cfg)
    ltypes, n_outs, acts, drops = theirs._parse_layers()
    net = jax_nn._Net(tuple(ltypes), tuple(n_outs), tuple(acts), tuple(drops),
                      cfg["config_weight_init"])
    rng = jax.random.PRNGKey(int(cfg["config_seed"]))
    p = net.init({"params": rng, "dropout": rng}, jnp.asarray(x[:1]), train=False)
    return to_numpy(p)


def fit_both(cfg, x, y):
    theirs = jax_nn.NeuralNetworkClassifier()
    theirs.set_config(cfg)
    theirs.fit(x, y)
    ours = nn.NeuralNetworkClassifier()
    ours.set_config(cfg)
    ours._fit(torch.from_numpy(x), torch.from_numpy(y).float(), init=jax_init(cfg, x))
    return ours, theirs


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def max_param_dev(ours, theirs) -> float:
    mine = dict(leaves(nn.params_to_jax(ours.net)))
    return max(float(np.abs(mine[p] - v).max()) for p, v in leaves(theirs.params))


# -- initialization ----------------------------------------------------------

_INIT_NET = (("dense", "auto_encoder", "graves_lstm", "output"), (6, 5, 4, 2),
             ("relu", "sigmoid", "tanh", "softmax"), (0.0, 0.2, 0.0, 0.0))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("weight_init", ["xavier", "sigmoid", "uniform", "zero", "relu",
                                         "unknown-falls-back-to-relu"])
def test_init_matches_flax(weight_init):
    net = jax_nn._Net(*_INIT_NET, weight_init)
    rng = jax.random.PRNGKey(3)
    want = net.init({"params": rng, "dropout": rng}, jnp.zeros((1, 7)), train=False)
    ours = nn._Net(*_INIT_NET, 7)
    nn._init_params(ours, 3, weight_init, "cpu")
    got = dict(leaves(nn.params_to_jax(ours)))
    he_normal = weight_init not in ("xavier", "sigmoid", "uniform", "zero")
    for path, value in leaves(to_numpy(want)):
        mine = got[path]
        if path[-2][0] == "h" and path[-1] == "kernel":  # the LSTM's orthogonal kernels
            np.testing.assert_allclose(mine, value, rtol=0, atol=1e-6)
        elif he_normal:
            assert _ulps(mine, value).max() <= 4, path
        else:
            assert mine.tobytes() == value.tobytes(), path
    # flax's creation order: layers in order, kernel before bias
    assert list(got)[:3] == [("params", "layer1", "kernel"), ("params", "layer1", "bias"),
                             ("params", "layer2", "kernel")]


def test_dropout_masks_match_flax():
    net = jax_nn._Net(("dense", "dense", "output"), (9, 7, 2), ("relu", "tanh", "softmax"),
                      (0.3, 0.5, 0.0), "xavier")
    x, _ = make_data(n=40, d=6)
    rng = jax.random.PRNGKey(11)
    params = net.init({"params": rng, "dropout": rng}, jnp.asarray(x[:1]), train=False)
    key = jax.random.fold_in(rng, 4)
    want = np.asarray(net.apply(params, jnp.asarray(x), train=True, rngs={"dropout": key}))
    ours = nn.params_from_jax(to_numpy(params),
                              nn._Net(("dense", "dense", "output"), (9, 7, 2),
                                      ("relu", "tanh", "softmax"), (0.3, 0.5, 0.0), 6))
    with torch.no_grad():
        got = ours(torch.from_numpy(x),
                   dropout_key=threefry.fold_in(threefry.prng_key(11), 4)).numpy()
        plain = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got - plain).max() > 1e-3  # the masks did something


# -- training ------------------------------------------------------------------

_TRAIN_CASES = {
    "sgd": dict(config_updater="sgd"),
    "nesterovs": dict(config_updater="nesterovs"),
    "adam": dict(config_updater="adam", config_learning_rate="0.01"),
    "adagrad": dict(config_updater="adagrad"),
    "rmsprop": dict(config_updater="rmsprop", config_learning_rate="0.01"),
    "unknown-updater": dict(config_updater="bogus"),
    "conjugate_gradient": dict(config_optimization_algo="conjugate_gradient"),
    "dropout-mse": dict(config_updater="nesterovs", config_loss_function="mse",
                        **{"config_layer1_drop_out": "0.25"}),
    "class-weights-nll": dict(config_updater="adam", config_learning_rate="0.01",
                              config_loss_function="negativeloglikelihood",
                              config_weight_pos="3.0", config_weight_neg="0.5"),
    "class-weights-xent-relu-init": dict(config_weight_pos="2.0", config_weight_init="relu"),
}


@pytest.mark.parametrize("case", list(_TRAIN_CASES))
def test_training_matches_jax(case):
    cfg = dict(BASE, **layer(1, "dense", 8, "relu"), **layer(2, "output", 2, "softmax"))
    cfg.update(_TRAIN_CASES[case])
    x, y = make_data()
    ours, theirs = fit_both(cfg, x, y)
    assert max_param_dev(ours, theirs) <= TOL
    np.testing.assert_allclose(ours.predict(torch.from_numpy(x)).numpy(),
                               theirs.predict(x), rtol=0, atol=TOL)


@pytest.mark.parametrize("ltype,updater,backprop", [
    ("auto_encoder", "adam", "false"), ("auto_encoder", "sgd", "true"),
    ("rbm", "sgd", "false"), ("rbm", "nesterovs", "true"),
])
def test_pretraining_matches_jax(ltype, updater, backprop):
    cfg = dict(BASE, config_pretrain="true", config_backprop=backprop, config_updater=updater,
               config_learning_rate="0.02")
    cfg.update(layer(1, "dense", 6, "relu"))
    cfg.update(layer(2, ltype, 5, "sigmoid", drop="0.2"))
    cfg.update(layer(3, "output", 2, "softmax"))
    x, y = make_data()
    ours, theirs = fit_both(cfg, x, y)
    assert max_param_dev(ours, theirs) <= TOL


@pytest.mark.parametrize("time", [None, 3], ids=["flat", "sequence"])
def test_lstm_stack_matches_jax(time):
    cfg = dict(BASE, config_updater="adam", config_learning_rate="0.01",
               config_loss_function="mse", config_pretrain="true")
    cfg.update(layer(1, "graves_lstm", 6, "tanh"))
    cfg.update(layer(2, "auto_encoder", 5, "sigmoid"))
    cfg.update(layer(3, "output", 2, "softmax"))
    x, y = make_data(time=time)
    ours, theirs = fit_both(cfg, x, y)
    assert max_param_dev(ours, theirs) <= TOL
    np.testing.assert_allclose(ours.predict(torch.from_numpy(x)).numpy(),
                               theirs.predict(x), rtol=0, atol=TOL)


LBFGS_REL_TOL = 3e-4  # lbfgs parameters after 20 steps, relative to the largest (measured 1.0e-4)
LINE_GD_REL_TOL = 1e-6  # line_gradient_descent (measured 1.7e-7)


def noisy_data(n=64, d=12, seed=3):
    """make_data with label noise: a separable set drives L-BFGS's
    weights along flat directions without bound."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.4 * rng.randn(n) > 0).astype(np.float64)
    return x, y


def jax_linesearch_fit(cfg, x, y):
    """The JAX package's fit, step by step: its classifier and each
    update's (line-search steps, step size) from optax's state."""
    theirs = jax_nn.NeuralNetworkClassifier()
    theirs.set_config(cfg)
    model, params, tx, _vf, loss, xj, yj, rng, iters, _bp = theirs._prepare_fit(x, y)
    opt = tx.init(params)
    step = jax.jit(jax_nn._make_backprop_step(model, tx, True, loss, rng, xj, yj))
    history = []
    for it in range(iters):
        (params, opt), _value = step((params, opt), it)
        ls = [s for s in opt if hasattr(s, "info")][0]
        history.append((int(ls.info.num_linesearch_steps), float(ls.learning_rate)))
    theirs.params = params
    return theirs, history


@pytest.mark.parametrize("algo", ["lbfgs", "line_gradient_descent"])
@pytest.mark.parametrize("extra", [{}, {"config_layer1_drop_out": "0.2"},
                                   {"config_weight_pos": "2.0"},
                                   {"config_loss_function": "mse",
                                    "config_layer1_activation_function": "tanh"}],
                         ids=["dense", "dropout", "weighted", "mse-tanh"])
def test_unported_algorithms_and_modes_raise(algo, extra):
    """Ported since: optax's lbfgs and line_gradient_descent, 20 steps from
    the JAX package's initial parameters. Every update takes as many
    line-search steps as optax's (the differing branches are counted and
    printed: none on these inputs) and the parameters end within the
    stated relative tolerance; the population and elastic modes run
    (tests/test_torch_population.py, tests/test_torch_elastic.py)."""
    cfg = dict(BASE, config_optimization_algo=algo, **layer(1, "dense", 6, "relu"),
               **layer(2, "output", 2, "softmax"))
    cfg.update(extra)
    x, y = noisy_data()
    theirs, want = jax_linesearch_fit(cfg, x, y)
    ours = nn.NeuralNetworkClassifier()
    ours.set_config(cfg)
    ours._fit(torch.from_numpy(x), torch.from_numpy(y).float(), init=jax_init(cfg, x))
    got = ours.linesearch_history
    branches = sum(1 for a, b in zip(got, want) if a[0] != b[0])
    scale = max(float(np.abs(v).max()) for _, v in leaves(theirs.params))
    rel = max_param_dev(ours, theirs) / scale
    print(f"{algo} {extra}: {branches} differing line-search branches, rel dev {rel:.2e}, "
          f"{ours.linesearch_steps} steps")
    assert len(got) == len(want) == 20 and branches == 0
    assert ours.linesearch_steps == sum(steps for steps, _ in want)
    assert rel <= (LBFGS_REL_TOL if algo == "lbfgs" else LINE_GD_REL_TOL)


def test_lbfgs_pretraining_matches_jax():
    """Greedy pretraining with a value-function algorithm: the denoising
    autoencoder's objective through optax's L-BFGS."""
    cfg = dict(BASE, config_optimization_algo="lbfgs", config_pretrain="true",
               config_num_iterations="10", config_loss_function="mse")
    cfg.update(layer(1, "auto_encoder", 5, "sigmoid"))
    cfg.update(layer(2, "output", 2, "softmax"))
    x, y = noisy_data()
    ours, theirs = fit_both(cfg, x, y)
    scale = max(float(np.abs(v).max()) for _, v in leaves(theirs.params))
    assert max_param_dev(ours, theirs) / scale <= LBFGS_REL_TOL
    assert ours.linesearch_steps >= 10


def test_population_fit_members_are_their_fits():
    """Each population member equals the fit of its seed and learning
    rate (dropout on: the members' masks come from their own seeds)."""
    cfg = dict(BASE, **layer(1, "dense", 6, "relu", drop="0.3"),
               **layer(2, "output", 2, "softmax"))
    x, y = noisy_data()
    clf = nn.NeuralNetworkClassifier()
    clf.set_config(cfg)
    nets = clf.population_fit(torch.from_numpy(x), torch.from_numpy(y).float(), [1, 2],
                              [0.1, 0.05])
    for net, (seed, lr) in zip(nets, [(1, 0.1), (2, 0.05)]):
        single = nn.NeuralNetworkClassifier()
        single.set_config(dict(cfg, config_seed=str(seed), config_learning_rate=str(lr)))
        single.fit(torch.from_numpy(x), torch.from_numpy(y).float())
        got, want = nn.params_to_jax(net), nn.params_to_jax(single.net)
        assert list(leaves(got)) and all(
            np.abs(g - w).max() <= 1e-6 for (_, g), (_, w) in zip(leaves(got), leaves(want)))
    for algo in ("lbfgs", "line_gradient_descent"):
        clf.set_config(dict(cfg, config_optimization_algo=algo))
        with pytest.raises(ValueError, match="value_fn"):
            clf.population_fit(torch.from_numpy(x), torch.from_numpy(y).float(), [1], [0.1])


def test_config_errors_and_fallbacks_match_jax():
    x, y = make_data(n=16)
    for cfg, exc in (
        (dict(BASE), ValueError),  # no layers
        ({k: v for k, v in BASE.items() if k != "config_seed"} | layer(1, "output", 2, "softmax"),
         ValueError),
        (dict(BASE, **{k: v for k, v in layer(1, "dense", 3, "relu").items()
                       if not k.endswith("n_out")}, config_layer9_x="1"), KeyError),
    ):
        ours, theirs = nn.NeuralNetworkClassifier(), jax_nn.NeuralNetworkClassifier()
        ours.set_config(cfg)
        theirs.set_config(cfg)
        with pytest.raises(exc) as mine:
            ours.fit(torch.from_numpy(x), torch.from_numpy(y).float())
        with pytest.raises(exc) as want:
            theirs.fit(x, y)
        assert str(mine.value) == str(want.value)
    # unknown layer type -> output, unknown activation -> sigmoid
    cfg = dict(BASE, **layer(1, "convolution", 4, "swish"), **layer(2, "output", 2, "softmax"))
    ours, theirs = fit_both(cfg, *make_data(n=16))
    assert ours._arch == theirs._arch
    assert max_param_dev(ours, theirs) <= TOL


# -- save files ------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_pair():
    cfg = dict(BASE, **layer(1, "dense", 8, "relu"), **layer(2, "graves_lstm", 3, "tanh"),
               **layer(3, "dense", 3, "relu"), **layer(4, "dense", 3, "relu"),
               **layer(5, "dense", 3, "relu"), **layer(6, "dense", 3, "relu"),
               **layer(7, "dense", 3, "relu"), **layer(8, "dense", 3, "relu"),
               **layer(9, "dense", 3, "relu"), **layer(10, "dense", 3, "relu"),
               **layer(11, "output", 2, "softmax"))
    x, y = make_data(n=24)
    return fit_both(cfg, x, y) + (x,)


def _carry(theirs):
    ours = nn.NeuralNetworkClassifier()
    ours.config, ours._arch = dict(theirs.config), json.loads(json.dumps(theirs._arch))
    ours.net = nn.params_from_jax(to_numpy(theirs.params),
                                  ours._build())
    return ours


def test_save_files_byte_identical_and_cross_loadable(trained_pair, tmp_path):
    ours_trained, theirs, x = trained_pair
    # a trained tree: keys sorted at every level (layer10 before layer2)
    theirs.save(str(tmp_path / "jax.nn"))
    carried = _carry(theirs)
    carried.save(str(tmp_path / "port.nn"))
    want = (tmp_path / "jax.nn").read_bytes()
    assert (tmp_path / "port.nn").read_bytes() == want
    assert list(carried.net.layout["params"])[:3] == ["layer1", "layer10", "layer11"]
    # a loaded model is in model.init's order; both packages re-save it alike
    back_jax, back_ours = jax_nn.NeuralNetworkClassifier(), nn.NeuralNetworkClassifier()
    back_jax.load(str(tmp_path / "port.nn"))
    back_ours.load(str(tmp_path / "jax.nn"))
    back_jax.save(str(tmp_path / "jax2.nn"))
    back_ours.save(str(tmp_path / "port2.nn"))
    assert (tmp_path / "port2.nn").read_bytes() == (tmp_path / "jax2.nn").read_bytes()
    np.testing.assert_array_equal(back_ours.predict(torch.from_numpy(x)).numpy(),
                                  carried.predict(torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(back_jax.predict(x), theirs.predict(x))
    # the port's own trained model loads into the JAX package
    ours_trained.save(str(tmp_path / "own.nn"))
    own = jax_nn.NeuralNetworkClassifier()
    own.load(str(tmp_path / "own.nn"))
    np.testing.assert_allclose(own.predict(x), ours_trained.predict(torch.from_numpy(x)).numpy(),
                               rtol=0, atol=1e-6)


def test_untrained_tree_keeps_creation_order_and_round1_files_load(tmp_path):
    cfg = dict(BASE, config_backprop="false", **layer(1, "dense", 4, "relu"),
               **layer(2, "output", 2, "softmax"))
    x, y = make_data(n=16)
    ours, theirs = fit_both(cfg, x, y)
    theirs.save(str(tmp_path / "jax.nn"))
    ours.save(str(tmp_path / "port.nn"))
    assert (tmp_path / "port.nn").read_bytes() == (tmp_path / "jax.nn").read_bytes()
    # a round-1 file: no layer_types in the arch
    raw = (tmp_path / "jax.nn").read_bytes()
    hlen = int.from_bytes(raw[:8], "little")
    header = json.loads(raw[8:8 + hlen])
    del header["arch"]["layer_types"]
    text = json.dumps(header)
    (tmp_path / "r1.nn").write_bytes(len(text).to_bytes(8, "little") + text.encode()
                                     + raw[8 + hlen:])
    old_ours, old_jax = nn.NeuralNetworkClassifier(), jax_nn.NeuralNetworkClassifier()
    old_ours.load(str(tmp_path / "r1.nn"))
    old_jax.load(str(tmp_path / "r1.nn"))
    assert old_ours._arch == old_jax._arch
    np.testing.assert_allclose(old_ours.predict(torch.from_numpy(x)).numpy(),
                               old_jax.predict(x), rtol=0, atol=1e-6)


def test_refusals_match_jax(tmp_path):
    (tmp_path / "m.zip").write_bytes(b"PK\x03\x04rest")
    for cls in (nn.NeuralNetworkClassifier, jax_nn.NeuralNetworkClassifier):
        with pytest.raises(NotImplementedError, match="DL4J ModelSerializer zip"):
            cls().load(str(tmp_path / "m.zip"))
        with pytest.raises(NotImplementedError, match="config_model_format=mllib"):
            cls().set_config({"config_model_format": "mllib"})
    with pytest.raises(ValueError, match="not trained or loaded"):
        nn.NeuralNetworkClassifier().predict(torch.zeros((1, 3)))


def test_registry_creates_nn_and_keeps_the_tree_families_out():
    """The registry creates nn and the six tree names (the tree families
    were refused here until they were ported; the name is kept), each
    the JAX registry's class and backend, and refuses none."""
    from eeg_dataanalysispackage_tpu.models import registry as jax_registry

    from eeg_dataanalysispackage_tpu_torch.models import trees

    assert isinstance(registry.create("nn"), nn.NeuralNetworkClassifier)
    assert registry.NOT_PORTED == ()
    for name, cls, backend in (
        ("dt", trees.DecisionTreeClassifier, "host"),
        ("rf", trees.RandomForestClassifier, "host"),
        ("dt-tpu", trees.DecisionTreeClassifier, "device"),
        ("rf-tpu", trees.RandomForestClassifier, "device"),
        ("gbt", trees.GradientBoostedTreesClassifier, "host"),
        ("gbt-tpu", trees.GradientBoostedTreesClassifier, "device"),
    ):
        clf, theirs = registry.create(name), jax_registry.create(name)
        assert type(clf) is cls and clf.backend == backend
        assert type(clf).__name__ == type(theirs).__name__ and theirs.backend == backend
    with pytest.raises(ValueError, match="Unsupported classifier argument"):
        registry.create("xgb")


# -- the pipeline ------------------------------------------------------------------


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("nn")), n_markers=120)


def near_threshold_rows(builder) -> int:
    clf, rows = builder.classifier, np.asarray(builder.test_index, np.int64)
    if builder.features is not None:
        feats = builder.features[torch.as_tensor(rows)]
    else:
        feats = builder.fe.extract_batch(builder.batch.epochs[rows])
    p = clf.predict(feats).numpy()
    return int((np.abs(p - 0.5) < NEAR).sum())


def assert_statistics_match(ours, theirs, near: int) -> None:
    """Counts equal except rows flipped across 0.5 (at most one, and
    only when a prediction lies within NEAR of it); MSE and class sums
    within float32 rounding of the predictions."""
    a, b = ours.statistics, theirs
    flips = (abs(a.true_positives - b.true_positives) + abs(a.true_negatives - b.true_negatives)
             + abs(a.false_positives - b.false_positives)
             + abs(a.false_negatives - b.false_negatives)) // 2
    assert flips <= min(near, 1), (str(a), str(b))
    assert a.num_patterns == b.num_patterns
    np.testing.assert_allclose(a.mse, b.mse, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a.class1_sum, b.class1_sum, rtol=0, atol=1e-3)
    np.testing.assert_allclose(a.class2_sum, b.class2_sum, rtol=0, atol=1e-3)


@pytest.mark.parametrize("fe", ["dwt-8-fused", "dwt-8"])
def test_pipeline_config_a_matches_jax(session, fe, tmp_path):
    q = f"info_file={session}&fe={fe}&train_clf=nn{CONFIG_A}"
    ours = PipelineBuilder(q + f"&save_clf=true&save_name={tmp_path}/port.nn", device="cpu")
    ours.execute()
    theirs = JaxBuilder(q + f"&save_clf=true&save_name={tmp_path}/jax.nn").execute()
    assert_statistics_match(ours, theirs, near_threshold_rows(ours))
    assert ours.statistics.mse > 0.0  # the incremental add() statistics
    # load_clf=nn of either package's file, in the port
    for name in ("port.nn", "jax.nn"):
        loaded = PipelineBuilder(f"info_file={session}&fe={fe}&load_clf=nn"
                                 f"&load_name={tmp_path}/{name}", device="cpu")
        loaded.execute()
        jax_loaded = JaxBuilder(f"info_file={session}&fe={fe}&load_clf=nn"
                                f"&load_name={tmp_path}/{name}").execute()
        assert_statistics_match(loaded, jax_loaded, near_threshold_rows(loaded))
