"""The port's population training against the JAX package's.

Twins of ``tests/test_population.py``: ``cv=1&seeds=1`` is the plain
split; every single-fold member equals the ``train_clf=`` run with its
hyperparameters; the batched engines equal their looped twins (multi-fold,
mini-batch, nn); a multi-fold nn population falls back to looped; the fold
arithmetic; the conflict and validation messages (the JAX package's text,
raised before any file is read); fan-out legs through the population;
the population block, member spans and ``result_path`` text. Against the
JAX package on the same sessions: per-member statistics and the rendered
text, and the linear engines' member weights within 1e-6 relative.
"""

import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import population as jax_population
from eeg_dataanalysispackage_tpu.parallel import population as jax_engines
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.models import population, sgd, stats
from eeg_dataanalysispackage_tpu_torch.obs import events
from eeg_dataanalysispackage_tpu_torch.parallel import population as engines
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.utils import java_compat

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

NEAR = 1e-4  # a member's test row may differ only with its margin this close to 0


def _session(directory, n_files=2, n_markers=50):
    lines = []
    for i in range(n_files):
        name = f"synth_{i:02d}"
        _synthetic.write_recording(str(directory), name=name, n_markers=n_markers,
                                   guessed=2 + i, seed=i)
        lines.append(f"{name}.eeg {2 + i}")
    info = os.path.join(str(directory), "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    return _session(tmp_path_factory.mktemp("torch_pop_session"))


_LINEAR_CONFIG = ("config_num_iterations=12&config_step_size=1.0"
                  "&config_mini_batch_fraction=1.0&config_reg_param=0.01")

_NN_CONFIG = (
    "config_seed=7&config_num_iterations=8&config_learning_rate=0.1"
    "&config_momentum=0.9&config_weight_init=xavier&config_updater=nesterovs"
    "&config_optimization_algo=stochastic_gradient_descent"
    "&config_pretrain=false&config_backprop=true&config_loss_function=xent"
    "&config_layer1_layer_type=dense&config_layer1_n_out=6"
    "&config_layer1_drop_out=0.0&config_layer1_activation_function=relu"
    "&config_layer2_layer_type=output&config_layer2_n_out=2"
    "&config_layer2_drop_out=0.0&config_layer2_activation_function=softmax"
)


def _q(info, *parts):
    return "&".join([f"info_file={info}", "fe=dwt-8-fused", *parts])


def _run(query):
    b = PipelineBuilder(query, device="cpu")
    b.execute()
    return b


@functools.lru_cache(maxsize=None)
def _jax(query):
    return JaxBuilder(query).execute()


# -- parity contracts ----------------------------------------------------------


def test_cv1_seeds1_statistics_identical_to_plain_split(info):
    plain = _run(_q(info, "train_clf=logreg", _LINEAR_CONFIG)).statistics
    pop = _run(_q(info, "train_clf=logreg", _LINEAR_CONFIG, "cv=1", "seeds=1",
                  "sweep=lr:1.0")).statistics
    assert isinstance(pop, stats.PopulationStatistics)
    assert list(pop) == ["f0.s42.lr1"]
    assert str(pop["f0.s42.lr1"]) == str(plain)


def test_members_bit_parity_vs_sequential_train_clf_runs(info):
    pop = _run(_q(info, "train_clf=svm", _LINEAR_CONFIG,
                  "sweep=lr:1.0,0.5;reg:0.0,0.01")).statistics
    assert len(pop) == 4
    for lr in (1.0, 0.5):
        for reg in (0.0, 0.01):
            label = f"f0.s42.lr{lr:g}.reg{reg:g}"
            sequential = _run(_q(info, "train_clf=svm", "config_num_iterations=12",
                                 f"config_step_size={lr}", "config_mini_batch_fraction=1.0",
                                 f"config_reg_param={reg}")).statistics
            assert str(pop[label]) == str(sequential), label


@pytest.mark.parametrize("extra", [
    ("train_clf=logreg", _LINEAR_CONFIG, "cv=3", "seeds=2", "sweep=lr:1.0,0.5"),
    ("train_clf=logreg", "config_num_iterations=12", "config_step_size=1.0",
     "config_mini_batch_fraction=0.5", "cv=2", "seeds=2"),
], ids=["multi_fold", "multi_fold_minibatch"])
def test_vmapped_equals_looped(info, extra):
    vm = _run(_q(info, *extra))
    lo = _run(_q(info, *extra, "population_mode=looped"))
    assert vm.statistics.mode == "vmap" and lo.statistics.mode == "looped"
    assert list(vm.statistics) == list(lo.statistics)
    for label in vm.statistics:
        assert str(vm.statistics[label]) == str(lo.statistics[label]), label
        np.testing.assert_allclose(vm.population_states[label]["state"].numpy(),
                                   lo.population_states[label]["state"].numpy(),
                                   rtol=0, atol=1e-6)
    # the result_path text: the mode is absent from it
    assert str(vm.statistics) == str(lo.statistics)
    if "config_mini_batch_fraction=0.5" in extra:
        s = vm.statistics
        assert str(s["f0.s42"]) != str(s["f0.s43"]) or str(s["f1.s42"]) != str(s["f1.s43"])


def test_nn_population_vmap_equals_looped(info):
    base = _q(info, "train_clf=nn", _NN_CONFIG, "seeds=2", "sweep=lr:0.1,0.05")
    vm, lo = _run(base), _run(base + "&population_mode=looped")
    assert vm.statistics.mode == "vmap" and lo.statistics.mode == "looped"
    assert list(vm.statistics) == list(lo.statistics) and len(vm.statistics) == 4
    for label in vm.statistics:
        assert str(vm.statistics[label]) == str(lo.statistics[label]), label
        np.testing.assert_allclose(vm.population_states[label]["predictions"],
                                   lo.population_states[label]["predictions"],
                                   rtol=0, atol=1e-6)


def test_nn_multi_fold_falls_back_to_looped(info):
    before = obs.metrics.snapshot()["counters"].get("population.fallback_looped", 0.0)
    b = _run(_q(info, "train_clf=nn", _NN_CONFIG, "cv=2"))
    assert b.statistics.mode == "looped" and len(b.statistics) == 2
    assert b.population_block["requested_mode"] == "vmap"
    after = obs.metrics.snapshot()["counters"]["population.fallback_looped"]
    assert after - before == 1


def test_minibatch_member_masks_are_mini_batch_mask_rows():
    """The batched engine draws a block of iterations for all members in
    one pass; every row equals the member's own sgd.mini_batch_mask."""
    seeds, ts = torch.tensor([42, 43, 7]), torch.arange(1, 9)
    masks = sgd.mini_batch_masks(seeds, ts, 203, 0.5)
    for i, t in enumerate(ts.tolist()):
        for j, seed in enumerate(seeds.tolist()):
            config = sgd.SGDConfig(mini_batch_fraction=0.5, seed=seed)
            assert torch.equal(masks[i, j], sgd.mini_batch_mask(config, t, 203))


def test_batched_engine_polls_instead_of_reading_back_per_iteration(monkeypatch):
    """The batched engine tests its members' convergence only at its
    polls: once every member has frozen it runs on to the next poll and
    stops there (one block of mini-batch draws instead of the whole
    run's), and each member's update count is the looped run's stop
    iteration. (The card test counts the synchronizing calls.)"""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(80, 48).astype(np.float32))
    y = torch.from_numpy((rng.rand(80) > 0.5).astype(np.float32))
    blocks = []
    draw = sgd.mini_batch_masks
    monkeypatch.setattr(sgd, "mini_batch_masks", lambda *a: blocks.append(a[1]) or draw(*a))
    for tol, want_blocks in ((1e-9, -(-300 // engines.POLL_EVERY)), (0.5, 1)):
        config = sgd.SGDConfig(num_iterations=300, convergence_tol=tol, mini_batch_fraction=0.5)
        blocks.clear()
        _w, converged, n_updates = engines.train_linear_population(
            x, y, config, [1.0, 0.5], [0.0, 0.0], [1, 2], None)
        assert len(blocks) == want_blocks
        for i, (step, seed) in enumerate(((1.0, 1), (0.5, 2))):
            cfg = dataclasses.replace(config, step_size=step, seed=seed)
            carry = sgd.partial_fit_linear(sgd.partial_fit_carry(48, device="cpu"), 0, x, y,
                                           cfg, 300, device="cpu")
            assert (bool(converged[i]), int(n_updates[i])) == (carry[1], carry[2])
        assert bool(converged.all()) == (tol == 0.5)


# -- fold semantics --------------------------------------------------------------


def test_kfold_partitions_every_row_once():
    folds = population.folds_for(population.PopulationSpec(cv=4), 103)
    seen = np.concatenate([test for _, test in folds])
    assert sorted(seen.tolist()) == list(range(103))
    for (train, test), (jtrain, jtest) in zip(
            folds, jax_population.folds_for(jax_population.PopulationSpec(cv=4), 103)):
        assert len(np.intersect1d(train, test)) == 0 and len(train) + len(test) == 103
        np.testing.assert_array_equal(train, jtrain)
        np.testing.assert_array_equal(test, jtest)


def test_mc_fold0_is_the_plain_split():
    folds = population.folds_for(population.PopulationSpec(cv=3, cv_mode="mc"), 40)
    train, test = java_compat.train_test_split_indices(40, seed=1)
    assert folds[0][0].tolist() == train and folds[0][1].tolist() == test
    assert len(folds) == 3


def test_cv_larger_than_rows_is_an_error():
    with pytest.raises(ValueError, match="exceeds"):
        population.folds_for(population.PopulationSpec(cv=9), 5)


def test_member_labels_and_order_equal_the_jax_package():
    spec = dict(cv=2, seeds=2, sweep=(("lr", (1.0, 0.5)), ("reg", (0.0, 0.01))))
    ours = population.expand_members(population.PopulationSpec(**spec), 2, 42, True)
    theirs = jax_population.expand_members(jax_population.PopulationSpec(**spec), 2, 42, True)
    assert [m.label for m in ours] == [m.label for m in theirs]


# -- pipeline wiring -------------------------------------------------------------


_CONFLICTS = [
    ("train_clf=logreg", "cv=2", "elastic=true", "checkpoint_path=/tmp/x"),
    ("train_clf=logreg", "cv=2", "save_clf=true", "save_name=/tmp/x"),
    ("load_clf=logreg", "load_name=/tmp/x", "cv=2"),
    ("train_clf=dt", "cv=2"),
    ("sweep=momentum:0.9", "train_clf=logreg"),
    ("sweep=lr:0.1;lr:0.2", "train_clf=logreg"),
    ("sweep=lr:abc", "train_clf=logreg"),
    ("sweep=lr:0.5,0.5", "train_clf=logreg"),
    ("cv_mode=bogus", "cv=2", "train_clf=logreg"),
    ("population_mode=turbo", "cv=2", "train_clf=logreg"),
    ("cv=0", "train_clf=logreg"),
    ("cv=two", "train_clf=logreg"),
    ("seeds=0", "train_clf=logreg"),
    ("fe_sweep=dwt-8|dwt-4", "train_clf=logreg"),
]


@pytest.mark.parametrize("extra", _CONFLICTS, ids=lambda e: "&".join(e))
def test_population_conflicts_carry_the_jax_text_before_reading(tmp_path, extra):
    """Every conflict and grammar error raises the JAX package's message,
    before the run reads anything (the session does not exist)."""
    query = _q(str(tmp_path / "missing" / "info.txt"), _LINEAR_CONFIG, *extra)
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(query)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(query, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


def test_fanout_routes_sgd_legs_through_population(info):
    b = _run(_q(info, "classifiers=logreg,dt", _LINEAR_CONFIG, "cv=2", "config_max_bins=16",
                "config_impurity=gini", "config_max_depth=4",
                "config_min_instances_per_node=1"))
    fan = b.statistics
    assert isinstance(fan["logreg"], stats.PopulationStatistics) and len(fan["logreg"]) == 2
    assert isinstance(fan["dt"], stats.ClassificationStatistics)
    assert set(b.population_block["legs"]) == {"logreg"}
    assert b.population_block["legs"]["logreg"]["members"] == 2
    assert str(fan) == str(_jax(_q(info, "classifiers=logreg,dt", _LINEAR_CONFIG, "cv=2",
                                   "config_max_bins=16", "config_impurity=gini",
                                   "config_max_depth=4", "config_min_instances_per_node=1")))


def test_population_block_and_member_spans(info):
    with events.recording(events.SpanRecorder()) as rec:
        b = _run(_q(info, "train_clf=logreg", _LINEAR_CONFIG, "cv=2", "seeds=2"))
    block = b.population_block
    assert sorted(block) == ["accuracy", "classifier", "compiles", "members", "mesh", "mode",
                             "requested_mode", "shape", "summary"]
    assert block["members"] == 4 == len(b.statistics) and block["mode"] == "vmap"
    assert block["mesh"] is None and block["compiles"] is None
    assert block["shape"]["folds"] == 2 and len(block["accuracy"]) == 4
    assert block["summary"]["best"] in block["accuracy"]
    names = [s["name"] for s in rec.spans()]
    assert names.count("population.member") == 4 and names.count("population.logreg") == 1


def test_population_result_path_text(info, tmp_path):
    result_path = tmp_path / "out.txt"
    pop = _run(_q(info, "train_clf=logreg", _LINEAR_CONFIG, "cv=2",
                  f"result_path={result_path}")).statistics
    text = result_path.read_text()
    assert text == str(pop) + "\n"
    assert text.startswith("population: 2 members")
    assert "best member:" in text and "member: f1.s42" in text


# -- against the JAX package -----------------------------------------------------


def _flips(a, b) -> int:
    return (abs(a.true_positives - b.true_positives) + abs(a.true_negatives - b.true_negatives)
            + abs(a.false_positives - b.false_positives)
            + abs(a.false_negatives - b.false_negatives)) // 2


@pytest.mark.parametrize("extra", [
    ("train_clf=logreg", _LINEAR_CONFIG, "cv=3", "seeds=2", "sweep=lr:1.0,0.5"),
    ("train_clf=svm", "config_num_iterations=12", "config_step_size=1.0",
     "config_mini_batch_fraction=0.5", "config_reg_param=0.01", "cv=2", "cv_mode=mc",
     "seeds=2"),
    ("train_clf=svm", _LINEAR_CONFIG, "sweep=lr:1.0,0.5;reg:0.0,0.01",
     "population_mode=looped"),
], ids=["logreg_kfold", "svm_mc_minibatch", "svm_grid_looped"])
def test_linear_members_equal_the_jax_package(info, extra):
    """Per-member statistics equal the JAX package's, except test rows
    whose margin lies within NEAR of the threshold (counted); with no
    such row the rendered text is byte-equal."""
    query = _q(info, *extra)
    ours, theirs = _run(query), _jax(query)
    assert list(ours.statistics) == list(theirs)
    near_rows = 0
    for label, s in ours.statistics.items():
        st = ours.population_states[label]
        rows = torch.as_tensor(st["test_index"])
        margins = (ours.features[rows] @ st["state"]).numpy()
        near = int((np.abs(margins) < NEAR).sum())
        near_rows += near
        assert _flips(s, theirs[label]) <= near, label
    print(f"{query[-60:]}: {near_rows} near-threshold member rows")
    if near_rows == 0:
        assert str(ours.statistics) == str(theirs)


def test_nn_members_equal_the_jax_package(info):
    query = _q(info, "train_clf=nn", _NN_CONFIG, "seeds=2", "sweep=lr:0.1,0.05")
    ours, theirs = _run(query), _jax(query)
    assert ours.statistics.mode == theirs.mode == "vmap"
    for label, s in ours.statistics.items():
        near = int((np.abs(ours.population_states[label]["predictions"] - 0.5) < NEAR).sum())
        assert _flips(s, theirs[label]) <= near, label
        np.testing.assert_allclose(s.mse, theirs[label].mse, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("frac,masks", [(1.0, False), (0.5, False), (0.5, True)])
def test_linear_engine_weights_within_1e6_of_the_jax_package(frac, masks):
    rng = np.random.RandomState(3)
    x = rng.randn(90, 48).astype(np.float32)
    y = (rng.rand(90) > 0.5).astype(np.float64)
    m = (rng.rand(4, 90) > 0.3).astype(np.float32) if masks else None
    args = ([1.0, 0.5, 1.0, 0.25], [0.0, 0.01, 0.01, 0.0], [42, 43, 44, 45], m)
    for loss in ("logistic", "hinge"):
        ours = engines.train_linear_population(
            torch.from_numpy(x), torch.from_numpy(y), sgd.SGDConfig(
                num_iterations=40, mini_batch_fraction=frac, loss=loss), *args)[0].numpy()
        from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd

        theirs = jax_engines.train_linear_population(
            x, y, jax_sgd.SGDConfig(num_iterations=40, mini_batch_fraction=frac, loss=loss),
            *args)
        scale = np.abs(theirs).max(axis=1, keepdims=True)
        assert (np.abs(ours - theirs) / scale).max() <= 1e-6, loss
