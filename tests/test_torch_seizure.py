"""The port's ``task=seizure`` workload against the JAX package's.

Twins of ``tests/test_seizure_pipeline.py`` and of the extended
statistics of ``tests/test_stats_metrics.py``, on the JAX package's
seizure fixture (``write_seizure_session(n_files=2, n_samples=40000)``):

- logreg and svm runs (plain, ``cost_fn=8``, ``class_weight=balanced``)
  and ``load_clf=``: ``result_path`` text byte-equal to the JAX
  package's; nn and rf within the tolerances of
  ``tests/test_torch_nn.py`` and ``tests/test_torch_trees.py``, flips
  counted;
- ``seizure_weights`` and the workload record equal to the JAX
  package's; fan-out legs train with the resolved weights;
- ``fe_sweep=``: batched and looped ``result_path`` byte-equal, members
  equal to the JAX package's block (labels, shape, accuracy), the
  mismatched-shape and conflict errors;
- ``serve=true``: statistics equal to the port's batch ``load_clf=`` run
  and to the JAX package's served run; ``serve_threshold=`` raises recall;
- errors: ``task=zap`` and a ``-fused`` ``fe=`` raise the JAX package's
  messages; a P300 run is unchanged by ``cost_fn=``; ``elastic=true``
  equals the plain run; the CLI prints the extended text.

The JAX package's runs are shared at module scope (``_jax``).
"""

import functools
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch.models import stats
from eeg_dataanalysispackage_tpu_torch.pipeline import cli
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

_LINEAR = "config_num_iterations=60&config_step_size=1.0&config_mini_batch_fraction=1.0"
_SVM = _LINEAR + "&config_reg_param=0.01"
_FE = "fe=dwt-4:level=4:stats=energy,std"
_SWEEP = "fe_sweep=dwt-4:level=4:stats=energy,std|dwt-8:level=4:stats=energy,std"
NEAR = 1e-4  # an nn test row may flip only with its prediction this close to 0.5


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    return _synthetic.write_seizure_session(
        str(tmp_path_factory.mktemp("torch_seizure")), n_files=2, n_samples=40000)


@pytest.fixture(scope="module")
def saved(info, tmp_path_factory):
    """A logreg model trained and saved by the port (cost_fn=8)."""
    path = str(tmp_path_factory.mktemp("torch_seizure_model") / "model")
    _run(_q(info, _FE, "train_clf=logreg", _LINEAR, "cost_fn=8", "save_clf=true",
            f"save_name={path}"))
    return path


def _q(info, *parts):
    return "&".join([f"info_file={info}", "task=seizure", *parts])


def _run(query):
    b = PipelineBuilder(query, device="cpu")
    b.execute()
    return b


@functools.lru_cache(maxsize=None)
def _jax(query):
    return JaxBuilder(query + "&cache=false").execute()


def _result_text(query, tmp_path, tag):
    path = tmp_path / f"{tag}.txt"
    return path, f"{query}&result_path={path}"


# -- statistics against the JAX package -----------------------------------------


@pytest.mark.parametrize("extra", ["", "cost_fp=1&cost_fn=8", "class_weight=balanced"],
                         ids=["plain", "cost_fn=8", "balanced"])
@pytest.mark.parametrize("clf", ["logreg", "svm"])
def test_result_path_byte_equal_to_jax(info, tmp_path, clf, extra):
    q = _q(info, _FE, f"train_clf={clf}", _SVM if clf == "svm" else _LINEAR, extra)
    ours_path, ours_q = _result_text(q, tmp_path, "port")
    theirs_path, theirs_q = _result_text(q, tmp_path, "jax")
    b = _run(ours_q)
    JaxBuilder(theirs_q + "&cache=false").execute()
    text = ours_path.read_text()
    assert text == theirs_path.read_text()
    assert "Expected cost (fp=" in text and b.statistics.extended_report
    assert {"ingest", "parse", "epoch", "features", "train", "test"} <= set(b.timers)


def test_cost_sensitive_training_lowers_expected_cost(info):
    base = _q(info, _FE, "train_clf=logreg", _LINEAR)
    plain = _run(base).statistics
    weighted = _run(base + "&cost_fp=1&cost_fn=8").statistics
    assert weighted.expected_cost(1, 8) < plain.expected_cost(1, 8)
    assert weighted.recall() > (0.0 if math.isnan(plain.recall()) else plain.recall())
    # the true confusion matrix: over-prediction lands on false positives
    heavy = _run(base + "&class_weight=50").statistics
    assert heavy.false_positives >= heavy.false_negatives and heavy.recall() >= 0.9
    assert heavy.class1_sum + heavy.class2_sum > 0
    assert str(heavy) == str(_jax(base + "&class_weight=50"))


def test_load_clf_byte_equal_to_jax(info, saved, tmp_path):
    q = _q(info, _FE, "load_clf=logreg", f"load_name={saved}", "cost_fn=8")
    b = _run(q)
    assert str(b.statistics) == str(_jax(q))
    assert len(b.test_index) == len(b.targets)  # load tests every window


def _flips(a, b):
    return (abs(a.true_positives - b.true_positives) + abs(a.true_negatives - b.true_negatives)
            + abs(a.false_positives - b.false_positives)
            + abs(a.false_negatives - b.false_negatives)) // 2


_NN = ("config_seed=7&config_num_iterations=8&config_learning_rate=0.1"
       "&config_momentum=0.9&config_weight_init=xavier&config_updater=nesterovs"
       "&config_optimization_algo=stochastic_gradient_descent&config_pretrain=false"
       "&config_backprop=true&config_loss_function=xent"
       "&config_layer1_layer_type=dense&config_layer1_n_out=6&config_layer1_drop_out=0.0"
       "&config_layer1_activation_function=relu&config_layer2_layer_type=output"
       "&config_layer2_n_out=2&config_layer2_drop_out=0.0"
       "&config_layer2_activation_function=softmax")


@pytest.mark.parametrize("clf", ["nn", "rf"])
def test_nn_and_rf_within_tolerance(info, clf):
    """nn: counts equal except rows whose prediction lies within NEAR of
    0.5 (at most one), MSE and class sums within float32 rounding (the
    rule of tests/test_torch_nn.py); rf: the host grower is bit-equal, so
    the text is."""
    q = _q(info, _FE, f"train_clf={clf}", "cost_fn=8", _NN if clf == "nn" else "")
    b = _run(q)
    theirs = _jax(q)
    ours = b.statistics
    assert ours.extended_report and ours.cost_fn == 8.0
    if clf == "rf":
        assert str(ours) == str(theirs)
        return
    rows = torch.as_tensor(np.asarray(b.test_index, np.int64))
    p = b.classifier.predict(b.features[rows]).numpy()
    near = int((np.abs(p - 0.5) < NEAR).sum())
    flips = _flips(ours, theirs)
    print(f"seizure nn: {flips} flipped rows, {near} within {NEAR} of 0.5")
    assert flips <= min(near, 1), (str(ours), str(theirs))
    np.testing.assert_allclose(ours.mse, theirs.mse, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours.class1_sum, theirs.class1_sum, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ours.class2_sum, theirs.class2_sum, rtol=0, atol=1e-3)


@pytest.mark.parametrize("qm", [
    {}, {"cost_fp": "1", "cost_fn": "8"}, {"class_weight": "balanced"},
    {"class_weight": "2.5", "cost_fn": "3"}, {"cost_fp": "0.5"},
], ids=lambda q: "&".join(f"{k}={v}" for k, v in q.items()) or "defaults")
def test_seizure_weights_equal_jax(info, qm):
    targets = _run(_q(info, _FE, "train_clf=logreg", _LINEAR)).targets
    assert PipelineBuilder.seizure_weights(qm, targets) == JaxBuilder.seizure_weights(qm, targets)
    balanced = PipelineBuilder.seizure_weights({"class_weight": "balanced"}, np.zeros(5))
    assert balanced == JaxBuilder.seizure_weights({"class_weight": "balanced"}, np.zeros(5))


def test_workload_block_equals_the_jax_report(info, tmp_path):
    q = _q(info, _FE, "train_clf=logreg", _LINEAR, "class_weight=balanced", "window=512",
           "stride=256")
    report = tmp_path / "report"
    JaxBuilder(q + f"&cache=false&report={report}").execute()
    with open(report / "run_report.json") as f:
        theirs = json.load(f)
    ours = _run(q)
    assert ours.workload_block == theirs["workload"]
    # the JAX package's report rounds to 6 places
    assert theirs["classification"]["expected_cost"] == round(
        ours.statistics.extended_summary()["expected_cost"], 6)


def test_fanout_legs_carry_the_resolved_weights(info):
    q = _q(info, _FE, "classifiers=logreg,svm", _SVM, "cost_fp=1", "cost_fn=8")
    b = _run(q)
    assert isinstance(b.statistics, stats.FanOutStatistics)
    assert str(b.statistics) == str(_jax(q))
    for name in ("logreg", "svm"):
        leg = b.statistics[name]
        assert leg.extended_report and leg.recall() >= 0.9, name
        assert b.classifiers[name].config["config_weight_pos"] == repr(8.0)
        single = _run(_q(info, _FE, f"train_clf={name}", _SVM, "cost_fp=1", "cost_fn=8"))
        assert str(leg) == str(single.statistics)


# -- fe_sweep= populations ---------------------------------------------------------


@pytest.mark.parametrize("extra", ["sweep=cost_fn:1,8", "cv=2&sweep=cost_fn:2,8"],
                         ids=["single_fold", "cv=2"])
def test_fe_sweep_batched_equals_looped_and_jax(info, tmp_path, extra):
    q = _q(info, _SWEEP, "train_clf=logreg", _LINEAR, extra)
    paths = {}
    for mode in ("vmap", "looped"):
        paths[mode], query = _result_text(q + f"&population_mode={mode}", tmp_path, mode)
        b = _run(query)
        assert b.statistics.mode == mode
    assert paths["vmap"].read_text() == paths["looped"].read_text()
    theirs = _jax(q)
    ours = b.statistics
    assert list(ours) == list(theirs) and len(ours) == (4 if "cv" not in extra else 8)
    assert all(label.startswith(("fe0.", "fe1.")) for label in ours)
    assert str(ours) == str(theirs)
    assert b.population_block["shape"]["fe_configs"] == list(_SWEEP[9:].split("|"))
    assert b.population_block["accuracy"] == {
        label: round(s.calc_accuracy(), 6) for label, s in theirs.items()}
    assert all(s.extended_report for s in ours.values())


def test_fe_sweep_stacked_engine_equals_looped_members(info):
    """The stacked engine's members: each member's weights equal its
    looped twin's within float32 roundoff (both on the CPU)."""
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import population as engines

    b = _run(_q(info, "fe=dwt-4:level=4:stats=energy,std", "train_clf=logreg", _LINEAR))
    c = _run(_q(info, "fe=dwt-8:level=4:stats=energy,std", "train_clf=logreg", _LINEAR))
    x = torch.stack([b.features, c.features]).to(torch.float32)
    y = torch.as_tensor(b.targets, dtype=torch.float32)
    cfg = sgd.SGDConfig(num_iterations=60)
    args = (cfg, [1.0, 0.5], [0.0, 0.01], [42, 42], None)
    w, _conv, _updates = engines.train_linear_population(
        x, y, *args, weight_pos=[8.0, 1.0])
    looped = engines.train_linear_population_looped(
        x, y, *args, weight_pos=[8.0, 1.0])
    np.testing.assert_allclose(w.numpy(), looped.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("extra", [
    ("fe_sweep=dwt-4:level=4:stats=energy|dwt-4:level=4:stats=energy,std",
     "train_clf=logreg"),
    ("fe_sweep=dwt-4:level=2|dwt-8:level=2", "window=512", "train_clf=nn"),
    (_SWEEP, "classifiers=logreg,svm"),
    (_SWEEP, "load_clf=logreg", "load_name=/nonexistent"),
    (_SWEEP, "train_clf=dt"),
    (_SWEEP, "train_clf=logreg", "save_clf=true", "save_name=/tmp/never"),
    ("fe_sweep=dwt-4:level=2|dwt-4:level=2", "train_clf=logreg"),
], ids=["shapes", "nn", "classifiers", "load_clf", "dt", "save_clf", "repeat"])
def test_fe_sweep_errors_carry_the_jax_text(info, extra):
    q = _q(info, _LINEAR, *extra)
    with pytest.raises(ValueError) as theirs:
        JaxBuilder(q + "&cache=false").execute()
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


def test_fe_sweep_requires_task_seizure(info):
    q = f"info_file={info}&fe_sweep=dwt-4:level=2|dwt-8:level=2&fe=dwt-8&train_clf=logreg"
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(q)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value) and "requires task=seizure" in str(ours.value)


# -- serving -----------------------------------------------------------------------


def _load_q(info, saved, *parts):
    return _q(info, _FE, "load_clf=logreg", f"load_name={saved}", "cost_fn=8", *parts)


def test_served_statistics_equal_the_batch_run_and_jax(info, saved):
    batch = _run(_load_q(info, saved))
    served = PipelineBuilder(_load_q(info, saved, "serve=true"), device="cpu")
    text = str(served.execute())
    assert text == str(batch.statistics)
    assert text == str(_jax(_load_q(info, saved, "serve=true")))
    block = served.serve_block
    assert block["mode"] == "host-extractor" and block["rung"] == "host"
    assert block["drained_cleanly"] is True
    assert block["requests"]["completed"] == block["requests"]["total_epochs"] == len(
        batch.targets)
    assert served.workload_block["windows"] == len(batch.targets)
    assert served.workload_block["serve_threshold"] is None
    assert {"ingest", "serve", "test"} <= set(served.timers)


def test_serve_threshold_raises_recall(info, saved):
    default = _run(_load_q(info, saved, "serve=true")).statistics
    tuned = _run(_load_q(info, saved, "serve=true", "serve_threshold=-5.0"))
    assert tuned.statistics.recall() >= default.recall()
    assert (tuned.statistics.true_positives + tuned.statistics.false_positives
            >= default.true_positives + default.false_positives)
    assert tuned.serve_block["serve_threshold"] == -5.0
    assert str(tuned.statistics) == str(_jax(_load_q(info, saved, "serve=true",
                                                     "serve_threshold=-5.0")))


@pytest.mark.parametrize("extra", ["fe=dwt-8-fused", "serve_threshold=zap", "train_clf=logreg",
                                   "cv=2", "window=x"])
def test_serve_errors_carry_the_jax_text(info, saved, extra):
    q = _q(info, "load_clf=logreg", f"load_name={saved}", "serve=true",
           *([] if extra.startswith("fe=") else [_FE]), extra)
    with pytest.raises(ValueError) as theirs:
        JaxBuilder(q + "&cache=false").execute()
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


# -- errors and the P300 surface ------------------------------------------------


@pytest.mark.parametrize("query", [
    "task=zap&fe=dwt-8&train_clf=logreg",
    "task=seizure&fe=dwt-8-fused&train_clf=logreg",
    "task=seizure&fe=dwt-4:level=2&train_clf=logreg&class_weight=zap",
    "task=seizure&fe=dwt-4:level=2&train_clf=logreg&class_weight=-2",
    "task=seizure&fe=dwt-4:level=2&train_clf=logreg&cost_fp=-1",
    "task=seizure&fe=dwt-4:level=2&train_clf=logreg&window=abc",
    "task=seizure&train_clf=logreg",
    "task=seizure&fe=dwt-4:level=2",
    "task=seizure&fe=dwt-4:level=2&train_clf=logreg&label_overlap=2",
    "task=seizure&fe=dwt-4:level=9&train_clf=logreg",
    "task=seizure&fe=dwt-4:level=2&train_clf=logreg&window=40001",
    "task=seizure&fe=dwt-8-pallas&train_clf=logreg",
], ids=["task=zap", "fused", "class_weight=zap", "class_weight<0", "cost_fp<0",
        "window=abc", "no_fe", "no_classifier", "label_overlap", "too_deep", "no_windows",
        "pallas_short_window"])
def test_errors_carry_the_jax_text(info, query):
    q = f"info_file={info}&{query}"
    with pytest.raises(ValueError) as theirs:
        JaxBuilder(q + "&cache=false").execute()
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


def test_p300_run_unchanged_by_cost_knobs(tmp_path):
    info = _synthetic.write_session(str(tmp_path), n_markers=30)
    q = f"info_file={info}&fe=dwt-8&train_clf=logreg&{_LINEAR}"
    plain = _run(q).statistics
    costed = _run(q + "&cost_fn=8&class_weight=balanced").statistics
    assert str(plain) == str(costed) == str(JaxBuilder(q + "&cost_fn=8").execute())
    assert "Precision" not in str(plain) and plain.extended_report is False


def test_p300_host_run_with_a_subband_fe_equals_jax(tmp_path):
    info = _synthetic.write_session(str(tmp_path), n_markers=30)
    q = f"info_file={info}&fe=dwt-8:level=4:stats=energy,std&train_clf=logreg&{_LINEAR}"
    assert str(_run(q).statistics) == str(JaxBuilder(q + "&cache=false").execute())


def test_elastic_run_equals_the_plain_run(info, tmp_path):
    base = _q(info, _FE, "train_clf=logreg", _LINEAR, "cost_fn=8")
    elastic = _run(base + f"&elastic=true&checkpoint_path={tmp_path}/ck")
    assert str(elastic.statistics) == str(_run(base).statistics) == str(_jax(base))
    assert not os.listdir(tmp_path / "ck")  # cleared when training ended


def test_cli_prints_the_extended_text(info, capsys, monkeypatch):
    q = _q(info, _FE, "train_clf=svm", _SVM, "cost_fn=8")
    import eeg_dataanalysispackage_tpu_torch.pipeline.builder as builder_mod

    # the CLI's device=None resolved to the CPU
    monkeypatch.setattr(builder_mod, "resolve_device", lambda device=None: torch.device("cpu"))
    assert cli.main([q]) == 0
    assert capsys.readouterr().out == str(_jax(q))


def test_extended_metrics_equal_jax_on_edge_counts():
    from eeg_dataanalysispackage_tpu.models import stats as jax_stats

    for counts in ((0, 0, 0, 0), (3, 5, 0, 0), (0, 9, 2, 0), (0, 0, 1, 4), (7, 11, 3, 2)):
        ours, theirs = stats.ClassificationStatistics(*counts), jax_stats.ClassificationStatistics(
            *counts)
        assert str(ours) == str(theirs)  # the reference text, unextended
        stats.mark_extended(ours, 2.0, 5.0)
        jax_stats.mark_extended(theirs, 2.0, 5.0)
        assert str(ours) == str(theirs)
        assert repr(ours.extended_summary()) == repr(theirs.extended_summary())
