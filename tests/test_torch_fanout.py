"""The port's ``classifiers=`` fan-out against single runs and the JAX
package.

Twins of the fan-out cases of ``tests/test_feature_cache.py``: every leg's
statistics equal its ``train_clf=`` run (fused path, and the host ``fe=``
paths where the whole batch is featurized once), the ``result_path``
report concatenates the legs in request order, the conflicts carry the
JAX package's text and an unknown name the reference's error. The
fan-out's rendered text equals the JAX package's on the same session.
"""

import os
import sys

import pytest

from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.models import stats
from eeg_dataanalysispackage_tpu_torch.obs import events
from eeg_dataanalysispackage_tpu_torch.ops import dwt_cuda
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

_NN = ("config_seed=1&config_num_iterations=20&config_learning_rate=0.1"
       "&config_momentum=0.9&config_weight_init=xavier&config_updater=nesterovs"
       "&config_optimization_algo=stochastic_gradient_descent&config_pretrain=false"
       "&config_backprop=true&config_loss_function=xent"
       "&config_layer1_layer_type=dense&config_layer1_n_out=8&config_layer1_drop_out=0.0"
       "&config_layer1_activation_function=relu&config_layer2_layer_type=output"
       "&config_layer2_n_out=2&config_layer2_drop_out=0.0"
       "&config_layer2_activation_function=softmax")


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fanout")
    lines = []
    for i in range(2):
        _synthetic.write_recording(str(d), name=f"synth_{i:02d}", n_markers=30,
                                   guessed=2 + i, seed=i)
        lines.append(f"synth_{i:02d}.eeg {2 + i}")
    path = os.path.join(str(d), "info.txt")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _query(info, classifier, fe="dwt-8-fused", **extra):
    parts = [f"info_file={info}", f"fe={fe}", classifier, "config_num_iterations=10",
             "config_step_size=1.0", "config_mini_batch_fraction=1.0"]
    parts += [f"{k}={v}" for k, v in extra.items()]
    return "&".join(parts)


def _run(query):
    b = PipelineBuilder(query, device="cpu")
    b.execute()
    return b


@pytest.mark.parametrize("fe", ["dwt-8-fused", "dwt-8", "dwt-8-pallas", "dwt-8-tpu"])
def test_fanout_matches_single_classifier_runs(info, fe):
    names = ("logreg", "svm", "dt", "rf", "gbt-tpu", "nn")
    fan = _run(_query(info, "classifiers=" + ",".join(names), fe=fe) + "&" + _NN)
    assert isinstance(fan.statistics, stats.FanOutStatistics)
    assert list(fan.statistics) == list(names)
    for name in names:
        single = _run(_query(info, f"train_clf={name}", fe=fe) + "&" + _NN).statistics
        assert str(fan.statistics[name]) == str(single), name
        assert fan.statistics[name].mse == single.mse, name


def test_fanout_result_path_report(info, tmp_path):
    result = tmp_path / "report.txt"
    fan = _run(_query(info, "classifiers=logreg,svm", result_path=result)).statistics
    text = result.read_text()
    assert text.startswith("classifier: logreg\n") and "classifier: svm\n" in text
    assert text == f"classifier: logreg\n{fan['logreg']}\nclassifier: svm\n{fan['svm']}\n"


@pytest.mark.parametrize("fe", ["dwt-8-fused", "dwt-8"])
def test_fanout_text_equals_the_jax_package(info, fe):
    query = _query(info, "classifiers=logreg,svm,dt,rf", fe=fe)
    assert str(_run(query).statistics) == str(JaxBuilder(query).execute())


def test_fanout_host_fe_path_extracts_once(info):
    """fe=dwt-8-pallas featurizes the whole batch in one extraction (one
    launch on the card; its plain version here), spanned and timed as the
    run's features stage."""
    with events.recording(events.SpanRecorder()) as rec:
        fan = _run(_query(info, "classifiers=logreg,rf", fe="dwt-8-pallas"))
    assert [s["name"] for s in rec.spans()].count("stage.features") == 1
    assert "features" in fan.timers and fan.features.shape[0] == len(fan.targets)
    assert dwt_cuda.LAUNCHES == 0  # the CPU path runs the plain version
    assert sorted(fan.classifiers) == ["logreg", "rf"]


def test_fanout_counts_and_spans_each_leg(info):
    before = obs.metrics.snapshot()["counters"].get("pipeline.fanout.classifiers", 0.0)
    with events.recording(events.SpanRecorder()) as rec:
        _run(_query(info, "classifiers=logreg,dt"))
    names = [s["name"] for s in rec.spans()]
    assert names.count("fanout.logreg") == 1 and names.count("fanout.dt") == 1
    after = obs.metrics.snapshot()["counters"]["pipeline.fanout.classifiers"]
    assert after - before == 2


@pytest.mark.parametrize("classifier", [
    "classifiers=logreg&train_clf=svm",
    "classifiers=logreg&load_clf=svm",
    "classifiers=logreg&save_clf=true",
    "classifiers=logreg&elastic=true",
    "classifiers=,",
    "classifiers=logreg&cv=2&save_clf=true",
])
def test_fanout_rejects_conflicts_with_the_jax_text(tmp_path, classifier):
    query = _query(str(tmp_path / "absent.txt"), classifier)
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(query)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(query, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


def test_fanout_unknown_classifier_uses_reference_error(info):
    with pytest.raises(ValueError, match="Unsupported classifier"):
        _run(_query(info, "classifiers=logreg,nosuch"))
