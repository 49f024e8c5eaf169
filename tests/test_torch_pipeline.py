"""The port's batch P300 slice end to end against the JAX package.

``PipelineBuilder(q, device="cpu")`` of the port must print the same
ClassificationStatistics as the JAX package's ``PipelineBuilder(q)`` for
``fe=dwt-8-fused`` with logreg and svm, on the 48-marker synthetic
session and on a 3-recording session whose balance scan runs across
files. Models saved by either package load into the other.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import linear as jax_linear
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import linear
from eeg_dataanalysispackage_tpu_torch.pipeline import cli
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402


@pytest.fixture(scope="module")
def one_file(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("one")))


@pytest.fixture(scope="module")
def three_files(tmp_path_factory):
    """Three recordings, listed out of name order, with different
    guessed numbers: the balance counters carry across files."""
    d = str(tmp_path_factory.mktemp("three"))
    lines = []
    for i, (guessed, n) in enumerate([(3, 150), (7, 90), (2, 200)]):
        name = f"rec_{i}"
        _synthetic.write_recording(d, name=name, n_markers=n, guessed=guessed, seed=10 + i)
        lines.append(f"{name}.eeg {guessed}")
    info = os.path.join(d, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(reversed(lines)) + "\n")
    return info


QUERIES = [
    "fe=dwt-8-fused&train_clf=logreg",
    "fe=dwt-8-fused&train_clf=svm",
    "fe=dwt-8-fused&train_clf=svm&config_num_iterations=50&config_step_size=0.5"
    "&config_reg_param=0.1&config_mini_batch_fraction=1.0",
]


@pytest.mark.parametrize("session", ["one_file", "three_files"])
@pytest.mark.parametrize("query", QUERIES)
def test_statistics_equal_jax_package(request, session, query, tmp_path):
    info = request.getfixturevalue(session)
    q = f"info_file={info}&{query}"
    ours = PipelineBuilder(q + f"&result_path={tmp_path}/ours.txt", device="cpu")
    got = str(ours.execute())
    want = str(JaxBuilder(q + f"&result_path={tmp_path}/jax.txt").execute())
    assert got == want
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert ours.features.device.type == "cpu"
    assert sorted(ours.timers) == ["featurize", "parse", "stage", "test", "train"]


def test_single_eeg_file_input_equals_jax_package(three_files):
    eeg = os.path.join(os.path.dirname(three_files), "rec_2.eeg")
    q = f"eeg_file={eeg}&guessed_num=2&fe=dwt-8-fused&train_clf=logreg"
    assert str(PipelineBuilder(q, device="cpu").execute()) == str(JaxBuilder(q).execute())


def test_fused_spellings_all_run_the_same_kernel_path(three_files):
    base = f"info_file={three_files}&train_clf=logreg&fe=dwt-8-fused"
    want = str(PipelineBuilder(base, device="cpu").execute())
    for suffix in ("-decode", "-pallas", "-block", "-xla"):
        assert str(PipelineBuilder(base + suffix, device="cpu").execute()) == want


def test_features_match_jax_provider(three_files):
    from eeg_dataanalysispackage_tpu.io.provider import OfflineDataProvider as JaxProvider

    feats, targets = OfflineDataProvider([three_files], device="cpu").load_features_device()
    want, want_targets = JaxProvider([three_files]).load_features_device(backend="decode")
    np.testing.assert_array_equal(targets, want_targets)
    np.testing.assert_allclose(feats.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("clf", ["logreg", "svm"])
def test_models_load_across_packages(three_files, tmp_path, clf):
    q = f"info_file={three_files}&fe=dwt-8-fused"
    # JAX saves, the port loads
    JaxBuilder(f"{q}&train_clf={clf}&save_clf=true&save_name={tmp_path}/jax_model").execute()
    got = str(PipelineBuilder(f"{q}&load_clf={clf}&load_name={tmp_path}/jax_model",
                              device="cpu").execute())
    want = str(JaxBuilder(f"{q}&load_clf={clf}&load_name={tmp_path}/jax_model").execute())
    assert got == want
    # the port saves, JAX loads: same labels on the same rows
    PipelineBuilder(f"{q}&train_clf={clf}&save_clf=true&save_name={tmp_path}/port_model",
                    device="cpu").execute()
    name = {"logreg": "LogisticRegressionClassifier", "svm": "SVMClassifier"}[clf]
    theirs, ours = getattr(jax_linear, name)(), getattr(linear, name)()
    theirs.load(f"{tmp_path}/port_model")
    ours.load(f"{tmp_path}/port_model")
    x = np.random.RandomState(4).randn(64, 48).astype(np.float32)
    np.testing.assert_array_equal(
        ours.predict(torch.from_numpy(x)).numpy(), theirs.predict(x)
    )
    state = ours.to_numpy_state()
    assert state["kind"] == name and state["weights"].dtype == np.float32
    np.testing.assert_array_equal(state["weights"], theirs.weights)


def test_no_silent_cpu_without_cuda(one_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    q = f"info_file={one_file}&fe=dwt-8-fused&train_clf=logreg"
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineBuilder(q)
    with pytest.raises(RuntimeError, match="CUDA"):
        OfflineDataProvider([one_file])
    assert cli.main([q]) == 1


@pytest.mark.parametrize(
    "extra",
    ["classifiers=logreg,svm", "precision=bf16", "overlap=true", "devices=2",
     "serve=true", "task=seizure", "cv=3", "elastic=true"],
)
def test_unported_keys_raise(one_file, extra):
    q = f"info_file={one_file}&fe=dwt-8-fused&train_clf=logreg&{extra}"
    with pytest.raises(ValueError, match="not yet ported"):
        PipelineBuilder(q, device="cpu").execute()


@pytest.mark.parametrize("fe", ["dwt-8", "dwt-8-tpu", "dwt-8-pallas"])
def test_host_fe_modes_raise(one_file, fe):
    q = f"info_file={one_file}&fe={fe}&train_clf=logreg"
    with pytest.raises(ValueError, match="not yet ported"):
        PipelineBuilder(q, device="cpu").execute()


def test_cache_and_degrade_parse(one_file):
    q = f"info_file={one_file}&fe=dwt-8-fused&train_clf=logreg"
    want = str(PipelineBuilder(q, device="cpu").execute())
    got = str(PipelineBuilder(q + "&cache=false&degrade=false", device="cpu").execute())
    assert got == want


def test_missing_arguments_raise_reference_messages(one_file):
    with pytest.raises(ValueError, match="Missing the input file argument"):
        PipelineBuilder("fe=dwt-8-fused&train_clf=logreg", device="cpu").execute()
    with pytest.raises(ValueError, match="Missing the feature extraction argument"):
        PipelineBuilder(f"info_file={one_file}&train_clf=logreg", device="cpu").execute()
    with pytest.raises(ValueError, match="Missing classifier argument"):
        PipelineBuilder(f"info_file={one_file}&fe=dwt-8-fused", device="cpu").execute()
    with pytest.raises(ValueError, match="Unsupported classifier argument"):
        PipelineBuilder(f"info_file={one_file}&fe=dwt-8-fused&train_clf=knn",
                        device="cpu").execute()
