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
    ["classifiers=logreg,svm",
     # precision=bf16 runs on the fused path (tests/test_torch_precision.py);
     # the host path's bf16 spelling does not
     pytest.param("fe=dwt-8-tpu-bf16", id="precision=bf16"),
     # overlap= runs (tests/test_torch_overlap.py), on a batch run and,
     # ignored there as in the JAX package, on a serve run
     "overlap=true",
     # devices= runs (tests/test_torch_sharded_population.py); the
     # multi-process keys are still refused
     "devices=2", "processes=2",
     # serve=true itself runs (tests/test_torch_serve.py), and so do its
     # adapt= (tests/test_torch_lifecycle.py) and report=
     # (tests/test_torch_report.py)
     pytest.param("serve=true&overlap=true", id="serve=true"),
     "task=seizure", "cv=3", "elastic=true"],
)
def test_unported_keys_raise(one_file, extra, tmp_path):
    if extra == "fe=dwt-8-tpu-bf16":
        _bf16_spelling_runs_like_the_jax_package(one_file, "dwt-8-tpu-bf16")
        return
    if extra in _TRAINING_SURFACE:
        _training_surface_runs_like_the_jax_package(one_file, extra, tmp_path)
        return
    if "overlap=" in extra:
        _overlap_runs_like_the_jax_package(one_file, extra, tmp_path)
        return
    if extra == "devices=2":
        _mesh_runs_like_the_jax_package(one_file, extra)
        return
    q = f"info_file={one_file}&fe=dwt-8-fused&load_clf=logreg&load_name=unused&{extra}"
    if extra == "task=seizure":
        # ported (tests/test_torch_seizure.py): a -fused fe= raises the JAX
        # package's refusal
        with pytest.raises(ValueError) as theirs:
            JaxBuilder(q).execute()
        with pytest.raises(ValueError) as ours:
            PipelineBuilder(q, device="cpu").execute()
        assert str(ours.value) == str(theirs.value) and "-fused" in str(ours.value)
        return
    with pytest.raises(ValueError, match="not yet ported"):
        PipelineBuilder(q, device="cpu").execute()


#: keys refused until the fan-out, population and elastic slice ported them:
#: each case's train run, and its load_clf= conflict where the JAX package
#: has one
_TRAINING_SURFACE = {
    "classifiers=logreg,svm": "classifiers=logreg,svm",
    "cv=3": "train_clf=logreg&cv=3",
    "elastic=true": "train_clf=logreg&elastic=true&checkpoint_path={ck}",
}


def _training_surface_runs_like_the_jax_package(info, extra, tmp_path):
    """The run prints the JAX package's statistics; combined with
    load_clf= it raises the JAX package's message (elastic=true is ignored
    by a load run in both packages)."""
    from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan

    q = f"info_file={info}&fe=dwt-8-fused&" + _TRAINING_SURFACE[extra]
    ours = PipelineBuilder(q.format(ck=tmp_path / "port"), device="cpu").execute()
    assert str(ours) == str(JaxBuilder(q.format(ck=tmp_path / "jax")).execute())
    load = f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name=unused&{extra}"
    if extra == "elastic=true":
        ExecutionPlan.parse(load)  # no conflict in either package
        with pytest.raises(FileNotFoundError):
            PipelineBuilder(load, device="cpu").execute()
        return
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(load)
    with pytest.raises(ValueError) as got:
        PipelineBuilder(load, device="cpu").execute()
    assert str(got.value) == str(theirs.value)


def _mesh_runs_like_the_jax_package(info, extra):
    """devices=, refused until the single-process mesh slice ported it,
    now runs on two logical CPU shards (the fused ingest split over them):
    the statistics are the JAX package's unmeshed run's."""
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"
    ours = PipelineBuilder(f"{q}&{extra}", device="cpu")
    assert str(ours.execute()) == str(JaxBuilder(q).execute())
    assert ours.mesh_resolved["rung"] == "mesh" and ours.mesh_resolved["shape"] == {"data": 2}


def _overlap_runs_like_the_jax_package(info, extra, tmp_path):
    """overlap=, refused until the input pipeline's slice ported it, now
    runs: a load_clf= run carrying it (batch, or serve=true, which ignores
    it in both packages) prints the JAX package's statistics."""
    model = tmp_path / "model"
    JaxBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&save_clf=true"
               f"&save_name={model}").execute()
    q = f"info_file={info}&fe=dwt-8-fused&load_clf=logreg&load_name={model}&{extra}"
    ours = PipelineBuilder(q, device="cpu")
    assert str(ours.execute()) == str(JaxBuilder(q).execute())
    assert ours.overlap_resolved is (None if "serve=true" in extra else True)


def _bf16_spelling_runs_like_the_jax_package(info, fe):
    """A host bf16 spelling, refused until it was ported, now runs: the
    run's statistics equal the JAX package's."""
    q = f"info_file={info}&fe={fe}&train_clf=logreg"
    ours = PipelineBuilder(q, device="cpu")
    assert str(ours.execute()) == str(JaxBuilder(q + "&cache=false").execute())
    assert ours.fe.backend.endswith("-bf16")


# the host fe= modes run (tests/test_torch_host_path.py), their bf16
# spellings too, and the subband grammar (refused here until it was
# ported; the name is kept)
@pytest.mark.parametrize("fe", ["dwt-8-tpu-bf16", "dwt-8-tpu-compact-bf16", "dwt-8:level=4"])
def test_host_fe_modes_raise(one_file, fe):
    if "bf16" in fe:
        _bf16_spelling_runs_like_the_jax_package(one_file, fe)
        return
    q = f"info_file={one_file}&fe={fe}&train_clf=logreg"
    ours = PipelineBuilder(q, device="cpu")
    assert str(ours.execute()) == str(JaxBuilder(q + "&cache=false").execute())
    assert type(ours.fe).__name__ == "SubbandWaveletFeatures"


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
