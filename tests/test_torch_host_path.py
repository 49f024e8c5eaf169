"""The port's host ``fe=`` path end to end against the JAX package.

Host epochs (``extract_epochs``, ``OfflineDataProvider.load``) must be
byte-equal to the JAX package's, on ``tests/_synthetic.py`` sessions
(one file and three files with one balance state across them) and on
an IEEE_FLOAT_32 session that this file writes itself. The builder's
statistics for ``fe=dwt-8``, ``-tpu``, ``-tpu-compact`` and ``-pallas``
with logreg and svm, trained or saved and loaded, must print the same
string as the JAX package's. No near-threshold allowance is used: on
these sessions no float32 backend puts a test margin within 1e-4 of the
threshold, so the strings are equal outright.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.epochs import extractor as jax_extractor
from eeg_dataanalysispackage_tpu.io import brainvision as jax_bv
from eeg_dataanalysispackage_tpu.io.provider import OfflineDataProvider as JaxProvider
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.epochs import extractor
from eeg_dataanalysispackage_tpu_torch.features import registry as fe_registry
from eeg_dataanalysispackage_tpu_torch.io import brainvision
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import linear
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, dwt_cuda, ingest_cuda
from eeg_dataanalysispackage_tpu_torch.pipeline import cli
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402
from _torch_sessions import write_coded_recording  # noqa: E402

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
        _synthetic.write_recording(d, name=f"rec_{i}", n_markers=n, guessed=guessed, seed=10 + i)
        lines.append(f"rec_{i}.eeg {guessed}")
    info = os.path.join(d, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(reversed(lines)) + "\n")
    return info


@pytest.fixture(scope="module")
def float_session(tmp_path_factory):
    """Two IEEE_FLOAT_32 recordings, one multiplexed and one vectorized."""
    d = str(tmp_path_factory.mktemp("float32"))
    lines = [
        write_coded_recording(d, "flt_0", "IEEE_FLOAT_32", 120, 4, seed=1),
        write_coded_recording(d, "flt_1", "IEEE_FLOAT_32", 90, 7, seed=2,
                              orientation="VECTORIZED"),
    ]
    info = os.path.join(d, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


def _triplet(info, name):
    base = os.path.join(os.path.dirname(info), name)
    return [open(base + ext, "rb").read() for ext in (".vhdr", ".vmrk", ".eeg")]


def _assert_batches_byte_equal(got, want):
    assert got.epochs.dtype == want.epochs.dtype == np.float64
    assert got.epochs.shape == want.epochs.shape
    assert got.epochs.tobytes() == want.epochs.tobytes()
    assert got.targets.tobytes() == want.targets.tobytes()
    np.testing.assert_array_equal(got.stimulus_indices, want.stimulus_indices)


@pytest.mark.parametrize("name,binary_format", [
    ("synth_01", "INT_16"), ("flt_0", "IEEE_FLOAT_32"), ("flt_1", "IEEE_FLOAT_32"),
])
def test_read_channels_byte_equal(request, one_file, float_session, name, binary_format):
    info = one_file if binary_format == "INT_16" else float_session
    ours = brainvision.load_recording_bytes(*_triplet(info, name))
    theirs = jax_bv.load_recording_bytes(*_triplet(info, name))
    assert ours.header.binary_format == binary_format
    got, want = ours.read_channels([2, 0, 1]), theirs.read_channels([2, 0, 1])
    assert got.dtype == np.float64 and got.tobytes() == want.tobytes()


def test_read_channels_int32_byte_equal(tmp_path):
    write_coded_recording(str(tmp_path), "i32", "INT_32", 20, 2, seed=5)
    trip = _triplet(str(tmp_path / "info.txt"), "i32")
    got = brainvision.load_recording_bytes(*trip).read_channels([0, 1, 2])
    want = jax_bv.load_recording_bytes(*trip).read_channels([0, 1, 2])
    assert got.tobytes() == want.tobytes()


def _markers(module, n, seed):
    """In-range, negative-start and past-the-end positions and a
    non-stimulus entry."""
    rng = np.random.RandomState(seed)
    out = [module.Marker(f"Mk{i + 1}", "Stimulus", f"S  {rng.randint(1, 10)}",
                         int(rng.randint(0, 20000))) for i in range(n)]
    out.append(module.Marker(f"Mk{n + 1}", "New Segment", "", 0))
    out.append(module.Marker(f"Mk{n + 2}", "Stimulus", "S  2", 19000 + 100))
    return out


def test_extract_epochs_byte_equal_across_files():
    """Three recordings with one balance state, as in a session; windows
    overhanging the end are zero-padded and those starting out of range
    skipped, in both packages."""
    ours, theirs = extractor.BalanceState(), jax_extractor.BalanceState()
    for seed in range(3):
        rng = np.random.RandomState(100 + seed)
        channels = (rng.randn(3, 19000).astype(np.float32) * 30 + 500).astype(np.float64)
        got = extractor.extract_epochs(channels, _markers(brainvision, 60, seed), 2,
                                       balance=ours)
        want = jax_extractor.extract_epochs(channels, _markers(jax_bv, 60, seed), 2,
                                            balance=theirs)
        _assert_batches_byte_equal(got, want)
        assert (ours.n_targets, ours.n_nontargets) == (theirs.n_targets, theirs.n_nontargets)


def test_gather_and_baseline_byte_equal():
    channels = np.random.RandomState(3).randn(3, 5000) * 100 + 2000
    positions = np.array([100, 2500, 4900, 5100, 50])
    got_w, got_v = extractor.gather_windows(channels, positions)
    want_w, want_v = jax_extractor.gather_windows(channels, positions)
    assert got_w.tobytes() == want_w.tobytes()
    np.testing.assert_array_equal(got_v, want_v)
    assert (extractor.baseline_correct_f32(got_w, 100).tobytes()
            == jax_extractor.baseline_correct_f32(want_w, 100).tobytes())


def test_empty_batch_concatenates():
    empty = extractor.EpochBatch.concatenate([])
    assert len(empty) == 0 and empty.epochs.shape == (0, 3, 750)


@pytest.mark.parametrize("session", ["one_file", "three_files", "float_session"])
def test_provider_load_byte_equal(request, session):
    info = request.getfixturevalue(session)
    odp = OfflineDataProvider([info], device="cpu")
    got = odp.load()
    want = JaxProvider([info]).load()
    assert len(got) >= 10
    _assert_batches_byte_equal(got, want)
    assert sorted(odp.timings) == ["epoch", "parse"]
    assert odp.batch is got
    assert odp.get_data_labels() == [float(t) for t in want.targets]
    data = odp.get_data()
    assert len(data) == len(want) and data[0].tobytes() == want.epochs[0].tobytes()


def test_provider_batch_loads_on_first_use(one_file):
    odp = OfflineDataProvider([one_file], device="cpu")
    _assert_batches_byte_equal(odp.batch, JaxProvider([one_file]).load())


def test_float_session_device_features_match_jax(float_session):
    """The float32 fallback: stage_raw stages scaled float32 samples with
    unit resolutions, and the fused features match the JAX package's
    within 1e-6 (the float64 baseline sum against its float32 one)."""
    odp = OfflineDataProvider([float_session], device="cpu")
    for _rel, _guessed, rec in odp.iter_recordings():
        raw, res, n = device_ingest.stage_raw(rec, odp.channel_indices_for(rec), "cpu")
        assert raw.dtype == torch.float32 and res.tolist() == [1.0, 1.0, 1.0]
        assert raw[:, :n].double().numpy().tobytes() == rec.read_channels(
            odp.channel_indices_for(rec)).tobytes()
    before = (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32)
    feats, targets = odp.load_features_device()
    assert (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32) == before  # CPU: plain version
    want, want_targets = JaxProvider([float_session]).load_features_device(backend="decode")
    np.testing.assert_array_equal(targets, want_targets)
    np.testing.assert_allclose(feats.numpy(), want, rtol=0, atol=1e-6)


FE_MODES = ["dwt-8", "dwt-8-tpu", "dwt-8-tpu-compact", "dwt-8-pallas"]


@pytest.mark.parametrize("clf", ["logreg", "svm"])
@pytest.mark.parametrize("fe", FE_MODES)
def test_train_statistics_equal_jax_package(three_files, tmp_path, fe, clf):
    q = f"info_file={three_files}&fe={fe}&train_clf={clf}"
    ours = PipelineBuilder(q + f"&result_path={tmp_path}/ours.txt", device="cpu")
    got = str(ours.execute())
    want = str(JaxBuilder(q + f"&result_path={tmp_path}/jax.txt").execute())
    assert got == want
    assert (tmp_path / "ours.txt").read_text() == (tmp_path / "jax.txt").read_text()
    assert sorted(ours.timers) == ["epoch", "featurize", "parse", "test", "train"]
    assert ours.features is None and len(ours.batch) == len(ours.targets)


@pytest.mark.parametrize("clf", ["logreg", "svm"])
@pytest.mark.parametrize("fe", FE_MODES)
def test_save_then_load_statistics_equal_jax_package(three_files, tmp_path, fe, clf):
    q = f"info_file={three_files}&fe={fe}"
    PipelineBuilder(f"{q}&train_clf={clf}&save_clf=true&save_name={tmp_path}/ours",
                    device="cpu").execute()
    JaxBuilder(f"{q}&train_clf={clf}&save_clf=true&save_name={tmp_path}/jax").execute()
    loaded = PipelineBuilder(f"{q}&load_clf={clf}&load_name={tmp_path}/ours", device="cpu")
    got = str(loaded.execute())
    want = str(JaxBuilder(f"{q}&load_clf={clf}&load_name={tmp_path}/jax").execute())
    assert got == want
    assert sorted(loaded.timers) == ["epoch", "featurize", "parse", "test"]
    assert loaded.classifier.fe is loaded.fe


@pytest.mark.parametrize("fe", ["dwt-8-fused", "dwt-8-pallas", "dwt-8"])
def test_float_session_statistics_equal_jax_package(float_session, fe):
    q = f"info_file={float_session}&fe={fe}&train_clf=logreg"
    assert str(PipelineBuilder(q, device="cpu").execute()) == str(JaxBuilder(q).execute())


def test_single_eeg_file_input_equals_jax_package(three_files):
    eeg = os.path.join(os.path.dirname(three_files), "rec_2.eeg")
    q = f"eeg_file={eeg}&guessed_num=2&fe=dwt-8&train_clf=svm"
    assert str(PipelineBuilder(q, device="cpu").execute()) == str(JaxBuilder(q).execute())


def test_pallas_path_runs_the_kernel_wrapper_twice_per_train_run(one_file, monkeypatch):
    """Train and test extraction each reach the kernel wrapper once; on
    CPU tensors it runs the plain version and counts no launch."""
    calls = []
    real = dwt_cuda.epoch_features_cuda

    def spy(epochs, *args):
        calls.append(tuple(epochs.shape))
        return real(epochs, *args)

    monkeypatch.setattr(dwt_cuda, "epoch_features_cuda", spy)
    before = dwt_cuda.LAUNCHES
    b = PipelineBuilder(f"info_file={one_file}&fe=dwt-8-pallas&train_clf=logreg", device="cpu")
    b.execute()
    n = len(b.batch)
    assert [c[0] for c in calls] == [n - len(b.test_index), len(b.test_index)]
    assert dwt_cuda.LAUNCHES == before


def test_serving_a_float_session_equals_its_batch_run(float_session, tmp_path):
    """serve=true on an IEEE_FLOAT_32 session (float32 requests through the
    megakernel's float32-sample plain version) prints the statistics of
    the port's batch load_clf= run and of the JAX package's serve=true
    run (tests/test_torch_serve_float.py holds the rest)."""
    q = f"info_file={float_session}&fe=dwt-8-fused"
    PipelineBuilder(f"{q}&train_clf=logreg&save_clf=true&save_name={tmp_path}/m",
                    device="cpu").execute()
    load = f"{q}&load_clf=logreg&load_name={tmp_path}/m"
    batch = PipelineBuilder(load, device="cpu").execute()
    served = PipelineBuilder(f"{load}&serve=true", device="cpu")
    assert str(served.execute()) == str(batch) == str(JaxBuilder(f"{load}&serve=true").execute())
    assert served.serve_block["rung"] == "mega"


def test_serving_with_a_host_fe_still_raises(one_file, tmp_path):
    q = f"info_file={one_file}&fe=dwt-8-fused&train_clf=logreg&save_clf=true"
    PipelineBuilder(f"{q}&save_name={tmp_path}/m", device="cpu").execute()
    with pytest.raises(ValueError, match="fe= must be a dwt-<i>-fused form"):
        PipelineBuilder(f"info_file={one_file}&fe=dwt-8&serve=true&load_clf=logreg"
                        f"&load_name={tmp_path}/m", device="cpu").execute()


def test_classifier_train_and_test_need_a_feature_extraction():
    clf = linear.LogisticRegressionClassifier()
    with pytest.raises(ValueError, match="feature extraction not set"):
        clf.test(np.zeros((2, 3, 750)), np.zeros(2))
    fe = fe_registry.create("dwt-8-tpu", device="cpu")
    ep = np.random.RandomState(0).randn(20, 3, 750)
    clf.train(ep, np.arange(20) % 2, fe)
    assert clf.fe is fe and clf.model.weight.dtype == torch.float32
    assert sorted(clf.timings) == ["featurize", "fit"]
    assert clf.test(ep[0], np.zeros(1)).calc_accuracy() in (0.0, 1.0)  # one epoch


def test_unknown_fe_raises_before_loading(one_file):
    with pytest.raises(ValueError, match="^Unsupported feature extraction argument$"):
        PipelineBuilder(f"info_file={one_file}&fe=fft&train_clf=logreg", device="cpu").execute()
    with pytest.raises(ValueError, match="Missing classifier argument"):
        PipelineBuilder(f"info_file={one_file}&fe=dwt-8", device="cpu").execute()


def test_no_silent_cpu_for_the_host_path(one_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    q = f"info_file={one_file}&fe=dwt-8-pallas&train_clf=logreg"
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineBuilder(q)
    with pytest.raises(RuntimeError, match="CUDA"):
        fe_registry.create("dwt-8")
    assert cli.main([q]) == 1
