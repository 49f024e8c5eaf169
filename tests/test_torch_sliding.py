"""The port's sliding-window epocher against the JAX package's.

Twins of ``tests/test_sliding_epochs.py``: interval pairing (on/off
pairs, a dangling onset, an orphan offset, unordered markers, none),
the window geometry, the overlap labels, the configuration errors, and
``extract_sliding_epochs`` / ``OfflineDataProvider.load_sliding`` /
``sliding_batch_for`` on the same inputs: windows, targets and start
samples byte-equal to the JAX package's (the JAX package's seizure
fixture size, ``write_seizure_session(n_files=2, n_samples=40000)``).
"""

import os
import sys

import numpy as np
import pytest

from eeg_dataanalysispackage_tpu.epochs import sliding as jax_sliding
from eeg_dataanalysispackage_tpu.io import brainvision as jax_brainvision
from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu_torch.epochs import sliding
from eeg_dataanalysispackage_tpu_torch.io import brainvision
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    return _synthetic.write_seizure_session(
        str(tmp_path_factory.mktemp("torch_sliding")), n_files=2, n_samples=40000)


def _markers(spec):
    """Both packages' Marker lists for ``(kind, description, position)``."""
    return ([brainvision.Marker("MkX", k, s, p) for k, s, p in spec],
            [jax_brainvision.Marker(name="MkX", kind=k, stimulus=s, position=p)
             for k, s, p in spec])


def _same_batch(ours, theirs):
    for field in ("epochs", "targets", "stimulus_indices"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


MARKER_CASES = {
    "pairs": [("Seizure", "on", 100), ("Seizure", "off", 200), ("Stimulus", "S  3", 150),
              ("Seizure", "on", 500), ("Seizure", "off", 650)],
    "dangling_on_orphan_off": [("Seizure", "off", 50), ("Seizure", "on", 700)],
    "unordered": [("Seizure", "off", 300), ("Seizure", "on", 100)],
    "none": [("Stimulus", "S 1", 10)],
    "case_and_space": [("Seizure", " ON ", 40), ("Seizure", "Off", 90),
                       ("Seizure", "on", 120), ("Seizure", "on", 130),
                       ("Seizure", "off", 125), ("Seizure", "off", 400)],
    "clamped": [("Seizure", "on", -20), ("Seizure", "off", 5000)],
}


@pytest.mark.parametrize("case", sorted(MARKER_CASES))
def test_seizure_intervals_equal_jax(case):
    ours, theirs = _markers(MARKER_CASES[case])
    got = sliding.seizure_intervals(ours, 1000)
    assert got == jax_sliding.seizure_intervals(theirs, 1000)
    if case == "dangling_on_orphan_off":
        assert got == [(700, 1000)]


@pytest.mark.parametrize("n,window,stride", [(1000, 512, 256), (300, 512, 256),
                                             (512, 512, 256), (40000, 768, 384),
                                             (2049, 7, 3)])
def test_window_starts_equal_jax(n, window, stride):
    got = sliding.window_starts(n, window, stride)
    want = jax_sliding.window_starts(n, window, stride)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()


def test_overlap_fractions_equal_jax():
    starts = np.arange(0, 3000, 97)
    intervals = [(150, 250), (400, 1200), (2900, 3100)]
    for window in (100, 256, 512):
        got = sliding.overlap_fractions(starts, window, intervals)
        want = jax_sliding.overlap_fractions(starts, window, intervals)
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kwargs", [{"window": 0}, {"stride": 0}, {"label_overlap": 0.0},
                                    {"label_overlap": 1.5}],
                         ids=lambda k: "&".join(f"{a}={b}" for a, b in k.items()))
def test_config_errors_carry_the_jax_text(kwargs):
    with pytest.raises(ValueError) as ours:
        sliding.SlidingConfig(**kwargs)
    with pytest.raises(ValueError) as theirs:
        jax_sliding.SlidingConfig(**kwargs)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("window,stride,overlap", [(512, 256, 0.5), (512, 512, 0.25),
                                                   (300, 77, 1.0)])
def test_extract_sliding_epochs_byte_equal(window, stride, overlap):
    channels = np.random.RandomState(0).randn(3, 5000) * 40.0
    ours, theirs = _markers([("Seizure", "on", 900), ("Seizure", "off", 2100),
                             ("Seizure", "on", 4500)])
    got = sliding.extract_sliding_epochs(channels, ours,
                                         sliding.SlidingConfig(window, stride, overlap))
    want = jax_sliding.extract_sliding_epochs(channels, theirs,
                                              jax_sliding.SlidingConfig(window, stride, overlap))
    _same_batch(got, want)
    assert 0 < got.targets.sum() < len(got)
    for i, start in enumerate(got.stimulus_indices):
        assert np.array_equal(got.epochs[i], channels[:, start:start + window])


def test_short_recording_yields_an_empty_batch():
    cfg = sliding.SlidingConfig(window=512)
    got = sliding.extract_sliding_epochs(np.zeros((3, 100)), [], cfg)
    want = jax_sliding.extract_sliding_epochs(np.zeros((3, 100)), [],
                                              jax_sliding.SlidingConfig(window=512))
    assert len(got) == 0 and got.epochs.shape == (0, 3, 512)
    _same_batch(got, want)


@pytest.mark.parametrize("window,stride,overlap", [(512, 256, 0.5), (768, 384, 0.5),
                                                   (512, 128, 0.25)])
def test_load_sliding_byte_equal(info, window, stride, overlap):
    got = OfflineDataProvider([info], device="cpu").load_sliding(
        sliding.SlidingConfig(window, stride, overlap))
    want = jax_provider.OfflineDataProvider([info]).load_sliding(
        jax_sliding.SlidingConfig(window, stride, overlap))
    _same_batch(got, want)
    assert 0.0 < got.targets.mean() < 0.35  # a genuinely imbalanced set


def test_sliding_batch_for_each_recording_equals_jax(info):
    cfg = sliding.SlidingConfig(512, 256)
    odp = OfflineDataProvider([info], device="cpu")
    jax_odp = jax_provider.OfflineDataProvider([info])
    ours = [odp.sliding_batch_for(rec, cfg) for _, _, rec in odp.iter_recordings()]
    theirs = [jax_odp.sliding_batch_for(rec, jax_sliding.SlidingConfig(512, 256))
              for _, _, rec in jax_odp.iter_recordings()]
    assert len(ours) == len(theirs) == 2
    for a, b in zip(ours, theirs):
        _same_batch(a, b)
    assert set(odp.load_sliding(cfg).stimulus_indices) == set(ours[0].stimulus_indices)
    assert {"parse", "epoch"} <= set(odp.timings)


def test_generator_intervals_match_annotations(tmp_path):
    eeg = _synthetic.write_continuous_recording(str(tmp_path), n_samples=20000,
                                                seizure_intervals=((4000, 6000),))
    rec = brainvision.load_recording(eeg)
    assert sliding.seizure_intervals(rec.markers, rec.num_samples) == [(4000, 6000)]
