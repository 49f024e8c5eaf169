"""The port's subband wavelet features and ``fe=`` grammar against the JAX
package's.

Twins of ``tests/test_subband_features.py``: ``dwt_host.fwt_subbands``
and the P300 transform ``fwt_periodic`` bit-equal to the JAX package's;
``SubbandWaveletFeatures`` rows byte-equal to the JAX package's on the
same sliding windows (families 4 and 8, levels 2 and 4, each stat set;
the JAX package's seizure fixture,
``write_seizure_session(n_files=2, n_samples=40000)``); the grammar's
errors, the too-deep refusal and ``cache_id`` equal to the JAX package's;
plain names resolving as before.
"""

import os
import sys

import numpy as np
import pytest

from eeg_dataanalysispackage_tpu.epochs import sliding as jax_sliding
from eeg_dataanalysispackage_tpu.features import registry as jax_registry
from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.ops import dwt_host as jax_dwt_host
from eeg_dataanalysispackage_tpu_torch.features import registry, subband, wavelet
from eeg_dataanalysispackage_tpu_torch.ops import dwt_host, eegdsp_compat

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    """The session's 512-sample sliding windows (the JAX package's
    epocher: tests/test_torch_sliding.py holds the port's equal)."""
    info = _synthetic.write_seizure_session(
        str(tmp_path_factory.mktemp("torch_subband")), n_files=2, n_samples=40000)
    return jax_provider.OfflineDataProvider([info]).load_sliding(
        jax_sliding.SlidingConfig(512, 256)).epochs


def _create(name):
    return registry.create(name, device="cpu")


@pytest.mark.parametrize("family", [0, 4, 8, 6])
@pytest.mark.parametrize("n", [512, 750, 333])
def test_cascade_equals_jax(family, n):
    """``fwt_subbands`` at every depth bound and the full transform the
    P300 ``fe=dwt-<i>`` path computes, bit for bit."""
    x = np.random.RandomState(n).randn(4, 3, n) * 50.0
    h, g = eegdsp_compat.filter_pair(family)
    for levels in (None, 1, 2, 4):
        a, d = dwt_host.fwt_subbands(x, h, g, max_levels=levels)
        ja, jd = jax_dwt_host.fwt_subbands(x, h, g, max_levels=levels)
        assert a.tobytes() == ja.tobytes() and len(d) == len(jd)
        assert all(p.tobytes() == q.tobytes() for p, q in zip(d, jd))
    assert dwt_host.fwt_periodic(x, h, g).tobytes() == jax_dwt_host.fwt_periodic(x, h, g).tobytes()
    assert (dwt_host.dwt_coefficients(x, family).tobytes()
            == jax_dwt_host.dwt_coefficients(x, family).tobytes())


STAT_SETS = ["energy", "mean", "std", "energy,std", "energy,mean,std", "std,energy"]


@pytest.mark.parametrize("stats", STAT_SETS)
@pytest.mark.parametrize("level", [2, 4])
@pytest.mark.parametrize("family", [4, 8])
def test_rows_byte_equal_to_jax(windows, family, level, stats):
    name = f"dwt-{family}:level={level}:stats={stats}"
    ours, theirs = _create(name), jax_registry.create(name)
    assert isinstance(ours, subband.SubbandWaveletFeatures)
    got, want = ours.extract_batch(windows), theirs.extract_batch(windows)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == want.shape == (len(windows), ours.feature_dimension)
    assert got.tobytes() == np.asarray(want).tobytes()
    assert ours.cache_id() == theirs.cache_id()
    assert ours.feature_dimension == theirs.feature_dimension
    assert repr(ours) == repr(theirs)


def test_channel_selection_and_single_epoch(windows):
    ours = subband.SubbandWaveletFeatures(4, 3, ("energy", "mean"), channels=(3, 1), device="cpu")
    theirs = jax_registry.create("dwt-4:level=3:stats=energy,mean")
    theirs.channels = (3, 1)
    assert ours.extract_batch(windows[:7]).tobytes() == theirs.extract_batch(windows[:7]).tobytes()
    assert ours.extract_features(windows[0]).shape == (ours.feature_dimension,)


@pytest.mark.parametrize("name", [
    "dwt-4:level=x", "dwt-4:depth=3", "dwt-4:level=", "dwt-4:level", "dwt-4-tpu:level=3",
    "dwt-4:stats=zap", "dwt-4:stats=energy,energy", "dwt-99:level=2", "dwt-4:level=0",
    "dwt-4:stats=,", "fft:level=2",
])
def test_grammar_errors_carry_the_jax_text(name):
    with pytest.raises(ValueError) as theirs:
        jax_registry.create(name)
    with pytest.raises(ValueError) as ours:
        _create(name)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("family,level,n", [(8, 9, 512), (4, 7, 64), (8, 5, 80)])
def test_too_deep_level_raises_the_jax_text(family, level, n):
    x = np.zeros((1, 3, n))
    with pytest.raises(ValueError, match="supports only") as ours:
        subband.SubbandWaveletFeatures(family, level, device="cpu").extract_batch(x)
    with pytest.raises(ValueError) as theirs:
        jax_registry.create(f"dwt-{family}:level={level}").extract_batch(x)
    assert str(ours.value) == str(theirs.value)


def test_defaults_and_cache_ids_are_config_complete():
    assert _create("dwt-8:level=3").stats == ("energy",)
    names = ["dwt-4:level=4:stats=energy", "dwt-4:level=4:stats=energy,std",
             "dwt-4:level=3:stats=energy", "dwt-8:level=4:stats=energy"]
    ids = [_create(n).cache_id() for n in names]
    assert ids == [jax_registry.create(n).cache_id() for n in names]
    assert len(set(ids)) == 4 and _create("dwt-8").cache_id() not in ids
    assert _create(names[0]) == _create(names[0]) and _create(names[0]) != _create(names[1])


@pytest.mark.parametrize("name", ["dwt-8", "dwt-4", "dwt-8-tpu", "dwt-8-pallas",
                                  "dwt-8-tpu-compact"])
def test_plain_names_resolve_as_before(name):
    ours, theirs = _create(name), jax_registry.create(name)
    assert isinstance(ours, wavelet.WaveletTransform)
    assert (ours.name, ours.epoch_size, ours.skip_samples, ours.feature_size, ours.backend) == (
        theirs.name, theirs.epoch_size, theirs.skip_samples, theirs.feature_size, theirs.backend)
    assert ours.cache_id() == theirs.cache_id()


def test_constant_signal_puts_the_energy_in_the_approximation():
    out = subband.SubbandWaveletFeatures(8, 2, channels=(1,), device="cpu").extract_batch(
        np.ones((1, 1, 64)))[0]
    assert out[0] == pytest.approx(1.0, abs=1e-10)
    assert abs(out[1]) < 1e-10 and abs(out[2]) < 1e-10
