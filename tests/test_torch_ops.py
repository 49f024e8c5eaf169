"""Port operators against the JAX package: the cascade and ingest
matrices byte for byte, the ingest planner exactly, and the torch
``epoch_features`` / ``safe_l2_normalize`` at float32 tolerance."""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.epochs import extractor as jax_extractor
from eeg_dataanalysispackage_tpu.io import brainvision as jax_bv
from eeg_dataanalysispackage_tpu.ops import device_ingest as jax_ingest
from eeg_dataanalysispackage_tpu.ops import dwt as jax_dwt
from eeg_dataanalysispackage_tpu.utils import java_compat as jax_java
from eeg_dataanalysispackage_tpu_torch.epochs import extractor
from eeg_dataanalysispackage_tpu_torch.io import brainvision
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, dwt
from eeg_dataanalysispackage_tpu_torch.utils import java_compat


@pytest.mark.parametrize("wavelet_index,n,count", [(8, 512, 16), (2, 512, 16), (8, 256, 8)])
def test_cascade_matrix_byte_equal(wavelet_index, n, count):
    got = dwt.cascade_matrix(wavelet_index, n, count)
    want = jax_dwt.cascade_matrix(wavelet_index, n, count)
    assert got.dtype == want.dtype == np.float64
    assert got.tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize(
    "kwargs",
    [{}, {"fold_baseline": False}, {"window_len": 800, "fold_baseline": False},
     {"wavelet_index": 4, "skip_samples": 150}],
)
def test_ingest_matrix_byte_equal(kwargs):
    got = device_ingest.ingest_matrix(**kwargs)
    want = jax_ingest.ingest_matrix(**kwargs)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


def _markers(module, n, seed):
    """Markers with in-range, negative-start and past-the-end positions
    and a non-stimulus entry."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        pos = int(rng.randint(0, 20000))
        out.append(module.Marker(f"Mk{i + 1}", "Stimulus", f"S  {rng.randint(1, 10)}", pos))
    out.append(module.Marker(f"Mk{n + 1}", "New Segment", "", 0))
    out.append(module.Marker(f"Mk{n + 2}", "Stimulus", "S  2", 19100))  # start == n_samples
    return out


def test_plan_ingest_matches_jax_across_files():
    """Positions, mask, targets and stimulus indices equal, with one
    balance state carried over three recordings as in a session."""
    ours, theirs = extractor.BalanceState(), jax_extractor.BalanceState()
    for seed in range(3):
        a = device_ingest.plan_ingest(
            _markers(brainvision, 150, seed), 2, 19000, balance=ours
        )
        b = jax_ingest.plan_ingest(
            _markers(jax_bv, 150, seed), 2, 19000, balance=theirs
        )
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_array_equal(a.mask, b.mask)
        np.testing.assert_array_equal(a.targets, b.targets)
        np.testing.assert_array_equal(a.stimulus_indices, b.stimulus_indices)
        assert (ours.n_targets, ours.n_nontargets) == (theirs.n_targets, theirs.n_nontargets)


def test_valid_window_starts_matches_jax():
    pos = np.array([0, 99, 100, 5000, 19100, 19101, -5])
    np.testing.assert_array_equal(
        extractor.valid_window_starts(pos, 100, 19000),
        jax_extractor.valid_window_starts(pos, 100, 19000),
    )


def test_java_shuffle_split_matches_jax():
    for n in (0, 1, 11, 97, 2000):
        assert java_compat.train_test_split_indices(n) == jax_java.train_test_split_indices(n)


def test_epoch_features_matches_jax():
    rng = np.random.RandomState(5)
    epochs = (rng.randn(7, 3, 750) * 40 + rng.randn(7, 3, 1) * 300).astype(np.float32)
    got = dwt.epoch_features(torch.from_numpy(epochs)).numpy()
    want = np.asarray(jax_dwt.epoch_features(epochs))
    assert got.shape == want.shape == (7, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_safe_l2_normalize_keeps_zero_rows_zero():
    x = torch.tensor([[0.0, 0.0, 0.0], [3.0, 0.0, 4.0]])
    out = dwt.safe_l2_normalize(x)
    assert torch.isfinite(out).all()
    assert out[0].abs().max() == 0
    np.testing.assert_allclose(out[1].numpy(), [0.6, 0.0, 0.8], rtol=1e-7)
