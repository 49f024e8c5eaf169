"""The port's streaming front end (``parallel/streaming.py``,
``ops/signal.py``) against the JAX package's.

Twins of ``tests/test_parallel.py``'s streaming cases and of BASELINE
config 5 (``tests/test_baseline_configs.py``): the time-sharded extractor
on eight logical CPU shards equals one shard and the JAX package's mesh
extractor, a window straddling a shard boundary reads the next shard's
head, the block layout and stride errors carry the JAX messages, int16
staging equals pre-scaled float32, the windowed contraction equals a
numpy oracle, and the bounded-memory blocked iterator is block-size
invariant and equals the JAX package's. The band-passed cascade matrix is
the JAX package's, bit for bit (the same float64 numpy steps).
Tolerances are the JAX tests' own: 2e-5 for float32 contractions, 2e-4
against the float64 host cascade, 1e-6 between block sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import registry as jax_registry
from eeg_dataanalysispackage_tpu.ops import signal as jax_signal
from eeg_dataanalysispackage_tpu.parallel import mesh as jax_mesh
from eeg_dataanalysispackage_tpu.parallel import streaming as jax_streaming
from eeg_dataanalysispackage_tpu_torch.models import registry
from eeg_dataanalysispackage_tpu_torch.ops import dwt_host, signal
from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh, sharded_ingest, streaming

F32_TOL = 2e-5


def _tmesh(n):
    return pmesh.make_mesh(n, axes=(pmesh.TIME_AXIS,), device="cpu")


def _jax_tmesh(n):
    return jax_mesh.make_mesh(n, axes=(jax_mesh.TIME_AXIS,))


def _jax_extract(sig, n, **kw):
    mesh = _jax_tmesh(n)
    return np.asarray(jax_streaming.make_streaming_extractor(mesh, **kw)(
        jax_streaming.stage_recording(sig, mesh)))


# -- ops/signal -------------------------------------------------------------


@pytest.mark.parametrize("n,fs,band", [(512, 1000.0, (0.5, 40.0)), (750, 250.0, (1.0, 30.0)),
                                       (64, 100.0, (0.0, 50.0))])
def test_bandpass_mask_is_the_jax_packages(n, fs, band):
    np.testing.assert_array_equal(signal.bandpass_mask(n, fs, *band),
                                  jax_signal.bandpass_mask(n, fs, *band))


def test_decimate_normalize_and_fft_bandpass_match_the_jax_package():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 1000)
    np.testing.assert_array_equal(signal.decimate(x, 3), jax_signal.decimate(x, 3))
    with pytest.raises(ValueError, match=">= 1"):
        signal.decimate(x, 0)
    feats = rng.randn(5, 48)
    np.testing.assert_array_equal(signal.normalize(feats), jax_signal.normalize(feats))
    x32 = x.astype(np.float32)
    got = signal.fft_bandpass(x32, 1000.0, 0.5, 40.0)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(jax_signal.fft_bandpass(x32, 1000.0, 0.5, 40.0)),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("window,band", [(512, (0.5, 40.0)), (256, (0.0, 500.0))])
def test_filtered_cascade_kernel_is_the_jax_packages(window, band):
    np.testing.assert_array_equal(
        streaming.filtered_cascade_kernel(window, 8, 16, 1000.0, band),
        jax_streaming.filtered_cascade_kernel(window, 8, 16, 1000.0, band))


# -- the sharded extractor ----------------------------------------------------


def test_streaming_extractor_matches_one_shard_and_the_jax_package():
    C, T = 3, 8 * 1024
    sig = np.random.RandomState(2).randn(C, T).astype(np.float32)
    feats = streaming.make_streaming_extractor(_tmesh(8), window=512, stride=256)(
        streaming.stage_recording(sig, _tmesh(8)))
    assert feats.shape == (T // 256, 3 * 16)
    one = streaming.make_streaming_extractor(_tmesh(1), window=512, stride=256)(sig)
    np.testing.assert_allclose(feats.numpy(), one.numpy(), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(feats.numpy(), _jax_extract(sig, 8, window=512, stride=256),
                               rtol=0, atol=F32_TOL)


def test_streaming_halo_windows_cross_shard_boundaries():
    """A window starting near the end of shard 0 reads shard 1's head:
    held against the float64 host cascade (a 0-500 Hz band keeps every
    bin, so the band-pass is the identity up to float32)."""
    C, T = 2, 8 * 512
    sig = np.random.RandomState(3).randn(C, T).astype(np.float32)
    feats = streaming.make_streaming_extractor(_tmesh(8), window=512, stride=256,
                                               band=(0.0, 500.0))(sig).numpy()
    win = sig[:, 256: 256 + 512].astype(np.float64)
    coeffs = dwt_host.dwt_coefficients(win, 8, 16).reshape(-1)
    np.testing.assert_allclose(feats[1], coeffs / np.sqrt((coeffs ** 2).sum()), rtol=0,
                               atol=2e-4)
    # the last window of every shard reads its right neighbour's head;
    # the last shard's wraps to the first (periodic over the ring)
    full = np.concatenate([sig, sig[:, :256]], axis=1)
    for row in (1, 3, 15):
        start = row * 256
        win = full[:, start: start + 512].astype(np.float64)
        c = dwt_host.dwt_coefficients(win, 8, 16).reshape(-1)
        np.testing.assert_allclose(feats[row], c / np.sqrt((c ** 2).sum()), rtol=0, atol=2e-4)


def test_streaming_rejects_bad_block_layout_with_the_jax_messages():
    tmesh = _tmesh(8)
    extract = streaming.make_streaming_extractor(tmesh, window=512, stride=256)
    jextract = jax_streaming.make_streaming_extractor(_jax_tmesh(8), window=512, stride=256)
    sig = np.random.RandomState(0).randn(2, 8 * 600).astype(np.float32)
    with pytest.raises(ValueError, match="not a multiple of") as ours:
        extract(streaming.stage_recording(sig, tmesh))
    with pytest.raises(ValueError) as theirs:
        jextract(jnp.asarray(sig))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="not divisible by") as ours:
        extract(sig[:, : 8 * 600 - 3])
    with pytest.raises(ValueError) as theirs:
        jextract(jnp.asarray(sig[:, : 8 * 600 - 3]))
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match="halo"):
        streaming.make_streaming_extractor(tmesh, window=2048, stride=256)(
            np.zeros((1, 8 * 1024), np.float32))


def test_streaming_rejects_bad_stride_with_the_jax_message():
    with pytest.raises(ValueError, match="stride") as ours:
        streaming.make_streaming_extractor(_tmesh(1), window=256, stride=512)
    with pytest.raises(ValueError) as theirs:
        jax_streaming.make_streaming_extractor(_jax_tmesh(1), window=256, stride=512)
    assert str(ours.value) == str(theirs.value)


def test_streaming_extractor_int16_staging_matches_f32():
    rng = np.random.RandomState(2)
    raw = (rng.randn(3, 4096) * 500).astype(np.int16)
    res = np.array([0.1, 0.1, 0.2], np.float32)
    tmesh = _tmesh(8)
    staged = streaming.stage_recording(raw, tmesh, dtype=torch.int16)
    assert all(s.dtype == torch.int16 for s in staged.shards)
    f16 = streaming.make_streaming_extractor(tmesh, resolutions=res)(staged)
    scaled = raw.astype(np.float32) * res[:, None]
    ff = streaming.make_streaming_extractor(tmesh)(streaming.stage_recording(scaled, tmesh))
    np.testing.assert_allclose(f16.numpy(), ff.numpy(), rtol=0, atol=F32_TOL)
    # the sharded ingest's int16 staging is this staging
    via_ingest = sharded_ingest.stage_recording_int16(raw, tmesh)
    assert all(torch.equal(a, b) for a, b in zip(via_ingest.shards, staged.shards))
    local = sharded_ingest.stage_recording_local_int16(raw, tmesh)
    assert all(torch.equal(a, b) for a, b in zip(local.shards, staged.shards))


def test_windowed_pipeline_matches_a_numpy_oracle():
    rng = np.random.RandomState(0)
    window, stride = 512, 256
    kernel = streaming.filtered_cascade_kernel(window, 8, 16, 1000.0, (0.5, 40.0)).astype(
        np.float32)
    ext = rng.randn(3, 2048 + window - stride).astype(np.float32) * 40
    got = streaming._windowed_pipeline(torch.from_numpy(ext), window, stride,
                                       torch.from_numpy(kernel)).numpy()
    starts = np.arange(0, 2048, stride)
    idx = starts[:, None] + np.arange(window)[None, :]
    flat = ext[:, idx].transpose(1, 0, 2).reshape(len(starts) * 3, window)
    want = (flat @ kernel).reshape(len(starts), 3 * 16)
    want /= np.maximum(np.linalg.norm(want, axis=1, keepdims=True), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    jgot = np.asarray(jax_streaming._windowed_pipeline(jnp.asarray(ext), window, stride,
                                                       jnp.asarray(kernel)))
    np.testing.assert_allclose(got, jgot, rtol=0, atol=F32_TOL)


# -- the blocked iterator ----------------------------------------------------------


def _signal(C=3, T=4096 + 128, seed=11):
    return np.random.RandomState(seed).randn(C, T).astype(np.float32) * 25.0


def test_blocked_features_are_block_size_invariant_and_the_jax_packages():
    sig = _signal()
    whole = streaming.blocked_features(sig, block=8192, device="cpu")
    assert whole.shape == ((sig.shape[1] - 512) // 256 + 1, 48)
    for block in (1024, 256):
        np.testing.assert_allclose(streaming.blocked_features(sig, block=block, device="cpu"),
                                   whole, rtol=0, atol=1e-6)
    np.testing.assert_allclose(whole, jax_streaming.blocked_features(sig, block=8192),
                               rtol=0, atol=F32_TOL)


def test_first_blocked_window_matches_direct_math():
    sig = _signal(C=2)
    got = streaming.blocked_features(sig, block=1024, device="cpu")[0]
    mask = signal.bandpass_mask(512, 1000.0, 0.5, 40.0)
    filt = np.fft.irfft(np.fft.rfft(sig[:, :512].astype(np.float64), axis=-1) * mask, n=512,
                        axis=-1)
    coeffs = dwt_host.dwt_coefficients(filt, 8, 16).reshape(-1)
    np.testing.assert_allclose(got, coeffs / np.linalg.norm(coeffs), rtol=0, atol=F32_TOL)


def test_blocked_short_and_invalid_inputs():
    assert streaming.blocked_features(np.zeros((2, 100), np.float32),
                                      device="cpu").shape == (0, 32)
    with pytest.raises(ValueError, match="multiple of stride"):
        list(streaming.iter_blocked_features(np.zeros((1, 2048), np.float32), block=1000,
                                             device="cpu"))


def test_blocked_int16_source_ships_raw_and_scales_on_the_device():
    rng = np.random.RandomState(2)
    raw = rng.randint(-3000, 3000, size=(3, 2048 + 64)).astype(np.int16)
    res = np.array([0.1, 0.5, 1.0], dtype=np.float32)
    got = streaming.blocked_features(raw, block=1024, resolutions=res, device="cpu")
    want = streaming.blocked_features(raw.astype(np.float32) * res[:, None], block=1024,
                                      device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    np.testing.assert_allclose(
        got, jax_streaming.blocked_features(raw, block=1024, resolutions=res), rtol=0,
        atol=F32_TOL)


# -- BASELINE config 5 ------------------------------------------------------------

_NN_CONFIG = {
    "config_seed": "1", "config_num_iterations": "30", "config_learning_rate": "0.05",
    "config_momentum": "0.9", "config_weight_init": "xavier", "config_updater": "nesterovs",
    "config_optimization_algo": "sgd", "config_pretrain": "false", "config_backprop": "true",
    "config_layer1_layer_type": "dense", "config_layer1_n_out": "32",
    "config_layer1_activation_function": "relu", "config_layer1_drop_out": "0",
    "config_layer2_layer_type": "output", "config_layer2_n_out": "2",
    "config_layer2_activation_function": "softmax", "config_layer2_drop_out": "0",
}


def test_config5_streaming_bandpass_dwt_nn_8_shards():
    """Config 5: streaming FFT band-pass + DWT on continuous EEG, time axis
    over 8 logical CPU shards, then the nn classifier: the features within
    2e-5 of the JAX package's 8-device mesh run, the nn's outputs on them
    within the nn slice's 1e-4 of the JAX package's."""
    n_ch, T = 16, 8 * 1024
    rng = np.random.RandomState(5)
    sig = rng.randn(n_ch, T).astype(np.float32) * 30.0
    tmesh = _tmesh(8)
    feats = streaming.make_streaming_extractor(tmesh, window=512, stride=256, fs=1000.0)(
        streaming.stage_recording(sig, tmesh))
    assert feats.shape == (T // 256, n_ch * 16) and torch.isfinite(feats).all()
    jfeats = _jax_extract(sig, 8, window=512, stride=256, fs=1000.0)
    np.testing.assert_allclose(feats.numpy(), jfeats, rtol=0, atol=F32_TOL)

    labels = (rng.rand(feats.shape[0]) > 0.5).astype(np.float64)
    clf = registry.create("nn")
    clf.set_config(dict(_NN_CONFIG))
    clf.fit(feats, torch.from_numpy(labels).to(torch.float32))
    preds = clf.predict(feats).numpy()
    assert preds.shape == (feats.shape[0],) and np.isfinite(preds).all()
    jclf = jax_registry.create("nn")
    jclf.set_config(dict(_NN_CONFIG))
    jclf.fit(jfeats, labels)
    np.testing.assert_allclose(preds, np.asarray(jclf.predict(jfeats)), rtol=0, atol=1e-4)
