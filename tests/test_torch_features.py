"""The port's feature extraction (``fe=dwt-<i>`` and its backends) against
the JAX package, on the same numpy epochs.

Tolerances:
- the host backend is float64 with the reference's accumulation order
  in both packages: bit-equal;
- ``xla`` and ``xla-compact`` against the JAX package's ``xla`` and
  ``xla-compact``: 5e-7 (one float32 contraction each, summed in
  another order);
- the epoch-features kernel's plain version against the JAX package's
  Pallas kernel in interpret mode: 5e-7, the tolerance of
  ``tests/test_pallas_dwt.py``; against the float64 host path: 5e-5
  (float32 single rounding against float64), as there.
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.features import registry as jax_registry
from eeg_dataanalysispackage_tpu.features import wavelet as jax_wavelet
from eeg_dataanalysispackage_tpu.ops import dwt as jax_dwt
from eeg_dataanalysispackage_tpu.ops import dwt_host as jax_dwt_host
from eeg_dataanalysispackage_tpu.ops import dwt_pallas
from eeg_dataanalysispackage_tpu_torch.features import base, registry, wavelet
from eeg_dataanalysispackage_tpu_torch.ops import dwt, dwt_cuda, dwt_host


def _epochs(B, C=3, T=750, seed=0):
    """Host-like float64 epochs: noise around a per-channel DC offset."""
    rng = np.random.RandomState(seed)
    return rng.randn(B, C, T) * 50.0 + rng.randn(B, C, 1) * 300.0


def _port(name):
    return registry.create(name, device="cpu")


@pytest.mark.parametrize("B,C", [(1, 3), (11, 3), (37, 3), (6, 5)])
def test_host_backend_bit_equal_to_jax(B, C):
    ep = _epochs(B, C, seed=B)
    got = _port("dwt-8").extract_batch(ep)
    want = jax_registry.create("dwt-8").extract_batch(ep)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert got.shape == want.shape == (B, 48)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("wavelet_index,count", [(8, 16), (2, 16), (4, 32), (16, 8)])
def test_dwt_host_functions_bit_equal_to_jax(wavelet_index, count):
    sig = np.random.RandomState(wavelet_index).randn(5, 3, 512) * 20.0
    got = dwt_host.dwt_coefficients(sig, wavelet_index, count)
    want = jax_dwt_host.dwt_coefficients(sig, wavelet_index, count)
    assert got.tobytes() == want.tobytes()
    flat = got.reshape(5, -1)
    assert dwt_host.l2_normalize_seq(flat).tobytes() == jax_dwt_host.l2_normalize_seq(flat).tobytes()


def test_l2_normalize_seq_keeps_javas_nan_on_a_zero_row():
    x = np.array([[0.0, 0.0], [3.0, 4.0]])
    with np.errstate(invalid="ignore"):
        got = dwt_host.l2_normalize_seq(x)
    assert np.isnan(got[0]).all()
    np.testing.assert_array_equal(got[1], [0.6, 0.8])


@pytest.mark.parametrize("spelling", ["dwt-8-tpu", "dwt-8-tpu-compact", "dwt-4-tpu",
                                      "dwt-4-tpu-compact"])
@pytest.mark.parametrize("C", [3, 5])
def test_xla_backends_match_jax(spelling, C):
    ep = _epochs(23, C, seed=C)
    got = _port(spelling).extract_batch(ep)
    want = np.asarray(jax_registry.create(spelling).extract_batch(ep))
    assert got.dtype == torch.float32 and got.shape == want.shape == (23, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-7)


@pytest.mark.parametrize("B", [37, 5, 128])
def test_kernel_plain_version_matches_pallas_interpret(B):
    ep = _epochs(B, seed=B).astype(np.float32)
    got = dwt_cuda.epoch_features_cuda(torch.from_numpy(ep)).numpy()
    # tile_b=4 puts B = 5 and 37 off the tile, as the JAX package's own test
    want = np.asarray(dwt_pallas.epoch_features_pallas(ep, tile_b=4, interpret=True))
    assert got.shape == want.shape == (B, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)


def test_pallas_backend_matches_host_path():
    ep = _epochs(40, seed=7)
    host = _port("dwt-8").extract_batch(ep).numpy()
    pal = _port("dwt-8-pallas").extract_batch(ep)
    assert pal.dtype == torch.float32 and pal.shape == (40, 48)
    np.testing.assert_allclose(pal.numpy(), host, rtol=0, atol=5e-5)


def test_pallas_window_validation():
    with pytest.raises(ValueError, match="exceeds epoch length"):
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 3, 600)), skip_samples=175, epoch_size=512)
    with pytest.raises(ValueError, match="exceeds epoch length"):
        dwt_pallas.epoch_features_pallas(np.zeros((2, 3, 600), np.float32))
    # the extractor checks first, with the reference's message
    msg = r"skip_samples \(175\) \+ epoch_size \(512\) exceeds the epoch length \(600\)"
    with pytest.raises(ValueError, match=msg):
        _port("dwt-8-pallas").extract_batch(np.zeros((2, 3, 600)))
    with pytest.raises(ValueError, match=msg):
        jax_registry.create("dwt-8-pallas").extract_batch(np.zeros((2, 3, 600)))


def test_pallas_selects_configured_channels():
    five = np.random.RandomState(2).randn(4, 5, 750) * 30.0
    host = _port("dwt-8").extract_batch(five).numpy()
    pal = _port("dwt-8-pallas").extract_batch(five).numpy()
    want = np.asarray(jax_wavelet.WaveletTransform(backend="pallas").extract_batch(five))
    assert host.shape == pal.shape == want.shape == (4, 48)
    np.testing.assert_allclose(pal, host, rtol=0, atol=5e-5)
    np.testing.assert_allclose(pal, want, rtol=0, atol=5e-7)


def test_pallas_backend_registered():
    fe = _port("dwt-8-pallas")
    assert isinstance(fe, wavelet.WaveletTransform) and fe.backend == "pallas"
    four = _port("dwt-4-pallas")
    assert four.name == 4 and four.backend == "pallas"
    ep = _epochs(6, seed=4)
    np.testing.assert_allclose(
        four.extract_batch(ep).numpy(),
        np.asarray(jax_registry.create("dwt-4-pallas").extract_batch(ep)),
        rtol=0, atol=5e-7,
    )


@pytest.mark.parametrize("name", ["dwt-8", "dwt-8-tpu", "dwt-8-pallas", "dwt-8-tpu-compact",
                                  "dwt-3", "dwt-12-tpu", "dwt-0-tpu-compact", "dwt-4-pallas"])
def test_registry_names_match_jax(name):
    ours, theirs = _port(name), jax_registry.create(name)
    assert isinstance(ours, base.FeatureExtraction)
    assert (ours.name, ours.epoch_size, ours.skip_samples, ours.feature_size, ours.channels,
            ours.backend) == (theirs.name, theirs.epoch_size, theirs.skip_samples,
                              theirs.feature_size, theirs.channels, theirs.backend)
    assert repr(ours) == repr(theirs)
    assert hash(ours) == hash(theirs)
    assert ours.feature_dimension == theirs.feature_dimension == 48
    assert ours.cache_id() == theirs.cache_id()


@pytest.mark.parametrize("name", ["fft", "dwt-8-gpu", "", "DWT-8", "dwt-x", "dwt-8-fused-tpu"])
def test_registry_unknown_names_raise_reference_message(name):
    with pytest.raises(ValueError, match="^Unsupported feature extraction argument$"):
        _port(name)
    with pytest.raises(ValueError, match="^Unsupported feature extraction argument$"):
        jax_registry.create(name)


@pytest.mark.parametrize("name", ["dwt-8-tpu-bf16", "dwt-8-tpu-compact-bf16", "dwt-8:level=4",
                                  "dwt-4:level=3:stats=energy"])
def test_registry_unported_spellings_raise(name):
    jax_registry.create(name)  # the reference runs them
    with pytest.raises(ValueError, match="not yet ported"):
        _port(name)


def test_registry_register_adds_a_name():
    registry.register("dwt-8-test-alias",
                      lambda device: wavelet.WaveletTransform(backend="xla", device=device))
    try:
        fe = _port("dwt-8-test-alias")
        assert fe.backend == "xla" and fe.device.type == "cpu"
    finally:
        del registry._REGISTRY["dwt-8-test-alias"]


SETTERS = [
    ("set_wavelet_name", -1), ("set_wavelet_name", 18), ("set_epoch_size", 0),
    ("set_epoch_size", 751), ("set_skip_samples", 0), ("set_skip_samples", 751),
    ("set_feature_size", 0), ("set_feature_size", 1025),
]


@pytest.mark.parametrize("setter,value", SETTERS)
def test_setter_ranges_and_messages_match_jax(setter, value):
    ours = wavelet.WaveletTransform(device="cpu")
    theirs = jax_wavelet.WaveletTransform()
    with pytest.raises(ValueError) as want:
        getattr(theirs, setter)(value)
    with pytest.raises(ValueError) as got:
        getattr(ours, setter)(value)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("setter,value,attr", [
    ("set_wavelet_name", 17, "name"), ("set_wavelet_name", 0, "name"),
    ("set_epoch_size", 750, "epoch_size"), ("set_skip_samples", 750, "skip_samples"),
    ("set_feature_size", 1024, "feature_size"),
])
def test_setters_accept_the_range_ends(setter, value, attr):
    fe = wavelet.WaveletTransform(device="cpu")
    getattr(fe, setter)(value)
    assert getattr(fe, attr) == value


def test_equality_and_hash_follow_the_reference():
    a = wavelet.WaveletTransform(device="cpu")
    b = wavelet.WaveletTransform(backend="pallas", channels=(1, 2), device="cpu")
    assert a == b and hash(a) == hash(b)  # backend and channels are not compared
    b.set_feature_size(8)
    assert a != b
    assert repr(a) == "DWT: EPOCH_SIZE: 512 FEATURE_SIZE: 16 WAVELETNAME: 8 SKIP_SAMPLES: 175"


def test_setter_changes_reach_the_device_extractors():
    ep = _epochs(3, seed=9)
    fe = wavelet.WaveletTransform(backend="xla", device="cpu")
    fe.extract_batch(ep)
    fe.set_feature_size(8)
    assert fe.extract_batch(ep).shape == (3, 24)
    fe.backend = "xla-compact"
    assert fe.extract_batch(ep).shape == (3, 24)


def test_unknown_backend_and_conv_method_raise():
    with pytest.raises(ValueError, match="unknown backend"):
        wavelet.WaveletTransform(backend="tpu", device="cpu")
    # the level-by-level filter bank is not ported: the extractors take
    # no method at all, so nothing can select it
    with pytest.raises(TypeError, match="method"):
        dwt.make_batched_extractor(method="conv", device="cpu")
    with pytest.raises(TypeError, match="method"):
        dwt.make_compact_extractor(method="conv", device="cpu")


def test_compact_extractor_rejects_a_mis_sliced_batch():
    with pytest.raises(ValueError, match="compact path built for epoch_size 512"):
        dwt.make_compact_extractor(device="cpu")(torch.zeros((2, 3, 500)))


def test_pallas_backend_takes_other_sizes_on_the_cpu_only():
    """The plain version (and the JAX package's Pallas kernel) take any
    window and coefficient count; the CUDA kernel computes 512 and 16
    only, and the wrapper refuses other sizes for any tensor off the CPU
    before it looks for the kernel."""
    ep = _epochs(4, seed=12)
    ours = wavelet.WaveletTransform(backend="pallas", device="cpu")
    theirs = jax_wavelet.WaveletTransform(backend="pallas")
    for fe in (ours, theirs):
        fe.set_feature_size(8)
    got = ours.extract_batch(ep).numpy()
    assert got.shape == (4, 24)
    np.testing.assert_allclose(got, np.asarray(theirs.extract_batch(ep)), rtol=0, atol=5e-7)
    off_cpu = torch.zeros((2, 3, 750), device="meta")
    with pytest.raises(ValueError, match="epoch-features kernel computes epoch_size=512, "
                                         "feature_size=16; got 512, 8"):
        dwt_cuda.epoch_features_cuda(off_cpu, feature_size=8)
    with pytest.raises(ValueError, match="got 256, 16"):
        dwt_cuda.epoch_features_cuda(off_cpu, skip_samples=0, epoch_size=256)
    with pytest.raises(ValueError, match="unsupported device meta"):
        dwt_cuda.epoch_features_cuda(off_cpu)


def test_kernel_operator_is_the_cascade_matrix_once_per_device():
    W = dwt.kernel_operator(8, torch.device("cpu"))
    assert W.shape == (dwt.KERNEL_EPOCH_SIZE, dwt.KERNEL_FEATURE_SIZE) == (512, 16)
    assert W.dtype == torch.float32 and W.is_contiguous()
    np.testing.assert_array_equal(W.numpy(), dwt.cascade_matrix(8, 512, 16).astype(np.float32))
    assert dwt.kernel_operator(8, torch.device("cpu")) is W
    assert not torch.equal(dwt.kernel_operator(4, torch.device("cpu")), W)


def test_extract_features_single_epoch_adapter():
    ep = _epochs(2, seed=11)
    fe = _port("dwt-8-tpu")
    np.testing.assert_array_equal(fe.extract_features(ep[1]).numpy(),
                                  fe.extract_batch(ep[1:2])[0].numpy())


def test_kernel_wrapper_rejects_bad_inputs_and_runs_plain_on_cpu():
    good = torch.zeros((2, 3, 750))
    with pytest.raises(ValueError, match="float32"):
        dwt_cuda.epoch_features_cuda(good.double())
    with pytest.raises(ValueError, match="float32"):
        dwt_cuda.epoch_features_cuda(good[0])
    with pytest.raises(ValueError, match="contiguous"):
        dwt_cuda.epoch_features_cuda(torch.zeros((3, 2, 750)).transpose(0, 1))
    before = dwt_cuda.LAUNCHES
    out = dwt_cuda.epoch_features_cuda(good)
    assert dwt_cuda.LAUNCHES == before
    assert out.shape == (2, 48) and not out.any()  # all-zero epochs, zero rows
