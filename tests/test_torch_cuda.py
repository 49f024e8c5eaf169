"""The CUDA kernels against their plain versions, on the card: the fused
ingest kernel (int16 and float32 streams, at every precision= rung), the
serve megakernel (f32, int8, int4) and the epoch-features kernel.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither JAX nor the JAX package, so it
runs on a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance 2e-6 on features: a kernel and its plain version compute the
same float32 arithmetic and differ only in summation order (for int16
streams the baseline mean, summed exactly in float64 by both, agrees bit
for bit; for float32 streams it may differ by an ulp).
On margins, 2e-6 * ||w||_1: the margin error a 2e-6 feature error can
make. The int8/int4 rungs' quantize step is held bit for bit against the
plain quantizer applied to the f32 kernel's own rows; against the plain
version of the whole chain a row may differ where an f32 ulp moves a
value across a quantization boundary, by one step of its group.
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu_torch.features import wavelet
from eeg_dataanalysispackage_tpu_torch.ops import (
    decode_ingest, device_ingest, dwt, dwt_cuda, ingest_cuda, quant, serve_mega,
    serve_mega_cuda,
)

RES = np.array([0.1, 0.1, 0.2], np.float32)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _stream(dc, noise, S, seed):
    rng = np.random.RandomState(seed)
    x = rng.randint(-noise, noise, size=(3, S)) + np.asarray(dc)[:, None]
    return np.clip(x, -32768, 32767).astype(np.int16)


STARTS = {
    "dense": lambda S: 37 * np.arange(101),
    "single": lambda S: np.array([4900]),
    "overhang": lambda S: np.array([0, S - 200, S - 686, S - 1, S]),
    "odd_count": lambda S: np.random.RandomState(1).randint(0, S, size=333),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STARTS))
@pytest.mark.parametrize("dc,noise", [((0, 0, 0), 3000), ((30000, -30000, 29500), 1500)])
def test_ingest_kernel_matches_plain_version(case, dc, noise):
    dev = _card()
    S = 30000
    raw = torch.from_numpy(_stream(dc, noise, S, seed=0)).to(dev)
    res = torch.from_numpy(RES).to(dev)
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    starts = torch.from_numpy(STARTS[case](S).astype(np.int32)).to(dev)
    before = ingest_cuda.LAUNCHES
    got = ingest_cuda.ingest_features(raw, res, starts, W)
    torch.cuda.synchronize()
    assert ingest_cuda.LAUNCHES == before + 1
    want = device_ingest.ingest_features_plain(raw, res, starts, W)
    assert got.shape == want.shape == (starts.shape[0], 48)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6
    at_end = starts >= S
    assert (got[at_end] == 0).all()


@pytest.mark.cuda
def test_ingest_kernel_raises_on_a_refused_launch():
    """A launch the card refuses (here: more shared memory than a block
    may have, from a channel count no recording has) raises instead of
    returning unwritten memory."""
    dev = _card()
    raw = torch.zeros((200, 1000), dtype=torch.int16, device=dev)
    res = torch.ones(200, dtype=torch.float32, device=dev)
    W = torch.zeros((512, 16), dtype=torch.float32, device=dev)
    starts = torch.zeros(4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        ingest_cuda.ingest_features(raw, res, starts, W)


def _mega_inputs(dev, capacity, n, dc, noise, seed):
    """A staged serve batch of ``n`` windows at capacity ``capacity``,
    the cascade operator and random weights, on ``dev``."""
    stride = serve_mega.padded_stride(100, 750)
    rng = np.random.RandomState(seed)
    windows = [
        np.clip(rng.randint(-noise, noise, size=(3, 850)) + np.asarray(dc)[:, None],
                -32768, 32767).astype(np.int16)
        for _ in range(n)
    ]
    stream = serve_mega.stage_mega_stream(windows, 3, 850, stride, capacity)
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    weights = torch.from_numpy(rng.randn(48).astype(np.float32)).to(dev)
    res = torch.from_numpy(RES).to(dev)
    return torch.from_numpy(stream).to(dev), res, W, weights, stride


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,n", [(64, 1), (64, 64), (128, 77), (2048, 2048)])
@pytest.mark.parametrize("dc,noise", [((0, 0, 0), 3000), ((30000, -30000, 29500), 1500)])
def test_serve_mega_kernel_matches_plain_version(capacity, n, dc, noise):
    dev = _card()
    stream, res, W, weights, stride = _mega_inputs(dev, capacity, n, dc, noise, seed=n)
    before = serve_mega_cuda.LAUNCHES
    got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
    torch.cuda.synchronize()
    assert serve_mega_cuda.LAUNCHES == before + 1
    want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175, stride)
    assert got.shape == want.shape == (capacity,)
    assert torch.isfinite(got).all()
    tol = 2e-6 * weights.abs().sum().item()
    assert (got - want).abs().max().item() <= tol
    assert (got[n:] == 0).all()


@pytest.mark.cuda
def test_serve_mega_margin_is_bit_identical_in_any_batch():
    dev = _card()
    stream, res, W, weights, stride = _mega_inputs(dev, 64, 9, (15000, -12000, 9000), 3000, 3)
    batch = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
    for i in range(9):
        solo = torch.zeros_like(stream)
        solo[:, :stride] = stream[:, i * stride:(i + 1) * stride]
        got = serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride)
        assert got[0].item() == batch[i].item()


@pytest.mark.cuda
def test_serve_mega_kernel_raises_on_a_refused_launch():
    """A launch the card refuses (more shared memory than a block may
    have, from a channel count no recording has) raises."""
    dev = _card()
    stride = serve_mega.padded_stride(100, 750)
    stream = torch.zeros((200, 4 * stride), dtype=torch.int16, device=dev)
    res = torch.ones(200, dtype=torch.float32, device=dev)
    W = torch.zeros((512, 16), dtype=torch.float32, device=dev)
    weights = torch.zeros(200 * 16, dtype=torch.float32, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STARTS))
@pytest.mark.parametrize("dc,noise", [((0.0, 0.0, 0.0), 300.0), ((3000.0, -3000.0, 2950.5), 150.0)])
def test_ingest_kernel_matches_plain_version_on_a_float32_stream(case, dc, noise):
    dev = _card()
    S = 30000
    rng = np.random.RandomState(2)
    x = rng.randn(3, S) * noise + np.asarray(dc)[:, None]
    raw = torch.from_numpy(x.astype(np.float32)).to(dev)
    res = torch.ones(3, dtype=torch.float32, device=dev)
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)
    starts = torch.from_numpy(STARTS[case](S).astype(np.int32)).to(dev)
    before = (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32)
    got = ingest_cuda.ingest_features(raw, res, starts, W)
    torch.cuda.synchronize()
    assert (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32) == (before[0], before[1] + 1)
    want = device_ingest.ingest_features_plain(raw, res, starts, W)
    assert got.shape == want.shape == (starts.shape[0], 48)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6
    assert (got[starts >= S] == 0).all()


def _epochs(B, C=3, T=750, seed=0, dc=300.0, noise=40.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, C, T) * noise + rng.randn(B, C, 1) * dc).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 37, 128, 1000])
@pytest.mark.parametrize("dc,noise", [(300.0, 40.0), (3000.0, 15.0)])
def test_epoch_kernel_matches_plain_version(B, dc, noise):
    dev = _card()
    x = torch.from_numpy(_epochs(B, seed=B, dc=dc, noise=noise)).to(dev)
    before = dwt_cuda.LAUNCHES
    got = dwt_cuda.epoch_features_cuda(x)
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES == before + 1
    want = dwt.epoch_features(x)
    assert got.shape == want.shape == (B, 48)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_epoch_kernel_gives_an_all_zero_epoch_a_zero_row():
    dev = _card()
    x = _epochs(7, seed=1)
    x[3] = 0.0
    got = dwt_cuda.epoch_features_cuda(torch.from_numpy(x).to(dev))
    assert (got[3] == 0).all() and torch.isfinite(got).all()


@pytest.mark.cuda
def test_epoch_kernel_behind_the_extractor_selects_channels_on_the_host():
    dev = _card()
    five = _epochs(16, C=5, seed=3).astype(np.float64)
    fe = wavelet.WaveletTransform(backend="pallas", device=dev)
    before = dwt_cuda.LAUNCHES
    got = fe.extract_batch(five)
    assert dwt_cuda.LAUNCHES == before + 1 and got.device.type == "cuda"
    want = dwt.epoch_features(torch.from_numpy(five[:, :3].astype(np.float32)).to(dev))
    assert (got - want).abs().max().item() <= 2e-6


@pytest.mark.cuda
def test_epoch_kernel_wrapper_raises_rather_than_running_the_plain_version():
    """A CUDA tensor the kernel does not take raises (no plain fallback),
    and an empty batch returns (0, C*16) without a launch."""
    dev = _card()
    before = dwt_cuda.LAUNCHES
    with pytest.raises(ValueError, match="exceeds epoch length"):
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 3, 600), device=dev))
    with pytest.raises(ValueError, match="float32"):
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 3, 750), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="epoch_size=512"):
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 3, 750), device=dev), epoch_size=256)
    empty = dwt_cuda.epoch_features_cuda(torch.zeros((0, 3, 750), device=dev))
    assert empty.shape == (0, 48) and dwt_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_pallas_extractor_refuses_other_sizes_on_the_card():
    """The kernel computes a 512-sample window and 16 coefficients; a
    pallas extractor set to other sizes raises on the card, where the
    CPU runs the plain version."""
    dev = _card()
    fe = wavelet.WaveletTransform(backend="pallas", device=dev)
    fe.set_feature_size(8)
    before = dwt_cuda.LAUNCHES
    with pytest.raises(ValueError, match="feature_size=16; got 512, 8"):
        fe.extract_batch(_epochs(4, seed=2).astype(np.float64))
    assert dwt_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_epoch_kernel_raises_on_a_refused_launch():
    """More shared memory than a block may have, from a channel count no
    recording has: the launch is refused and the wrapper raises."""
    dev = _card()
    with pytest.raises(RuntimeError, match="launch failed"):
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 200, 750), device=dev))


_RUNG_COUNTERS = {"bf16": "LAUNCHES_BF16", "int8": "LAUNCHES_INT8", "int4": "LAUNCHES_INT4"}
_QUANTIZE = {"int8": decode_ingest.int8_feature_path, "int4": quant.int4_feature_path}


def _raw(dev, sample, dc, S, seed):
    if sample == "int16":
        return torch.from_numpy(_stream(dc, 3000, S, seed)).to(dev), torch.from_numpy(RES).to(dev)
    x = np.random.RandomState(seed).randn(3, S) * 300.0 + np.asarray(dc, np.float64)[:, None] / 10
    return torch.from_numpy(x.astype(np.float32)).to(dev), torch.ones(3, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STARTS))
@pytest.mark.parametrize("sample", ["int16", "float32"])
@pytest.mark.parametrize("dc", [(0, 0, 0), (30000, -30000, 29500)])
def test_bf16_rung_matches_plain_version(case, sample, dc):
    """K2-bf16: bfloat16-rounded operands, float32 accumulation; within
    2e-6 of its plain version and within the bf16 gate of the f32 rung."""
    dev = _card()
    S = 30000
    raw, res = _raw(dev, sample, dc, S, seed=4)
    W = dwt.kernel_operator(8, dev)
    starts = torch.from_numpy(STARTS[case](S).astype(np.int32)).to(dev)
    before = ingest_cuda.LAUNCHES_BF16
    got = ingest_cuda.ingest_features(raw, res, starts, W, precision="bf16")
    torch.cuda.synchronize()
    assert ingest_cuda.LAUNCHES_BF16 == before + 1
    want = device_ingest.ingest_features_plain(raw, res, starts, W, precision="bf16")
    f32 = ingest_cuda.ingest_features(raw, res, starts, W)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6
    assert (got - f32).abs().max().item() <= decode_ingest.BF16_GATE_TOL
    assert (got[starts >= S] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("sample", ["int16", "float32"])
@pytest.mark.parametrize("dc", [(0, 0, 0), (30000, -30000, 29500)])
def test_quantize_epilogue_is_the_plain_quantizer_bit_for_bit(precision, sample, dc):
    """K1-int8/int4: the kernel's rows equal the plain quantizer applied
    to the f32 kernel's rows of the same windows, bit for bit."""
    dev = _card()
    S = 60000
    raw, res = _raw(dev, sample, dc, S, seed=5)
    W = dwt.kernel_operator(8, dev)
    starts = torch.from_numpy(np.concatenate([
        np.random.RandomState(6).randint(0, S - 787, size=700), [S - 300, S]
    ]).astype(np.int32)).to(dev)
    counter = _RUNG_COUNTERS[precision]
    before = getattr(ingest_cuda, counter)
    got = ingest_cuda.ingest_features(raw, res, starts, W, precision=precision)
    torch.cuda.synchronize()
    assert getattr(ingest_cuda, counter) == before + 1
    f32 = ingest_cuda.ingest_features(raw, res, starts, W)
    want = _QUANTIZE[precision](f32.cpu(), 16)
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    assert (got[-1] == 0).all()  # a window at the end reads zeros
    plain = device_ingest.ingest_features_plain(raw, res, starts, W, precision=precision)
    assert (got - plain).abs().max().item() <= decode_ingest.precision_gate_tolerance(precision)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("capacity,n", [(64, 1), (64, 64), (128, 77), (2048, 2048)])
def test_quantized_mega_kernel_matches_the_quantized_ingest_rows(precision, capacity, n):
    """K5-int8/int4: margins within 2e-6 * ||w||_1 of K1-int8/int4's rows
    of the same windows dotted with w, within the rung's tolerance of the
    plain version; padded rows 0; a margin the same solo and in a batch."""
    dev = _card()
    stream, res, W, weights, stride = _mega_inputs(
        dev, capacity, n, (15000, -12000, 9000), 3000, seed=n)
    counter = _RUNG_COUNTERS[precision]
    before = getattr(serve_mega_cuda, counter)
    got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride,
                                             precision)
    torch.cuda.synchronize()
    assert getattr(serve_mega_cuda, counter) == before + 1
    starts = (torch.arange(capacity, dtype=torch.int32, device=dev) * stride).contiguous()
    rows = ingest_cuda.ingest_features(stream, res, starts, W, 100, 175, precision)
    tol = 2e-6 * weights.abs().sum().item()
    assert (got - rows @ weights).abs().max().item() <= tol
    plain = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175, stride,
                                                precision)
    assert (got - plain).abs().max().item() <= decode_ingest.precision_gate_tolerance(precision)
    assert (got[n:] == 0).all()
    solo = torch.zeros_like(stream)
    solo[:, :stride] = stream[:, (n - 1) * stride:n * stride]
    solo_m = serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride,
                                                precision)
    assert solo_m[0].item() == got[n - 1].item()


@pytest.mark.cuda
def test_mega_wrapper_refuses_bf16_on_the_card():
    dev = _card()
    stream, res, W, weights, stride = _mega_inputs(dev, 64, 1, (0, 0, 0), 3000, seed=0)
    with pytest.raises(ValueError, match="bf16 has no mega twin"):
        serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride, "bf16")
