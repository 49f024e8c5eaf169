"""The CUDA kernels against their plain versions, on the card: the fused
ingest kernel (int16 and float32 streams, at every precision= rung), the
serve megakernel (f32, int8, int4, on int16 and float32 streams), its
tenant-stacked instantiation (K6, held bit for bit against the solo
megakernel per lane, and through a multi-tenant service against solo
services), float32 sessions served on the card, the host-extractor
service, the tree growers on the card (against the host grower and the
CPU, ties included, and a served forest), and the epoch-features
kernel (at every window alignment, at any window and coefficient count
the cascade has, and on wide montages).

Two cases run the batch path over a loopback WebHDFS namenode
(``tests/_loopback.py``): a fused run and a served run from ``hdfs://``,
held against the same runs from local paths.

Three cases hold the run record on the card: a feature-cache hit
returns the miss's rows on the card and launches no ingest (or, for a
seizure run, epoch-features) kernel, and a ``trace_path=`` trace holds
the ingest kernel's record. The file turns the feature cache off when
it is imported (``EEG_TPU_NO_FEATURE_CACHE=1``, as the conftest it runs
without does), so every other case's launch counts read misses; the
cache cases turn it on in a directory of their own.

The input pipeline on the card: overlapped fused ingest bit-equal to the
serial run over 20 repeats (on ``cuda`` and ``cuda:0``), K1 on the
producer's own stream and the samples from pinned memory in a profiler
trace, ``stage_raw``'s pinned non-blocking copies equal to a pageable
copy behind a busy stream, the native epoch stage equal to numpy's, and
``staging.prefetch``'s pinned stage and event handoff.

Multi-process runs on the card (two ranks over gloo on one card, or a
card a rank where there are several): a ``processes=2`` population run
through ``parallel/pod.spawn_pod_member`` whose ranks launch K1 once per
owned recording and whose statistics and exchanged matrix equal the
one-process card run's; the two-process worker
(``tests/_torch_distributed_worker.py``) on the card, bit-equal to one
process over the same four shards; the streaming front end on a 4-shard
time mesh and the blocked iterator against the CPU.

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

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

# the feature cache is on by default: off for every case that counts
# launches (tests/conftest.py does the same, and this file runs without it)
os.environ.setdefault("EEG_TPU_NO_FEATURE_CACHE", "1")

from eeg_dataanalysispackage_tpu_torch.features import wavelet
from eeg_dataanalysispackage_tpu_torch.models import registry
from eeg_dataanalysispackage_tpu_torch.ops import (
    decode_ingest, device_ingest, dwt, dwt_cuda, generic_plan, ingest_cuda, quant, serve_mega,
    serve_mega_cuda,
)
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import (
    InferenceService, MultiplexedService, ServeConfig,
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
@pytest.mark.parametrize("B", [1, 5, 37, 128, 641, 1494, 32768])
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
@pytest.mark.parametrize("T", [750, 749, 751, 753])
@pytest.mark.parametrize("skip", [1, 2, 3, 4, 5, 6, 7, 8, 175])
def test_epoch_kernel_at_every_alignment(T, skip):
    """Rows whose windows start at every 4-byte offset within a 16-byte
    chunk, on a tensor whose first byte is and is not 16-byte aligned
    (chunks past either end of it copied float by float): the rows of the
    misaligned tensor equal the aligned one's bit for bit."""
    dev = _card()
    B = 37
    x = _epochs(B, T=T, seed=T + skip)
    flat = torch.zeros(B * 3 * T + 1, device=dev)
    flat[1:] = torch.from_numpy(x.reshape(-1)).to(dev)
    shifted = flat[1:].view(B, 3, T)  # its first byte 4 past a 16-byte boundary
    aligned = torch.from_numpy(x).to(dev)
    n = min(512, T - skip)
    want = dwt.epoch_features(aligned, 8, skip, n, 16)
    for xt in (aligned, shifted):
        got = dwt_cuda.epoch_features_cuda(xt, 8, skip, n, 16)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 2e-6
    rows = [dwt_cuda.epoch_features_cuda(xt, 8, skip, n, 16) for xt in (aligned, shifted)]
    assert torch.equal(rows[0], rows[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,skip", [(512, 16, 175), (256, 16, 175), (512, 64, 175),
                                      (750, 32, 0), (333, 20, 0), (16, 16, 0), (1, 1, 0),
                                      (750, 745, 0), (128, 128, 5)])
@pytest.mark.parametrize("C", [1, 3, 5, 64])
def test_epoch_kernel_at_any_size(n, K, skip, C):
    """Any window and coefficient count the cascade has, at 1, 3, 5 and 64
    channels, against the plain version; an all-zero epoch gives an
    exactly zero row."""
    dev = _card()
    B = 37
    x = _epochs(B, C=C, seed=n + K + C)
    x[11] = 0.0
    xt = torch.from_numpy(x).to(dev)
    before = dwt_cuda.LAUNCHES
    got = dwt_cuda.epoch_features_cuda(xt, 8, skip, n, K)
    torch.cuda.synchronize()
    assert dwt_cuda.LAUNCHES == before + 1
    want = dwt.epoch_features(xt, 8, skip, n, K)
    assert got.shape == want.shape == (B, C * K)
    assert torch.isfinite(got).all() and (got[11] == 0).all()
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
    with pytest.raises(ValueError, match="exceeds the 128 coefficients"):
        dwt_cuda.epoch_features_cuda(torch.zeros((2, 3, 750), device=dev), 8, 0, 128, 200)
    empty = dwt_cuda.epoch_features_cuda(torch.zeros((0, 3, 750), device=dev))
    assert empty.shape == (0, 48) and dwt_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_pallas_extractor_refuses_other_sizes_on_the_card():
    """The pallas extractor set to other sizes through the reference's
    setters runs them on the card: each launch counted, its rows within
    2e-6 of the plain version. A coefficient count past the cascade's
    columns is what it refuses, before any launch."""
    dev = _card()
    ep = _epochs(40, seed=2).astype(np.float64)
    for n, skip, K in ((512, 175, 8), (256, 175, 16), (750, 1, 32), (333, 10, 20),
                       (16, 100, 16), (1, 1, 1)):
        fe = wavelet.WaveletTransform(backend="pallas", device=dev)
        fe.set_epoch_size(n)
        fe.set_skip_samples(skip)
        fe.set_feature_size(K)
        x = np.zeros((40, 3, max(750, skip + n)), np.float64)
        x[:, :, :750] = ep
        before = dwt_cuda.LAUNCHES
        got = fe.extract_batch(x)
        torch.cuda.synchronize()
        assert dwt_cuda.LAUNCHES == before + 1 and got.device.type == "cuda"
        want = dwt.epoch_features(torch.from_numpy(x.astype(np.float32)).to(dev), 8, skip, n, K)
        assert got.shape == (40, 3 * K)
        assert (got - want).abs().max().item() <= 2e-6
    fe = wavelet.WaveletTransform(backend="pallas", device=dev)
    fe.set_epoch_size(128)
    fe.set_feature_size(200)
    before = dwt_cuda.LAUNCHES
    with pytest.raises(ValueError, match="feature_size 200 exceeds the 128 coefficients"):
        fe.extract_batch(ep)
    assert dwt_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_epoch_kernel_raises_on_a_refused_launch():
    """The launch the one-epoch-per-block kernel refused (200 channels, its
    two window buffers past a block's shared memory) now runs: the
    kernel's shared memory does not grow with the channel count, and it
    refuses no launch for its size. Wide montages match the plain version
    at the main size and at another."""
    dev = _card()
    for C, n, K in ((200, 512, 16), (1000, 512, 16), (200, 333, 20)):
        x = torch.from_numpy(_epochs(9, C=C, seed=C)).to(dev)
        before = dwt_cuda.LAUNCHES
        got = dwt_cuda.epoch_features_cuda(x, 8, 175, n, K)
        torch.cuda.synchronize()
        assert dwt_cuda.LAUNCHES == before + 1
        want = dwt.epoch_features(x, 8, 175, n, K)
        assert got.shape == (9, C * K) and torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 2e-6


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
    W = dwt.kernel_operator(8, 512, 16, dev)
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
    W = dwt.kernel_operator(8, 512, 16, dev)
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


def _stack_and_lanes(dev, capacity, n, spread, seed):
    """A random (128, 48) tenant stack on ``dev`` with one freed (zero)
    lane, and host lanes: cycling over all 128 lanes, or all on one."""
    rng = np.random.RandomState(seed)
    stack = rng.randn(serve_mega.MAX_TENANTS, 48).astype(np.float32)
    stack[5] = 0.0
    lanes = np.zeros(capacity, np.int32)
    lanes[:n] = np.arange(n) % 128 if spread == "cycling" else 77
    return torch.from_numpy(stack).to(dev), torch.from_numpy(lanes)


@pytest.mark.cuda
@pytest.mark.parametrize("spread", ["cycling", "one_lane"])
@pytest.mark.parametrize("capacity,n", [(64, 1), (64, 64), (128, 77), (2048, 2048)])
@pytest.mark.parametrize("dc,noise", [((0, 0, 0), 3000), ((30000, -30000, 29500), 1500)])
def test_multi_kernel_matches_plain_and_equals_solo_kernel_per_lane(capacity, n, spread, dc,
                                                                    noise):
    """K6: each row within 2e-6 * ||w_lane||_1 of the plain version, and
    bit-equal to K5 launched with that lane's weights; padded rows and a
    freed lane exactly 0."""
    dev = _card()
    stream, res, W, _weights, stride = _mega_inputs(dev, capacity, n, dc, noise, seed=n)
    stack, lanes = _stack_and_lanes(dev, capacity, n, spread, seed=capacity + n)
    before = serve_mega_cuda.MULTI_LAUNCHES
    got = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100, 175,
                                                   stride)
    torch.cuda.synchronize()
    assert serve_mega_cuda.MULTI_LAUNCHES == before + 1
    plain = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes, 100, 175,
                                                      stride)
    l1 = stack.abs().sum(dim=1)[lanes.to(dev).long()]
    assert ((got - plain).abs() <= 2e-6 * l1).all()
    for lane in np.unique(lanes.numpy()[:n]):
        solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[int(lane)], 100, 175,
                                                  stride)
        rows = torch.from_numpy(np.nonzero(lanes.numpy()[:n] == lane)[0]).to(dev)
        assert got[rows].cpu().numpy().tobytes() == solo[rows].cpu().numpy().tobytes()
    assert (got[n:] == 0).all()
    assert (got[:n][lanes[:n].to(dev) == 5] == 0).all()


@pytest.mark.cuda
def test_multi_kernel_wrapper_checks_lanes_on_the_host():
    dev = _card()
    stream, res, W, _weights, stride = _mega_inputs(dev, 64, 3, (0, 0, 0), 3000, seed=0)
    stack, lanes = _stack_and_lanes(dev, 64, 3, "cycling", seed=0)
    call = serve_mega_cuda.serve_mega_multi_margins
    with pytest.raises(ValueError, match="on the host"):
        call(stream, res, W, stack, lanes.to(dev), 100, 175, stride)
    with pytest.raises(ValueError, match=r"\[0, 128\)"):
        call(stream, res, W, stack, torch.where(lanes == 2, 128, lanes), 100, 175, stride)
    with pytest.raises(ValueError, match="stack is on cpu"):
        call(stream, res, W, stack.cpu(), lanes, 100, 175, stride)
    with pytest.raises(ValueError, match="stack must be"):
        call(stream, res, W, stack[:64], lanes, 100, 175, stride)


def _random_linear(seed):
    rng = np.random.RandomState(seed)
    clf = registry.create("logreg")
    clf.from_numpy_state({"weights": rng.randn(48).astype(np.float32),
                          "intercept": float(rng.randn() * 0.1), "margin_threshold": 0.0,
                          "config": {}, "kind": "LogisticRegressionClassifier"})
    return clf


@pytest.mark.cuda
@pytest.mark.parametrize("rung", ["auto", "fused"])
def test_multiplexed_service_on_the_card_equals_solo_services(rung):
    """Mixed-tenant traffic through a multi-tenant service on the card:
    each tenant's margins and predictions equal a solo service's on the
    same rung bit for bit; admin after warmup builds no new library."""
    _card()
    from eeg_dataanalysispackage_tpu_torch.ops import cuda_build

    rng = np.random.RandomState(3)
    windows = [rng.randint(-3000, 3000, size=(3, 850)).astype(np.int16) for _ in range(150)]
    tenants = {f"t{i}": _random_linear(i) for i in range(6)}
    mix = [f"t{i % 6}" for i in range(150)]
    config = ServeConfig(max_batch=64)
    with MultiplexedService(tenants, config=config, engine_rung=rung) as svc:
        loaded = dict(cuda_build._LOADED)
        served = svc.predict_all(windows, RES, mix)
        svc.swap_tenant("t1", _random_linear(11))
        svc.add_tenant("t6", _random_linear(12))
        svc.remove_tenant("t2")
        after = svc.predict_all(windows[:6], RES, ["t1", "t6", "t0", "t3", "t4", "t5"])
        assert cuda_build._LOADED == loaded
    assert svc.engine.rung == ("mega" if rung == "auto" else "fused")
    for name, clf in tenants.items():
        with InferenceService(clf, config=config, engine_rung=rung) as solo:
            alone = solo.predict_all(windows, RES)
        rows = [i for i, t in enumerate(mix) if t == name]
        assert [served[i].margin for i in rows] == [alone[i].margin for i in rows]
        assert [served[i].prediction for i in rows] == [alone[i].prediction for i in rows]
    with InferenceService(_random_linear(12), config=config, engine_rung=rung) as solo:
        assert solo.predict_window(windows[1], RES).margin == after[1].margin


# ---------------------------------------------------------------------------
# The window ring (csrc/window_features.cuh run_windows): 16-byte chunks at
# any sample offset, the stream's edges, launches that do not fill the
# ring or the grid, and the margin's order.

def _samples(dtype, C, S, seed, dc=0):
    rng = np.random.RandomState(seed)
    if dtype == "int16":
        x = rng.randint(-3000, 3000, size=(C, S)) + dc
        return np.clip(x, -32768, 32767).astype(np.int16)
    return (rng.randn(C, S) * 300.0 + dc / 10).astype(np.float32)


def _res(dtype, C):
    return np.full(C, 0.1, np.float32) if dtype == "int16" else np.ones(C, np.float32)


def _operator(dev):
    return torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [30000, 30001])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_ingest_kernel_at_every_offset_within_a_chunk(dtype, S):
    """Starts at every sample offset within a 16-byte chunk (mod 8 for
    int16, mod 4 for float32), on rows that are 16-byte aligned (S =
    30,000) and rows that are not (30,001): within 2e-6 of the plain
    version, and each row equal bit for bit to the same window's row
    with the stream shifted right by r samples and its start by r."""
    dev = _card()
    v = 8 if dtype == "int16" else 4
    x = _samples(dtype, 3, S, seed=S, dc=15000)
    res = torch.from_numpy(_res(dtype, 3)).to(dev)
    W = _operator(dev)
    starts_np = np.concatenate([b + np.arange(2 * v) for b in (0, 1000, 17003, S - 800)])
    raw = torch.from_numpy(x).to(dev)
    starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
    got = ingest_cuda.ingest_features(raw, res, starts, W)
    torch.cuda.synchronize()
    want = device_ingest.ingest_features_plain(raw, res, starts, W)
    assert (got - want).abs().max().item() <= 2e-6
    for r in range(1, v):
        shifted = np.zeros((3, S + v), x.dtype)
        shifted[:, r:r + S] = x
        moved = ingest_cuda.ingest_features(torch.from_numpy(shifted).to(dev), res,
                                            starts + r, W)
        assert moved.cpu().numpy().tobytes() == got.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["aligned", "odd_length", "misaligned_first_byte"])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_ingest_kernel_at_the_stream_edges(dtype, layout):
    """Negative starts, starts straddling the recording's last sample into
    the staged zero padding, straddling the stream's end, at exactly the
    end (C2's zero row) and past it; on an aligned stream, one whose rows
    are not 16-byte aligned and one whose first byte is not. Within 2e-6
    of the plain version; a window at or past the end is a zero row; a
    window straddling into the padding equals, bit for bit, the same
    window on the unpadded recording (the padding is semantically free)."""
    dev = _card()
    S = 30001 if layout == "odd_length" else 30000
    n_true = S - 5000
    x = _samples(dtype, 3, S, seed=7, dc=20000)
    x[:, n_true:] = 0  # the staged padding after the recording
    torch_dtype = torch.int16 if dtype == "int16" else torch.float32
    if layout == "misaligned_first_byte":
        buf = torch.zeros(3 * S + 1, dtype=torch_dtype, device=dev)
        raw = buf[1:].view(3, S)
        raw.copy_(torch.from_numpy(x))
        assert raw.is_contiguous() and raw.data_ptr() % 16 != 0
    else:
        raw = torch.from_numpy(x).to(dev)
    res = torch.from_numpy(_res(dtype, 3)).to(dev)
    W = _operator(dev)
    straddle = [n_true - 787, n_true - 700, n_true - 612, n_true - 300, n_true - 1]
    starts_np = np.array([-900, -787, -612, -101, -100, -7, -1, 0, 3, *straddle, n_true,
                          S - 787, S - 700, S - 612, S - 300, S - 1, S, S + 9])
    starts = torch.from_numpy(starts_np.astype(np.int32)).to(dev)
    got = ingest_cuda.ingest_features(raw, res, starts, W)
    torch.cuda.synchronize()
    want = device_ingest.ingest_features_plain(raw, res, starts, W)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6
    assert (got[torch.from_numpy(starts_np >= S).to(dev)] == 0).all()
    unpadded = torch.from_numpy(np.ascontiguousarray(x[:, :n_true])).to(dev)
    part = torch.from_numpy(np.array(straddle, np.int32)).to(dev)
    alone = ingest_cuda.ingest_features(unpadded, res, part, W)
    rows = got[9:9 + len(straddle)]
    assert alone.cpu().numpy().tobytes() == rows.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 320, 2048 + 7])
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_ingest_kernel_row_counts_that_do_not_fill_the_ring(n, precision):
    """Row counts under one block per window, around one serve batch, one
    recording's plan and past one wave of blocks: within 2e-6 of the plain
    version (int8: the plain quantizer on the f32 rows, bit for bit), and
    the first, a middle and the last row equal bit for bit to launches of
    that window alone."""
    dev = _card()
    S = 200_000
    raw = torch.from_numpy(_samples("int16", 3, S, seed=n)).to(dev)
    res = torch.from_numpy(RES).to(dev)
    W = _operator(dev)
    starts = torch.from_numpy(
        np.random.RandomState(n).randint(-50, S + 50, size=n).astype(np.int32)).to(dev)
    got = ingest_cuda.ingest_features(raw, res, starts, W, precision=precision)
    torch.cuda.synchronize()
    f32 = ingest_cuda.ingest_features(raw, res, starts, W)
    assert (f32 - device_ingest.ingest_features_plain(raw, res, starts, W)).abs().max() <= 2e-6
    if precision == "int8":
        want = decode_ingest.int8_feature_path(f32.cpu(), 16)
        assert got.cpu().numpy().tobytes() == want.numpy().tobytes()
    for i in sorted({0, n // 2, n - 1}):
        solo = ingest_cuda.ingest_features(raw, res, starts[i:i + 1].contiguous(), W,
                                           precision=precision)
        assert solo.cpu().numpy().tobytes() == got[i:i + 1].cpu().numpy().tobytes()


def _round_f32(x):
    """The float32 nearest the exact rational x (ties to even)."""
    from fractions import Fraction

    f = np.float32(float(x))
    candidates = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(candidates, key=lambda c: (abs(Fraction(float(c)) - x),
                                          int(np.asarray(c).view(np.uint32)) & 1))


def _fmaf(a, b, c):
    from fractions import Fraction

    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _mega_order_dot(row, w):
    """The megakernel's margin of one float32 row, in its order: lane l
    sums features l, l + 32, ... by fmaf (rounded once), then the
    shfl_xor butterfly (16, 8, 4, 2, 1); lane 0's value."""
    lanes = []
    for lane in range(32):
        m = np.float32(0.0)
        for i in range(lane, len(row), 32):
            m = _fmaf(row[i], w[i], m)
        lanes.append(m)
    for off in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[l] + lanes[l ^ off]) for l in range(32)]
    return lanes[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dc", [(0, 0, 0), (30000, -30000, 29500)])
def test_mega_margin_is_the_ingest_row_dotted_in_the_megakernel_order(dc):
    """K5 at f32: each margin equal bit for bit to K1's row of the same
    window dotted with the weights in K5's order (rows equal K1's, the
    dot is the fixed 48-term order), emulated exactly on the host."""
    dev = _card()
    stream, res, W, weights, stride = _mega_inputs(dev, 64, 64, dc, 3000, seed=11)
    got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
    starts = (torch.arange(64, dtype=torch.int32, device=dev) * stride).contiguous()
    rows = ingest_cuda.ingest_features(stream, res, starts, W).cpu().numpy()
    w = weights.cpu().numpy()
    want = np.array([_mega_order_dot(r, w) for r in rows], np.float32)
    assert got.cpu().numpy().tobytes() == want.tobytes()


@pytest.mark.cuda
def test_multi_kernel_with_random_lanes_over_many_windows_per_block():
    """K6 with a random lane per row over 2,055 windows (several per block
    of the wave, each row's lane loaded as its window starts): every row
    bit-equal to K5 launched with its lane's weights."""
    dev = _card()
    capacity = 2048 + 7
    stream, res, W, _w, stride = _mega_inputs(dev, capacity, capacity, (9000, -4000, 100),
                                              3000, seed=5)
    rng = np.random.RandomState(5)
    stack = torch.from_numpy(rng.randn(serve_mega.MAX_TENANTS, 48).astype(np.float32)).to(dev)
    lanes_np = rng.randint(0, serve_mega.MAX_TENANTS, size=capacity).astype(np.int32)
    got = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack,
                                                   torch.from_numpy(lanes_np), 100, 175, stride)
    got_np = got.cpu().numpy()
    for lane in np.unique(lanes_np):
        solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[int(lane)], 100, 175,
                                                  stride).cpu().numpy()
        rows = np.nonzero(lanes_np == lane)[0]
        assert got_np[rows].tobytes() == solo[rows].tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_widest_montage_launches_and_one_channel_more_is_refused(dtype):
    """76 channels, the most the one-window-per-block kernels took at the
    100-sample baseline (their shared memory, channels * 757 floats, in a
    block's 227 KB): the ring runs them in pieces of channels, within 2e-6
    of the plain version (int8: the plain quantizer on the f32 rows, bit
    for bit), each row equal bit for bit to its window launched alone; 77
    channels raise, as they did, and count no launch."""
    dev = _card()
    W = _operator(dev)
    starts = torch.tensor([-30, 0, 5, 1003, 2999, 3500, 4000], dtype=torch.int32, device=dev)
    counters = lambda: (ingest_cuda.LAUNCHES + ingest_cuda.LAUNCHES_F32  # noqa: E731
                        + ingest_cuda.LAUNCHES_INT8)
    for C in (76, 77):
        raw = torch.from_numpy(_samples(dtype, C, 4000, seed=C)).to(dev)
        res = torch.from_numpy(_res(dtype, C)).to(dev)
        before = counters()
        if C == 76:
            got = ingest_cuda.ingest_features(raw, res, starts, W)
            torch.cuda.synchronize()
            want = device_ingest.ingest_features_plain(raw, res, starts, W)
            assert (got - want).abs().max().item() <= 2e-6
            q = ingest_cuda.ingest_features(raw, res, starts, W, precision="int8")
            assert q.cpu().numpy().tobytes() == decode_ingest.int8_feature_path(
                got.cpu(), 16).numpy().tobytes()
            assert counters() == before + 2
            for i in (0, 3, 6):
                solo = ingest_cuda.ingest_features(raw, res, starts[i:i + 1].contiguous(), W)
                assert solo.cpu().numpy().tobytes() == got[i:i + 1].cpu().numpy().tobytes()
        else:
            with pytest.raises(RuntimeError, match="launch failed"):
                ingest_cuda.ingest_features(raw, res, starts, W)
            assert counters() == before
    if dtype == "int16":
        stride = serve_mega.padded_stride(100, 750)
        for C in (64, 76, 77):
            stream = torch.from_numpy(_samples("int16", C, 5 * stride, seed=C)).to(dev)
            res = torch.full((C,), 0.1, device=dev)
            weights = torch.from_numpy(
                np.random.RandomState(C).randn(C * 16).astype(np.float32)).to(dev)
            if C < 77:
                got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175,
                                                         stride)
                want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175,
                                                           stride)
                assert (got - want).abs().max().item() <= 2e-6 * weights.abs().sum().item()
                stack = torch.from_numpy(np.random.RandomState(C + 1).randn(
                    serve_mega.MAX_TENANTS, C * 16).astype(np.float32)).to(dev)
                lanes = torch.tensor([5, 127, 0, 64, 5], dtype=torch.int32)
                multi = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes,
                                                                 100, 175, stride).cpu()
                for lane in (0, 5, 64, 127):
                    solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[lane], 100,
                                                              175, stride).cpu()
                    rows = (lanes == lane).nonzero().flatten()
                    assert multi[rows].numpy().tobytes() == solo[rows].numpy().tobytes()
            else:
                with pytest.raises(RuntimeError, match="launch failed"):
                    serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175,
                                                       stride)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,C,pre", [("int16", 1, 57_000), ("float32", 1, 40_000),
                                         ("float32", 2, 28_200), ("int16", 16, 2_800)])
def test_ingest_kernel_on_long_baselines(dtype, C, pre):
    """Baselines so long that one channel's does not fit two ring slots
    (the means then read it from device memory; the last case keeps it in
    the ring, in pieces of channels), each within the old kernels' reach:
    within 2e-6 of the plain version."""
    dev = _card()
    S = pre + 3000
    raw = torch.from_numpy(_samples(dtype, C, S, seed=pre)).to(dev)
    res = torch.from_numpy(_res(dtype, C)).to(dev)
    starts = torch.tensor([-9, 0, 13, 1001, 2000, S - 300, S], dtype=torch.int32, device=dev)
    got = ingest_cuda.ingest_features(raw, res, starts, _operator(dev), pre=pre)
    torch.cuda.synchronize()
    want = device_ingest.ingest_features_plain(raw, res, starts, _operator(dev), pre=pre)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 2e-6


# ---------------------------------------------------------------------------
# The generic engine (csrc/window_features_any.cuh run_tiles_any): every
# window and coefficient count but the main path's 512 / 16, at every rung
# of K1, K5 and K6; and the quantized tenant stack's K6-w8 and K6-w4.

# (epoch_size, feature_size, skip): the sizes chip_smoke.py runs, then a
# coefficient count of 1, one that is not a multiple of 16, windows under
# 128 samples, and a count past 256 (more than one tile of coefficients)
GENERIC_SIZES = [(256, 16, 175), (512, 64, 175), (333, 20, 100), (700, 32, 50), (1, 1, 0),
                 (100, 3, 7), (16, 16, 0), (600, 300, 10)]


def _operator_of(dev, n, K):
    return torch.from_numpy(dwt.cascade_matrix(8, n, K).astype(np.float32)).to(dev)


def _generic_counters():
    return (ingest_cuda.ANY_LAUNCHES, ingest_cuda.ANY_LAUNCHES_F32,
            ingest_cuda.ANY_LAUNCHES_BF16, ingest_cuda.ANY_LAUNCHES_INT8,
            ingest_cuda.ANY_LAUNCHES_INT4, ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,skip", GENERIC_SIZES)
@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_generic_ingest_matches_plain_at_every_rung(n, K, skip, dtype):
    """K1's generic engine at each rung against its plain version: f32 and
    bf16 within 2e-6, the int8/int4 quantize equal bit for bit to the
    plain quantizer on the kernel's own f32 rows; windows past the end
    give zero rows; each launch counts in its generic counter alone."""
    dev = _card()
    S = 20_000
    raw = torch.from_numpy(_samples(dtype, 3, S, seed=n + K, dc=15000)).to(dev)
    res = torch.from_numpy(_res(dtype, 3)).to(dev)
    W = _operator_of(dev, n, K)
    starts = torch.tensor([-120, 0, 7, 4999, 13_001, S - n - 40, S - 3, S], dtype=torch.int32,
                          device=dev)
    before = _generic_counters()
    f32 = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, "f32", n, K)
    torch.cuda.synchronize()
    want = device_ingest.ingest_features_plain(raw, res, starts, W, 100, skip)
    assert f32.shape == want.shape == (8, 3 * K)
    assert (f32 - want).abs().max().item() <= 2e-6
    assert (f32[-1] == 0).all()
    bf16 = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, "bf16", n, K)
    want = device_ingest.ingest_features_plain(raw, res, starts, W, 100, skip, "bf16")
    assert (bf16 - want).abs().max().item() <= 2e-6
    for precision, qmax in (("int8", 127.0), ("int4", 7.0)):
        q = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, precision, n, K)
        plain_q = decode_ingest.quantize_dequantize(f32.cpu(), K, qmax)[0]
        assert q.cpu().numpy().tobytes() == plain_q.numpy().tobytes()
    after = _generic_counters()
    f32_counter = 1 if dtype == "float32" else 0
    assert after[f32_counter] == before[f32_counter] + 1
    assert [a - b for a, b in zip(after[2:5], before[2:5])] == [1, 1, 1]
    assert after[5:] == before[5:]  # the ring's counters: no launch


def _generic_mega_inputs(dev, n, K, skip, capacity, count, seed):
    stride = serve_mega.padded_stride(100, 750)
    rng = np.random.RandomState(seed)
    windows = [(rng.randint(-3000, 3000, size=(3, 850)) + np.array([[15000], [-12000], [9000]]))
               .astype(np.int16) for _ in range(count)]
    stream = serve_mega.stage_mega_stream(windows, 3, 850, stride, capacity)
    return (torch.from_numpy(stream).to(dev), torch.from_numpy(RES).to(dev),
            _operator_of(dev, n, K), stride, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,skip", GENERIC_SIZES)
def test_generic_mega_and_k6_match_plain(n, K, skip):
    """K5's generic engine (f32, int8, int4) and K6's (f32 stack) at a
    size off the main path: f32 margins within 2e-6 * ||w||_1 of the plain
    version, int8/int4 within it of the quantized generic ingest rows
    dotted with w; K6 bit-equal per lane to K5 with that lane's weights;
    padded rows exactly 0."""
    dev = _card()
    capacity, count = 128, 77
    stream, res, W, stride, rng = _generic_mega_inputs(dev, n, K, skip, capacity, count, n + K)
    weights = torch.from_numpy(rng.randn(3 * K).astype(np.float32)).to(dev)
    tol = 2e-6 * weights.abs().sum().item()
    starts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
    for precision in ("f32", "int8", "int4"):
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, skip, stride,
                                                 precision, n, K)
        torch.cuda.synchronize()
        if precision == "f32":
            want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, skip,
                                                       stride)
        else:
            want = ingest_cuda.ingest_features(stream, res, starts, W, 100, skip, precision, n,
                                               K) @ weights
        assert (got - want).abs().max().item() <= tol
        assert (got[count:] == 0).all()
    stack = torch.from_numpy(rng.randn(serve_mega.MAX_TENANTS, 3 * K).astype(np.float32)).to(dev)
    lanes = torch.from_numpy(np.where(np.arange(capacity) < count,
                                      rng.randint(0, 128, capacity), 0).astype(np.int32))
    multi = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100, skip,
                                                     stride, n, K).cpu()
    plain = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes, 100, skip,
                                                      stride).cpu()
    l1 = stack.abs().sum(dim=1).cpu()[lanes.long()]
    assert ((multi - plain).abs() <= 2e-6 * l1).all()
    for lane in np.unique(lanes.numpy()[:count])[:6]:
        solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[int(lane)], 100, skip,
                                                  stride, "f32", n, K).cpu()
        rows = np.nonzero(lanes.numpy()[:count] == lane)[0]
        assert multi[rows].numpy().tobytes() == solo[rows].numpy().tobytes()
    assert (multi[count:] == 0).all()


def _packed_stack(dev, rng, terms, wp):
    """A random (d, 128) host mirror with a freed (zero) lane, quantized
    (quant.quantize_weight_stack), as the engine keeps it on the card:
    tenant-major packed rows and scales; and the dequantized f32 stack."""
    w = rng.randn(terms, serve_mega.MAX_TENANTS).astype(np.float32)
    w[:, 5] = 0.0
    packed_np, scales_np = quant.quantize_weight_stack(w, wp)
    packed = torch.from_numpy(np.ascontiguousarray(packed_np.T)).to(dev)
    scales = torch.from_numpy(scales_np).to(dev)
    deq = quant.dequantize_weight_stack(packed.t(), scales, wp, terms).t().contiguous()
    return packed, scales, deq


@pytest.mark.cuda
@pytest.mark.parametrize("wp", ["int8", "int4"])
@pytest.mark.parametrize("capacity,count", [(64, 1), (64, 64), (4096, 4096)])
def test_packed_k6_is_bit_equal_to_k6_on_the_dequantized_stack(wp, capacity, count):
    """K6-w8 / K6-w4 at 1, 64 and 4,096 windows: margins bit-equal to K6
    on the dequantized f32 stack (dequantized on the card), lanes cycling
    over all 128; padded rows and the freed lane exactly 0; each launch
    counted in its own counter."""
    dev = _card()
    stream, res, W, _w, stride = _mega_inputs(dev, capacity, count, (15000, -12000, 9000), 3000,
                                              seed=count)
    rng = np.random.RandomState(capacity + count)
    packed, scales, deq = _packed_stack(dev, rng, 48, wp)
    lanes = torch.from_numpy(np.where(np.arange(capacity) < count, np.arange(capacity) % 128,
                                      0).astype(np.int32))
    counter = {"int8": "MULTI_LAUNCHES_INT8", "int4": "MULTI_LAUNCHES_INT4"}[wp]
    before = getattr(serve_mega_cuda, counter)
    got = serve_mega_cuda.serve_mega_multi_packed_margins(stream, res, W, packed, scales, lanes,
                                                          100, 175, stride, wp)
    torch.cuda.synchronize()
    assert getattr(serve_mega_cuda, counter) == before + 1
    f32 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100, 175, stride)
    assert got.cpu().numpy().tobytes() == f32.cpu().numpy().tobytes()
    plain = serve_mega.serve_mega_multi_packed_margins_plain(stream, res, W, packed, scales,
                                                             lanes, 100, 175, stride, wp)
    l1 = deq.abs().sum(dim=1)[lanes.to(dev).long()]
    assert ((got - plain).abs() <= 2e-6 * l1).all()
    assert (got[count:] == 0).all() and (got[:count][lanes[:count].to(dev) == 5] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("wp", ["int8", "int4"])
@pytest.mark.parametrize("n,K,skip", GENERIC_SIZES[:4] + [(100, 3, 7)])
def test_packed_k6_at_generic_sizes(wp, n, K, skip):
    """K6-w8 / K6-w4 through the generic engine: bit-equal to the generic
    K6 on the dequantized stack (int4 needs an even term count: 3 x 3
    terms raises before any launch)."""
    dev = _card()
    capacity, count = 128, 100
    stream, res, W, stride, rng = _generic_mega_inputs(dev, n, K, skip, capacity, count, K)
    lanes = torch.from_numpy((np.arange(capacity) % 128).astype(np.int32))
    if wp == "int4" and (3 * K) % 2:
        packed = torch.zeros((128, 4), dtype=torch.uint8, device=dev)
        with pytest.raises(ValueError, match="even number of terms"):
            serve_mega_cuda.serve_mega_multi_packed_margins(
                stream, res, W, packed, torch.ones(128, device=dev), lanes, 100, skip, stride,
                wp, n, K)
        return
    packed, scales, deq = _packed_stack(dev, rng, 3 * K, wp)
    before = getattr(serve_mega_cuda, f"ANY_MULTI_LAUNCHES_{wp.upper()}")
    got = serve_mega_cuda.serve_mega_multi_packed_margins(stream, res, W, packed, scales, lanes,
                                                          100, skip, stride, wp, n, K)
    f32 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100, skip, stride,
                                                   n, K)
    torch.cuda.synchronize()
    assert getattr(serve_mega_cuda, f"ANY_MULTI_LAUNCHES_{wp.upper()}") == before + 1
    assert got.cpu().numpy().tobytes() == f32.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_packed_wrapper_checks_before_launching():
    """A bad packed shape, dtype or contiguity, or bad scales, raise
    before the launch (no counter moves)."""
    dev = _card()
    stream, res, W, _w, stride = _mega_inputs(dev, 64, 3, (0, 0, 0), 3000, seed=0)
    packed, scales, _deq = _packed_stack(dev, np.random.RandomState(0), 48, "int8")
    lanes = torch.zeros(64, dtype=torch.int32)
    call = serve_mega_cuda.serve_mega_multi_packed_margins
    before = serve_mega_cuda.MULTI_LAUNCHES_INT8 + serve_mega_cuda.MULTI_LAUNCHES_INT4
    bad = {
        "packed must be \\(128, 48\\) int8": (packed.to(torch.uint8), scales, "int8"),
        "packed must be \\(128, 24\\) uint8": (packed.to(torch.uint8), scales, "int4"),
        "packed must be contiguous": (packed.t().contiguous().t(), scales, "int8"),
        "scales must be": (packed, scales[:64], "int8"),
        "scales must be a contiguous": (packed, scales.double(), "int8"),
        "no packed stack": (packed, scales, "f32"),
        "packed is on cpu": (packed.cpu(), scales, "int8"),
    }
    for match, (p, s, wp) in bad.items():
        with pytest.raises(ValueError, match=match):
            call(stream, res, W, p, s, lanes, 100, 175, stride, wp)
    assert serve_mega_cuda.MULTI_LAUNCHES_INT8 + serve_mega_cuda.MULTI_LAUNCHES_INT4 == before


@pytest.mark.cuda
def test_oversized_row_raises_a_value_error_naming_the_sizes():
    """76 channels x 745 coefficients at a 750-sample window: the row
    does not fit a block's shared memory; each generic wrapper raises a
    ValueError naming the sizes and counts no launch. 76 x 16 at 256
    samples runs."""
    dev = _card()
    C = 76
    raw = torch.from_numpy(_samples("int16", C, 3000, seed=1)).to(dev)
    res = torch.full((C,), 0.1, device=dev)
    starts = torch.tensor([0, 1000], dtype=torch.int32, device=dev)
    before = _generic_counters()
    with pytest.raises(ValueError, match="76 channels x 745 coefficients at epoch_size 750"):
        ingest_cuda.ingest_features(raw, res, starts, _operator_of(dev, 750, 745), 100, 0,
                                    "f32", 750, 745)
    assert _generic_counters() == before
    got = ingest_cuda.ingest_features(raw, res, starts, _operator_of(dev, 256, 16), 100, 175,
                                      "f32", 256, 16)
    want = device_ingest.ingest_features_plain(raw, res, starts, _operator_of(dev, 256, 16), 100,
                                               175)
    assert (got - want).abs().max().item() <= 2e-6
    stride = 1024
    stream = torch.from_numpy(_samples("int16", C, 2 * stride, seed=2)).to(dev)
    with pytest.raises(ValueError, match="76 channels x 745 coefficients at epoch_size 750"):
        serve_mega_cuda.serve_mega_margins(stream, res, _operator_of(dev, 750, 745),
                                           torch.zeros(C * 745, device=dev), 100, 0, stride,
                                           "f32", 750, 745)


@pytest.mark.cuda
@pytest.mark.parametrize("pre,post", [(1, 511), (37, 400), (250, 1000), (2800, 300)])
def test_generic_engine_at_other_baselines_and_strides(pre, post):
    """Baselines and serve geometries off the main path's (pre 100, post
    750): K1's generic engine within 2e-6 of its plain version, K5's and
    K6's within MEGA_GATE_TOL, at a (256, 16) window that fits each
    padded stride (pre + skip + 256 <= stride)."""
    dev = _card()
    n, K = 256, 16
    stride = serve_mega.padded_stride(pre, post)
    skip = min(175, stride - pre - n)
    W = _operator_of(dev, n, K)
    raw = torch.from_numpy(_samples("int16", 3, 20_000, seed=pre, dc=12000)).to(dev)
    res = torch.from_numpy(RES).to(dev)
    starts = torch.tensor([-50, 0, 999, 17_000, 19_990, 20_000], dtype=torch.int32, device=dev)
    got = ingest_cuda.ingest_features(raw, res, starts, W, pre, skip, "f32", n, K)
    want = device_ingest.ingest_features_plain(raw, res, starts, W, pre, skip)
    assert (got - want).abs().max().item() <= 2e-6
    rng = np.random.RandomState(pre)
    windows = [_samples("int16", 3, pre + post, seed=pre + i, dc=9000) for i in range(9)]
    stream = torch.from_numpy(serve_mega.stage_mega_stream(windows, 3, pre + post, stride,
                                                           64)).to(dev)
    weights = torch.from_numpy(rng.randn(48).astype(np.float32)).to(dev)
    margins = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, pre, skip, stride,
                                                 "f32", n, K)
    plain = serve_mega.serve_mega_margins_plain(stream, res, W, weights, pre, skip, stride)
    assert (margins - plain).abs().max().item() <= serve_mega.MEGA_GATE_TOL
    stack = torch.from_numpy(rng.randn(128, 48).astype(np.float32)).to(dev)
    lanes = torch.from_numpy((np.arange(64) * 7 % 128).astype(np.int32))
    multi = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, pre, skip,
                                                     stride, n, K)
    plain = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes, pre, skip,
                                                      stride)
    assert (multi - plain).abs().max().item() <= serve_mega.MEGA_GATE_TOL
    assert (margins[9:] == 0).all() and (multi[9:] == 0).all()



# The generic engine's tiles (csrc/window_features_any.cuh run_tiles_any,
# ops/generic_plan.py): a window's row does not depend on the launch or its
# place in a tile, tiles cut short at the launch's end, and the engine's
# reach.

class _Designs:
    """While entered, every generic launch takes the plan of ``design``
    (``generic_plan.PHASE_DESIGN`` or ``RING_DESIGN``; ``None``: the one
    the plan picks), and ``seen`` gathers the design of each launch."""

    def __init__(self, design=None):
        self.design, self.seen = design, []

    def __enter__(self):
        plan_of = self.plan_of = generic_plan.generic_tile_plan

        def planned(*args):
            plan = (plan_of(*args) if self.design is None
                    else generic_plan.design_plans(*args)[self.design][0])
            self.seen.append(plan.design)
            return plan

        generic_plan.generic_tile_plan = planned
        return self

    def __exit__(self, *exc):
        generic_plan.generic_tile_plan = self.plan_of
        return False


def _planned_windows(dev, C, n, K, rows, pre=100, sample_bytes=2):
    """The windows a tile the wrappers plan for this launch on this card."""
    return generic_plan.generic_tile_plan(C, n, K, rows, *ingest_cuda.device_limits(dev), pre,
                                          sample_bytes).m


def _placed(rows, seed):
    """Where the 9 test windows sit in a launch of ``rows`` rows (spread,
    first and last included), or None for rows < 9 (one launch each)."""
    if rows < 9:
        return None
    rng = np.random.RandomState(seed + rows)
    slots = np.concatenate([[0, rows - 1], rng.choice(np.arange(1, rows - 1), 7, replace=False)])
    return rng.permutation(slots)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8"])
@pytest.mark.parametrize("n,K,skip", [(256, 16, 175), (700, 32, 50), (600, 300, 10)])
def test_generic_rows_do_not_depend_on_the_launch(n, K, skip, precision):
    """The same 9 windows at different positions in launches of 1, 9, 64,
    1,000 and 4,096 rows (other rows random windows), hence in tiles of
    different sizes and at different places in them, and in both designs
    (the 1-row and 4,096-row launches plan different ones but at (256,
    16); the 4,096-row launch also runs in each design by force): K1's
    generic rows and K5's generic margins are bit-identical across the
    launches."""
    dev = _card()
    S = 1_000_000
    raw = torch.from_numpy(_samples("int16", 3, S, seed=n + K, dc=12000)).to(dev)
    res = torch.from_numpy(RES).to(dev)
    W = _operator_of(dev, n, K)
    rng = np.random.RandomState(K)
    nine = rng.randint(-50, S - n - skip - 50, size=9).astype(np.int32)
    stride = serve_mega.padded_stride(100, 750)
    windows = [_samples("int16", 3, 850, seed=100 + i, dc=9000) for i in range(9)]
    weights = torch.from_numpy(rng.randn(3 * K).astype(np.float32)).to(dev)
    rows_by, margins_by, designs = {}, {}, {}
    launches = [(rows, None) for rows in (1, 9, 64, 1_000, 4_096)]
    launches += [(4_096, generic_plan.PHASE_DESIGN), (4_096, generic_plan.RING_DESIGN)]
    for rows, design in launches:
        key = rows if design is None else (rows, design)
        slots = _placed(rows, K)
        with _Designs(design) as planned:
            if slots is None:
                got = [ingest_cuda.ingest_features(
                    raw, res, torch.tensor([s], dtype=torch.int32, device=dev),
                    W, 100, skip, precision, n, K) for s in nine]
                rows_by[key] = torch.cat(got).cpu().numpy()
                m = []
                for win in windows:
                    stream = serve_mega.stage_mega_stream([win], 3, 850, stride, 1)
                    m.append(serve_mega_cuda.serve_mega_margins(
                        torch.from_numpy(stream).to(dev), res, W, weights, 100, skip, stride,
                        precision, n, K))
                margins_by[key] = torch.cat(m).cpu().numpy()
            else:
                starts = np.random.RandomState(rows).randint(-50, S, size=rows).astype(np.int32)
                starts[slots] = nine
                got = ingest_cuda.ingest_features(raw, res, torch.from_numpy(starts).to(dev), W,
                                                  100, skip, precision, n, K)
                rows_by[key] = got[torch.from_numpy(slots).to(dev)].cpu().numpy()
                batch = [_samples("int16", 3, 850, seed=rows + i, dc=9000) for i in range(rows)]
                for slot, win in zip(slots, windows):
                    batch[slot] = win
                stream = torch.from_numpy(serve_mega.stage_mega_stream(batch, 3, 850, stride,
                                                                       rows)).to(dev)
                margins = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, skip,
                                                             stride, precision, n, K)
                margins_by[key] = margins[torch.from_numpy(slots).to(dev)].cpu().numpy()
        designs[key] = set(planned.seen)
    # the plan runs 1 row phase by phase and 4,096 rows in the ring design,
    # but at (256, 16), where the phase-by-phase design is the faster at
    # both; the forced launches run each design there too
    assert designs[1] == {generic_plan.PHASE_DESIGN}, designs
    assert designs[4_096] == {generic_plan.PHASE_DESIGN if (n, K) == (256, 16)
                              else generic_plan.RING_DESIGN}, designs
    assert designs[(4_096, generic_plan.PHASE_DESIGN)] == {generic_plan.PHASE_DESIGN}
    assert designs[(4_096, generic_plan.RING_DESIGN)] == {generic_plan.RING_DESIGN}
    plain = device_ingest.ingest_features_plain(raw, res, torch.from_numpy(nine).to(dev), W,
                                                100, skip)
    if precision == "f32":
        assert np.abs(rows_by[1] - plain.cpu().numpy()).max() <= 2e-6
    for key in rows_by:
        assert rows_by[key].tobytes() == rows_by[1].tobytes(), key
        assert margins_by[key].tobytes() == margins_by[1].tobytes(), key


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 5, 17, 76])
def test_generic_tiles_cut_at_the_launch_end(C):
    """Row counts that are not a multiple of the planned windows a tile
    (1, M - 1, M + 1, 4,097), on 1 to 76 channels at (256, 16): K1 within
    2e-6 of its plain version, windows past the stream's end exactly 0;
    K5 within 2e-6 * ||w||_1, padded slots of the batch exactly 0."""
    dev = _card()
    n, K, skip = 256, 16, 175
    S = 60_000
    raw = torch.from_numpy(_samples("int16", C, S, seed=C, dc=9000)).to(dev)
    res = torch.full((C,), 0.1, device=dev)
    W = _operator_of(dev, n, K)
    M = _planned_windows(dev, C, n, K, 4_097)
    stride = serve_mega.padded_stride(100, 750)
    rng = np.random.RandomState(C)
    weights = torch.from_numpy(rng.randn(C * K).astype(np.float32)).to(dev)
    windows = [_samples("int16", C, 850, seed=i, dc=9000) for i in range(7)]
    for rows in sorted({1, max(1, M - 1), M + 1, 4_097}):
        starts = rng.randint(-300, S + 300, size=rows).astype(np.int32)
        starts[-1] = S  # past the end: a zero row
        st = torch.from_numpy(starts).to(dev)
        got = ingest_cuda.ingest_features(raw, res, st, W, 100, skip, "f32", n, K)
        torch.cuda.synchronize()
        want = device_ingest.ingest_features_plain(raw, res, st, W, 100, skip)
        assert (got - want).abs().max().item() <= 2e-6, rows
        assert (got[torch.from_numpy(starts >= S).to(dev)] == 0).all()
        count = max(1, rows - 2)
        batch = [windows[i % len(windows)] for i in range(count)]
        stream = torch.from_numpy(serve_mega.stage_mega_stream(batch, C, 850, stride,
                                                               rows)).to(dev)
        margins = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, skip, stride,
                                                     "f32", n, K)
        plain = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, skip, stride)
        assert (margins - plain).abs().max().item() <= 2e-6 * weights.abs().sum().item()
        assert (margins[count:] == 0).all()


@pytest.mark.cuda
def test_generic_reach_is_unchanged_at_the_widest_row():
    """76 channels x 740 coefficients at a 750-sample window, the widest
    row the one-window-a-block engine's shared memory took: K1 and K5 run
    and match their plain versions; 741 coefficients raise the ValueError
    naming the sizes, before any launch (no counter moves)."""
    dev = _card()
    C, n, skip = 76, 750, 0
    stride = 1024
    raw = torch.from_numpy(_samples("int16", C, 4 * stride, seed=3, dc=9000)).to(dev)
    res = torch.full((C,), 0.1, device=dev)
    starts = torch.tensor([-40, 0, stride + 5, 3 * stride], dtype=torch.int32, device=dev)
    W = _operator_of(dev, n, 740)
    got = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, "f32", n, 740)
    torch.cuda.synchronize()
    want = device_ingest.ingest_features_plain(raw, res, starts, W, 100, skip)
    assert (got - want).abs().max().item() <= 2e-6
    weights = torch.from_numpy(np.random.RandomState(1).randn(C * 740).astype(np.float32)).to(dev)
    margins = serve_mega_cuda.serve_mega_margins(raw, res, W, weights, 100, skip, stride, "f32",
                                                 n, 740)
    plain = serve_mega.serve_mega_margins_plain(raw, res, W, weights, 100, skip, stride)
    assert (margins - plain).abs().max().item() <= 2e-6 * weights.abs().sum().item()
    before = (_generic_counters(), serve_mega_cuda.ANY_LAUNCHES)
    W1 = _operator_of(dev, n, 741)
    with pytest.raises(ValueError, match="76 channels x 741 coefficients at epoch_size 750"):
        ingest_cuda.ingest_features(raw, res, starts, W1, 100, skip, "f32", n, 741)
    with pytest.raises(ValueError, match="76 channels x 741 coefficients at epoch_size 750"):
        serve_mega_cuda.serve_mega_margins(raw, res, W1, torch.zeros(C * 741, device=dev), 100,
                                           skip, stride, "f32", n, 741)
    assert (_generic_counters(), serve_mega_cuda.ANY_LAUNCHES) == before


@pytest.fixture
def hdfs_session(tmp_path, monkeypatch):
    """A two-recording session and a model trained on it on the card,
    served from a loopback WebHDFS namenode: (local info.txt, local
    model, namenode authority)."""
    _card()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _loopback

    for name in ("WEBHDFS_ENDPOINT", "WEBHDFS_USER", "HDFS_DRIVER"):
        monkeypatch.delenv(name, raising=False)
    info = _loopback.write_remote_session(str(tmp_path / "session"), n_markers=200)
    model = str(tmp_path / "model")
    PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"
                    f"&save_clf=true&save_name={model}").execute()
    with _loopback.Server() as srv:
        srv.store.add_tree(os.path.dirname(info), "/data")
        with open(model + ".npz", "rb") as f:
            srv.store.files["/models/model.npz"] = f.read()
        yield info, model, srv.authority


@pytest.mark.cuda
def test_fused_run_over_hdfs_equals_local(hdfs_session):
    info, _model, auth = hdfs_session
    q = "fe=dwt-8-fused&train_clf=logreg"
    local = PipelineBuilder(f"info_file={info}&{q}").execute()
    before = ingest_cuda.LAUNCHES
    builder = PipelineBuilder(f"info_file=hdfs://{auth}/data/infoTrain.txt&{q}")
    got = builder.execute()
    assert ingest_cuda.LAUNCHES - before == 2  # one launch per recording
    assert builder.features.device.type == "cuda"
    assert str(got) == str(local)


@pytest.mark.cuda
def test_served_run_over_hdfs_equals_local(hdfs_session):
    info, model, auth = hdfs_session
    load = "fe=dwt-8-fused&load_clf=logreg"
    local = PipelineBuilder(f"info_file={info}&{load}&load_name={model}").execute()
    before = serve_mega_cuda.LAUNCHES
    served = PipelineBuilder(f"info_file=hdfs://{auth}/data/infoTrain.txt&{load}&serve=true"
                             f"&load_name=hdfs://{auth}/models/model")
    got = served.execute()
    assert serve_mega_cuda.LAUNCHES > before
    assert served.serve_block["rung"] == "mega"
    assert str(got) == str(local)


# -- the serving lifecycle (adapt=) on the card ------------------------------


def _lifecycle_model(seed=3):
    from eeg_dataanalysispackage_tpu_torch.models import linear

    clf = registry.create("logreg")
    clf.model = linear.LinearModel(
        torch.from_numpy(np.random.RandomState(seed).randn(48).astype(np.float32)), 0.0)
    return clf


def _lifecycle_windows(n, seed=5):
    body = _stream([900, -700, 300], 2000, n * 850, seed)
    return [body[:, i * 850:(i + 1) * 850] for i in range(n)]


@pytest.mark.cuda
def test_engine_featurize_launches_the_ingest_kernel():
    """The lifecycle's feedback rows: one ingest-kernel launch a capacity
    slice, the rows within 2e-6 of the CPU engine's featurize."""
    from eeg_dataanalysispackage_tpu_torch.serve import ServingEngine

    _card()
    windows = _lifecycle_windows(70)
    eng = ServingEngine(_lifecycle_model(), capacity=64)
    eng.warmup()
    before = ingest_cuda.LAUNCHES
    got = eng.featurize(windows, RES)
    assert ingest_cuda.LAUNCHES - before == 2
    want = ServingEngine(_lifecycle_model(), capacity=64, device="cpu").featurize(windows, RES)
    assert got.shape == (70, 48) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 2e-6


@pytest.mark.cuda
def test_swap_on_the_card_builds_nothing_and_serves_the_new_model():
    """A hot swap copies the weights and keeps the mega program: no
    library is built, the next batch is the new model's (bit-equal to an
    engine built around it)."""
    from eeg_dataanalysispackage_tpu_torch.ops import cuda_build
    from eeg_dataanalysispackage_tpu_torch.serve import ServingEngine

    _card()
    windows = _lifecycle_windows(20)
    eng = ServingEngine(_lifecycle_model(3), capacity=64)
    eng.warmup()
    program, loaded = eng._mega_program, dict(cuda_build._LOADED)
    new = _lifecycle_model(4)
    eng.swap_model(new)
    assert eng._mega_program is program and dict(cuda_build._LOADED) == loaded
    assert eng._model.weights.device.type == "cuda"
    fresh = ServingEngine(_lifecycle_model(4), capacity=64)
    fresh.warmup()
    got, want = eng.execute(windows, RES), fresh.execute(windows, RES)
    assert got[1].tobytes() == want[1].tobytes()


@pytest.mark.cuda
def test_partial_fit_on_the_card_is_deterministic_and_matches_the_cpu():
    """The SGD chunk on the card: the same bytes on a second run (the
    resume pin's premise) and within 1e-5 of the CPU's."""
    from eeg_dataanalysispackage_tpu_torch.models import sgd

    _card()
    rng = np.random.RandomState(0)
    x = rng.randn(1024, 48).astype(np.float32)
    y = (rng.rand(1024) > 0.5).astype(np.float32)
    mask = np.zeros(1024, np.float32)
    mask[:300] = 1.0
    config = sgd.SGDConfig(reg_param=0.01, convergence_tol=0.0)
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        carry = sgd.partial_fit_carry(48, device=device)
        for t0 in (0, 20, 40):
            carry = sgd.partial_fit_linear(carry, t0, x, y, config, 20, sample_mask=mask,
                                           device=device)
        runs.append(carry[0].cpu().numpy())
    assert runs[0].tobytes() == runs[1].tobytes()
    assert np.abs(runs[0] - runs[2]).max() <= 1e-5


@pytest.mark.cuda
def test_lifecycle_service_promotes_on_the_card(tmp_path):
    """A lifecycle service on the card: feedback batches featurized by the
    ingest kernel (one launch each), a promotion under a permissive gate,
    and served margins after it equal to a fresh engine around the
    promoted model's file."""
    from eeg_dataanalysispackage_tpu_torch.serve import LifecycleConfig, ServingEngine

    _card()
    windows = _lifecycle_windows(64, seed=8)
    labels = (np.arange(64) % 2).astype(np.float64)
    ckpt = str(tmp_path / "lc")
    svc = InferenceService(_lifecycle_model(), lifecycle=LifecycleConfig(
        adapt_batch=16, adapt_iters=5, drift_window=16, gate_ratio=100.0, checkpoint_dir=ckpt,
        rollback=False))
    with svc:
        before = ingest_cuda.LAUNCHES
        for w, y in zip(windows, labels):
            svc.feedback(w, RES, float(y))
        assert svc.lifecycle.flush(timeout_s=60.0)
        assert ingest_cuda.LAUNCHES - before == 4
        block = svc.lifecycle.block()
        assert block["swaps"] >= 1 and block["feedback"]["failures"] == 0
        served = [r.margin for r in svc.predict_all(windows, RES)]
    promoted = registry.create("logreg")
    promoted.load(block["promoted_path"])
    fresh = ServingEngine(promoted, capacity=64)
    fresh.warmup()
    assert np.asarray(served, np.float32).tobytes() == fresh.execute(windows, RES)[1].tobytes()


# ---------------------------------------------------------------------------
# The megakernel's float32-sample instantiations (K5-f32s, K5-int8-f32s,
# K5-int4-f32s, K6-f32s, K6-w8-f32s, K6-w4-f32s, and their generic twins):
# a float32 stream, staged already scaled with unit resolutions, as a
# recording in another binary format than INT_16 is served.

_ONES = np.ones(3, np.float32)


def _float_mega_inputs(dev, capacity, n, dc, noise, seed):
    """:func:`_mega_inputs`' int16 windows scaled by RES into float32
    windows (at the int16 limit's DC offsets, a cancellation stress), unit
    resolutions."""
    stream, _res, W, weights, stride = _mega_inputs(dev, capacity, n, dc, noise, seed)
    scaled = (stream.to(torch.float32) * torch.from_numpy(RES).to(dev)[:, None]).contiguous()
    return scaled, torch.from_numpy(_ONES).to(dev), W, weights, stride


_COUNTER_OF = {"f32": "LAUNCHES", "int8": "LAUNCHES_INT8", "int4": "LAUNCHES_INT4"}
_ALL_MEGA_COUNTERS = [name for name in dir(serve_mega_cuda)
                      if name.isupper() and "LAUNCHES" in name]


def _f32s_counter(name, generic=False):
    return ("ANY_" if generic else "") + name + "_F32S"


def _mega_crossover(dev):
    """The float32 megakernel's tile-design crossover on this card."""
    return serve_mega_cuda.tiles_crossover(ingest_cuda.device_limits(dev)[0])


def _designs_moved(before):
    return (serve_mega_cuda.F32S_DESIGN_RING - before[0],
            serve_mega_cuda.F32S_DESIGN_TILES - before[1])


def _design_counts():
    return serve_mega_cuda.F32S_DESIGN_RING, serve_mega_cuda.F32S_DESIGN_TILES


# capacities on both sides of the tile design's crossover (1,056 windows on
# 132 multiprocessors), 4,099 not a multiple of its 4-window tiles
_F32S_CASES = [(64, 1), (64, 64), (1024, 1024), (1056, 1056), (2048, 2048), (4099, 4099),
               (4099, 4000)]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "int4"])
@pytest.mark.parametrize("capacity,n", _F32S_CASES)
@pytest.mark.parametrize("dc,noise", [((0, 0, 0), 3000), ((30000, -30000, 29500), 1500)])
def test_float_mega_kernel_matches_plain_version(precision, capacity, n, dc, noise):
    """K5-f32s / K5-int8-f32s / K5-int4-f32s: margins within 2e-6 *
    ||w||_1 of K1-f32's rows of the same windows dotted with w (and, at
    f32, of the plain version; at int8/int4 within the rung's tolerance of
    it); padded rows 0; a window's margin the same solo and in a batch;
    each launch counted in its own counter alone, and in the design it
    took: the tile design from the crossover on, run_windows below it."""
    dev = _card()
    stream, res, W, weights, stride = _float_mega_inputs(dev, capacity, n, dc, noise, seed=n)
    counter = _f32s_counter(_COUNTER_OF[precision])
    before = {name: getattr(serve_mega_cuda, name) for name in _ALL_MEGA_COUNTERS}
    designs = _design_counts()
    got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride,
                                             precision)
    torch.cuda.synchronize()
    moved = {name: getattr(serve_mega_cuda, name) - before[name] for name in before}
    assert moved == {name: int(name == counter) for name in before}
    tiles = capacity >= _mega_crossover(dev)
    assert _designs_moved(designs) == ((0, 1) if tiles else (1, 0))
    starts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
    rows = ingest_cuda.ingest_features(stream, res, starts, W, 100, 175, precision)
    tol = 2e-6 * weights.abs().sum().item()
    assert (got - rows @ weights).abs().max().item() <= tol
    plain = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175, stride,
                                                precision)
    gate = tol if precision == "f32" else decode_ingest.precision_gate_tolerance(precision)
    assert (got - plain).abs().max().item() <= gate
    assert torch.isfinite(got).all() and (got[n:] == 0).all()
    solo = torch.zeros_like(stream)
    solo[:, :stride] = stream[:, (n - 1) * stride:n * stride]
    assert serve_mega_cuda.serve_mega_margins(solo, res, W, weights, 100, 175, stride,
                                              precision)[0].item() == got[n - 1].item()


@pytest.mark.cuda
@pytest.mark.parametrize("spread", ["cycling", "one_lane"])
@pytest.mark.parametrize("capacity,n", _F32S_CASES)
def test_float_k6_matches_plain_and_equals_solo_kernel_per_lane(capacity, n, spread):
    """K6-f32s: each row within 2e-6 * ||w_lane||_1 of the plain version
    and bit-equal to K5-f32s with that lane's weights; K6-w8-f32s and
    K6-w4-f32s bit-equal to K6-f32s on the dequantized stack; padded rows
    and a freed lane exactly 0."""
    dev = _card()
    stream, res, W, _w, stride = _float_mega_inputs(dev, capacity, n, (30000, -30000, 29500),
                                                    1500, seed=n)
    stack, lanes = _stack_and_lanes(dev, capacity, n, spread, seed=capacity + n)
    before = serve_mega_cuda.MULTI_LAUNCHES_F32S
    got = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100, 175,
                                                   stride)
    torch.cuda.synchronize()
    assert serve_mega_cuda.MULTI_LAUNCHES_F32S == before + 1
    plain = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes, 100, 175,
                                                      stride)
    l1 = stack.abs().sum(dim=1)[lanes.to(dev).long()]
    assert ((got - plain).abs() <= 2e-6 * l1).all()
    for lane in np.unique(lanes.numpy()[:n])[:8]:
        solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[int(lane)], 100, 175,
                                                  stride)
        rows = torch.from_numpy(np.nonzero(lanes.numpy()[:n] == lane)[0]).to(dev)
        assert got[rows].cpu().numpy().tobytes() == solo[rows].cpu().numpy().tobytes()
    assert (got[n:] == 0).all() and (got[:n][lanes[:n].to(dev) == 5] == 0).all()
    for wp in ("int8", "int4"):
        packed, scales, deq = _packed_stack(dev, np.random.RandomState(n), 48, wp)
        counter = _f32s_counter(f"MULTI_LAUNCHES_{wp.upper()}")
        before = getattr(serve_mega_cuda, counter)
        q = serve_mega_cuda.serve_mega_multi_packed_margins(stream, res, W, packed, scales, lanes,
                                                            100, 175, stride, wp)
        torch.cuda.synchronize()
        assert getattr(serve_mega_cuda, counter) == before + 1
        k6 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100, 175,
                                                      stride)
        assert q.cpu().numpy().tobytes() == k6.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,skip", GENERIC_SIZES[:4] + [(100, 3, 7), (600, 300, 10)])
def test_float_generic_mega_and_k6_match_plain(n, K, skip):
    """The generic engine's float32-sample instantiations at sizes off the
    main path: K5-any-f32s (f32, int8, int4) within 2e-6 * ||w||_1 of the
    plain version or of K1-any-f32's quantized rows dotted with w;
    K6-any-f32s bit-equal per lane to K5-any-f32s; K6-w8/w4-any-f32s
    bit-equal to K6-any-f32s on the dequantized stack; each launch in its
    generic counter."""
    dev = _card()
    capacity, count = 128, 77
    stream, _r, W, stride, rng = _generic_mega_inputs(dev, n, K, skip, capacity, count, n + K)
    stream = (stream.to(torch.float32) * torch.from_numpy(RES).to(dev)[:, None]).contiguous()
    res = torch.from_numpy(_ONES).to(dev)
    weights = torch.from_numpy(rng.randn(3 * K).astype(np.float32)).to(dev)
    tol = 2e-6 * weights.abs().sum().item()
    starts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
    for precision in ("f32", "int8", "int4"):
        counter = _f32s_counter(_COUNTER_OF[precision], generic=True)
        before = getattr(serve_mega_cuda, counter)
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, skip, stride,
                                                 precision, n, K)
        torch.cuda.synchronize()
        assert getattr(serve_mega_cuda, counter) == before + 1
        if precision == "f32":
            want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, skip,
                                                       stride)
        else:
            want = ingest_cuda.ingest_features(stream, res, starts, W, 100, skip, precision, n,
                                               K) @ weights
        assert (got - want).abs().max().item() <= tol
        assert (got[count:] == 0).all()
    stack = torch.from_numpy(rng.randn(serve_mega.MAX_TENANTS, 3 * K).astype(np.float32)).to(dev)
    lanes = torch.from_numpy(np.where(np.arange(capacity) < count,
                                      rng.randint(0, 128, capacity), 0).astype(np.int32))
    multi = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100, skip,
                                                     stride, n, K).cpu()
    for lane in np.unique(lanes.numpy()[:count])[:6]:
        solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[int(lane)], 100, skip,
                                                  stride, "f32", n, K).cpu()
        rows = np.nonzero(lanes.numpy()[:count] == lane)[0]
        assert multi[rows].numpy().tobytes() == solo[rows].numpy().tobytes()
    if (3 * K) % 2 == 0:
        for wp in ("int8", "int4"):
            packed, scales, deq = _packed_stack(dev, rng, 3 * K, wp)
            q = serve_mega_cuda.serve_mega_multi_packed_margins(
                stream, res, W, packed, scales, lanes, 100, skip, stride, wp, n, K)
            k6 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100, skip,
                                                          stride, n, K)
            assert q.cpu().numpy().tobytes() == k6.cpu().numpy().tobytes()


# The float32-sample engine (run_tiles_float): tiles cut at any row count,
# a ragged last chunk of j, rows that do not depend on the tiling, K1's rows
# equal to the features behind K5's margins, and the engine's reach.

_QMAX = {"int8": 127.0, "int4": 7.0}
_STACK_OF = {"f32": None, "int8": "int8", "int4": "int4"}


def _float_stream(dev, C, S, seed, samples="float32"):
    """A float32 stream (int16-like samples scaled by 0.1, staged already
    scaled) and its unit resolutions; ``samples="int16"``: the int16
    samples themselves and resolutions of 0.1."""
    raw = torch.from_numpy(_samples("int16", C, S, seed=seed, dc=9000)).to(dev)
    if samples == "int16":
        return raw, torch.full((C,), 0.1, device=dev)
    return (raw.to(torch.float32) * 0.1).contiguous(), torch.ones(C, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", ["float32", "int16"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "int4"])
@pytest.mark.parametrize("n,K,skip", [(256, 16, 175), (512, 64, 175)])
def test_float_generic_tiles_cut_at_the_launch_end(n, K, skip, precision, samples):
    """Launches of 1, M - 1, M + 1 and 4,097 rows (M the planned windows a
    tile at 4,097) on float32 samples and, in the same ring design, on
    int16 ones, at each rung: K1-any within 2e-6 of its plain version (f32,
    bf16) or equal bit for bit to the plain quantizer on its own f32 rows
    (int8, int4), windows past the stream's end exactly 0; K5-any within
    2e-6 * ||w||_1 of the plain version or of the rung's rows dotted with
    w, padded slots 0; K6-any on the rung's stack (f32, w8, w4) bit-equal
    per lane to K5-any on the same (for w8 and w4, dequantized) rows of the
    stack."""
    dev = _card()
    C, S = 3, 60_000
    raw, ones = _float_stream(dev, C, S, seed=n + K, samples=samples)
    W = _operator_of(dev, n, K)
    M = _planned_windows(dev, C, n, K, 4_097, sample_bytes=raw.element_size())
    stride = serve_mega.padded_stride(100, 750)
    rng = np.random.RandomState(K)
    weights = torch.from_numpy(rng.randn(C * K).astype(np.float32)).to(dev)
    tol = 2e-6 * weights.abs().sum().item()
    for rows in sorted({1, max(1, M - 1), M + 1, 4_097}):
        starts = rng.randint(-300, S + 300, size=rows).astype(np.int32)
        starts[-1] = S  # past the end: a zero row
        st = torch.from_numpy(starts).to(dev)
        got = ingest_cuda.ingest_features(raw, ones, st, W, 100, skip, precision, n, K)
        torch.cuda.synchronize()
        if precision in _QMAX:
            f32 = ingest_cuda.ingest_features(raw, ones, st, W, 100, skip, "f32", n, K).cpu()
            want = decode_ingest.quantize_dequantize(f32, K, _QMAX[precision])[0]
            assert got.cpu().numpy().tobytes() == want.numpy().tobytes(), rows
        else:
            want = device_ingest.ingest_features_plain(raw, ones, st, W, 100, skip, precision)
            assert (got - want).abs().max().item() <= 2e-6, rows
        assert (got[torch.from_numpy(starts >= S).to(dev)] == 0).all()
        if precision == "bf16":
            continue
        count = max(1, rows - 2)
        stream, _ = _float_stream(dev, C, rows * stride, seed=rows, samples=samples)
        stream[:, count * stride:] = 0
        margins = serve_mega_cuda.serve_mega_margins(stream, ones, W, weights, 100, skip, stride,
                                                     precision, n, K)
        mstarts = torch.arange(rows, dtype=torch.int32, device=dev) * stride
        if precision == "f32":
            want = serve_mega.serve_mega_margins_plain(stream, ones, W, weights, 100, skip,
                                                       stride)
        else:
            want = ingest_cuda.ingest_features(stream, ones, mstarts, W, 100, skip, precision,
                                               n, K) @ weights
        assert (margins - want).abs().max().item() <= tol, rows
        assert (margins[count:] == 0).all()
        stack = torch.from_numpy(rng.randn(serve_mega.MAX_TENANTS, C * K).astype(np.float32)
                                 ).to(dev)
        lanes = torch.from_numpy(rng.randint(0, 128, rows).astype(np.int32))
        wp = _STACK_OF[precision]
        if wp is None:
            multi = serve_mega_cuda.serve_mega_multi_margins(stream, ones, W, stack, lanes, 100,
                                                             skip, stride, n, K).cpu()
        else:
            packed, scales, stack = _packed_stack(dev, rng, C * K, wp)
            multi = serve_mega_cuda.serve_mega_multi_packed_margins(
                stream, ones, W, packed, scales, lanes, 100, skip, stride, wp, n, K).cpu()
        for lane in np.unique(lanes.numpy())[:4]:
            solo = serve_mega_cuda.serve_mega_margins(stream, ones, W, stack[int(lane)], 100,
                                                      skip, stride, "f32", n, K).cpu()
            at = np.nonzero(lanes.numpy() == lane)[0]
            assert multi[at].numpy().tobytes() == solo[at].numpy().tobytes(), rows


def _window(samples, C, seed):
    """One 850-sample window of int16-like noise: as it is (int16), or
    scaled by 0.1 into float32."""
    x = _samples("int16", C, 850, seed=seed, dc=9000)
    return x if samples == "int16" else x.astype(np.float32) * 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("samples", ["float32", "int16"])
@pytest.mark.parametrize("n,K,skip", [(333, 20, 100), (700, 32, 50), (100, 3, 7)])
def test_float_generic_ragged_chunk_rows_do_not_depend_on_the_tiling(n, K, skip, samples):
    """A window (epoch) that is not a multiple of the 32-sample chunk: the
    same 9 windows (float32 samples, and int16 ones in the same ring
    design) launched alone, as 9 rows and inside 64 and 4,096 rows (other
    rows random windows), hence under different tile plans, and at 4,096
    rows in each design by force: K1-any's rows and K5-any's margins
    bit-identical across the launches, within 2e-6 (K1) and 2e-6 * ||w||_1
    (K5) of the plain versions."""
    dev = _card()
    C, S = 3, 1_000_000
    raw, ones = _float_stream(dev, C, S, seed=n + K, samples=samples)
    W = _operator_of(dev, n, K)
    rng = np.random.RandomState(K)
    nine = rng.randint(-50, S - n - skip - 50, size=9).astype(np.int32)
    stride = serve_mega.padded_stride(100, 750)
    windows = [_window(samples, C, 100 + i) for i in range(9)]
    weights = torch.from_numpy(rng.randn(C * K).astype(np.float32)).to(dev)
    plans, rows_by, margins_by = set(), {}, {}
    launches = [(rows, None) for rows in (1, 9, 64, 4_096)]
    launches += [(4_096, generic_plan.PHASE_DESIGN), (4_096, generic_plan.RING_DESIGN)]
    for rows, design in launches:
        if design is not None:
            with _Designs(design):
                got = ingest_cuda.ingest_features(raw, ones, torch.from_numpy(starts).to(dev), W,
                                                  100, skip, "f32", n, K)
                margins = serve_mega_cuda.serve_mega_margins(stream, ones, W, weights, 100, skip,
                                                             stride, "f32", n, K)
            rows_by[(rows, design)] = got[torch.from_numpy(slots).to(dev)].cpu().numpy()
            margins_by[(rows, design)] = margins[torch.from_numpy(slots).to(dev)].cpu().numpy()
            continue
        plans.add(generic_plan.generic_tile_plan(C, n, K, rows, *ingest_cuda.device_limits(dev),
                                                 100, raw.element_size()))
        if rows == 1:
            got = [ingest_cuda.ingest_features(raw, ones, torch.tensor([s], dtype=torch.int32,
                                                                       device=dev),
                                               W, 100, skip, "f32", n, K) for s in nine]
            rows_by[rows] = torch.cat(got).cpu().numpy()
            m = []
            for win in windows:
                stream = serve_mega.stage_mega_stream([win], C, 850, stride, 1)
                m.append(serve_mega_cuda.serve_mega_margins(
                    torch.from_numpy(stream).to(dev), ones, W, weights, 100, skip, stride,
                    "f32", n, K))
            margins_by[rows] = torch.cat(m).cpu().numpy()
            continue
        slots = _placed(rows, K) if rows > 9 else np.arange(9)
        starts = rng.randint(-50, S, size=rows).astype(np.int32)
        starts[slots] = nine
        got = ingest_cuda.ingest_features(raw, ones, torch.from_numpy(starts).to(dev), W, 100,
                                          skip, "f32", n, K)
        rows_by[rows] = got[torch.from_numpy(slots).to(dev)].cpu().numpy()
        batch = [_window(samples, C, rows + i) for i in range(rows)]
        for slot, win in zip(slots, windows):
            batch[slot] = win
        stream = torch.from_numpy(serve_mega.stage_mega_stream(batch, C, 850, stride,
                                                               rows)).to(dev)
        margins = serve_mega_cuda.serve_mega_margins(stream, ones, W, weights, 100, skip, stride,
                                                     "f32", n, K)
        margins_by[rows] = margins[torch.from_numpy(slots).to(dev)].cpu().numpy()
        if rows == 9:
            plain = serve_mega.serve_mega_margins_plain(stream, ones, W, weights, 100, skip,
                                                        stride)
            assert (margins - plain).abs().max().item() <= 2e-6 * weights.abs().sum().item()
    assert len(plans) >= 2
    plain = device_ingest.ingest_features_plain(raw, ones, torch.from_numpy(nine).to(dev), W,
                                                100, skip)
    assert np.abs(rows_by[1] - plain.cpu().numpy()).max() <= 2e-6
    for key in rows_by:
        assert rows_by[key].tobytes() == rows_by[1].tobytes(), key
        assert margins_by[key].tobytes() == margins_by[1].tobytes(), key


@pytest.mark.cuda
@pytest.mark.parametrize("samples", ["int16", "float32"])
@pytest.mark.parametrize("n,K,skip", [(256, 16, 175), (333, 20, 100), (700, 32, 50),
                                      (512, 64, 175), (100, 3, 7)])
def test_both_designs_match_plain_at_every_rung_and_stack(n, K, skip, samples):
    """Each design of the generic engine by force, on int16 and float32
    samples: K1-any on 300 windows over the stream's edges at f32 and bf16
    within 2e-6 of its plain version, int8/int4 bit-equal to the plain
    quantizer on its own f32 rows; K5-any on a capacity-128 batch of 77
    windows at f32 within 2e-6 * ||w||_1 of its plain version, int8/int4
    of the rung's rows dotted with w; K6-any on the f32 stack within 2e-6 *
    ||row||_1 of its plain version, on the w8 and w4 stacks bit-equal to K6
    on the dequantized stack; padded slots 0; every output bit-equal
    between the two designs, and each launch counted in its design's
    counter."""
    dev = _card()
    C, S = 3, 60_000
    raw, res = _float_stream(dev, C, S, seed=n + K, samples=samples)
    W = _operator_of(dev, n, K)
    rng = np.random.RandomState(n + K)
    starts = torch.from_numpy(np.concatenate(
        [rng.randint(-300, S + 300, size=296), [-150, 0, S - n - skip - 40, S]]
    ).astype(np.int32)).to(dev)
    capacity, count = 128, 77
    stride = serve_mega.padded_stride(100, 750)
    stream, _ = _float_stream(dev, C, capacity * stride, seed=K, samples=samples)
    stream[:, count * stride:] = 0
    mstarts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
    weights = torch.from_numpy(rng.randn(C * K).astype(np.float32)).to(dev)
    stack = torch.from_numpy(rng.randn(serve_mega.MAX_TENANTS, C * K).astype(np.float32)).to(dev)
    lanes = torch.from_numpy(np.where(np.arange(capacity) < count,
                                      rng.randint(0, 128, capacity), 0).astype(np.int32))
    packed = {wp: _packed_stack(dev, np.random.RandomState(K), C * K, wp)
              for wp in ("int8", "int4") if (C * K) % 2 == 0 or wp == "int8"}
    tol = 2e-6 * weights.abs().sum().item()
    outs = {}
    for design in (generic_plan.PHASE_DESIGN, generic_plan.RING_DESIGN):
        counters = (ingest_cuda.ANY_DESIGN_PHASE, ingest_cuda.ANY_DESIGN_RING,
                    serve_mega_cuda.ANY_DESIGN_PHASE, serve_mega_cuda.ANY_DESIGN_RING)
        with _Designs(design) as planned:
            f32 = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, "f32", n, K)
            torch.cuda.synchronize()
            want = device_ingest.ingest_features_plain(raw, res, starts, W, 100, skip)
            assert (f32 - want).abs().max().item() <= 2e-6 and (f32[-1] == 0).all()
            out = {"f32": f32}
            bf16 = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, "bf16", n, K)
            want = device_ingest.ingest_features_plain(raw, res, starts, W, 100, skip, "bf16")
            assert (bf16 - want).abs().max().item() <= 2e-6
            out["bf16"] = bf16
            for precision, qmax in _QMAX.items():
                q = ingest_cuda.ingest_features(raw, res, starts, W, 100, skip, precision, n, K)
                plain_q = decode_ingest.quantize_dequantize(f32.cpu(), K, qmax)[0]
                assert q.cpu().numpy().tobytes() == plain_q.numpy().tobytes()
                out[precision] = q
            for precision in ("f32", "int8", "int4"):
                got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, skip,
                                                         stride, precision, n, K)
                if precision == "f32":
                    want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100,
                                                               skip, stride)
                else:
                    want = ingest_cuda.ingest_features(stream, res, mstarts, W, 100, skip,
                                                       precision, n, K) @ weights
                assert (got - want).abs().max().item() <= tol and (got[count:] == 0).all()
                out["k5_" + precision] = got
            multi = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100,
                                                             skip, stride, n, K)
            plain = serve_mega.serve_mega_multi_margins_plain(stream, res, W, stack, lanes, 100,
                                                              skip, stride)
            l1 = stack.abs().sum(dim=1)[lanes.to(dev).long()]
            assert ((multi - plain).abs() <= 2e-6 * l1).all() and (multi[count:] == 0).all()
            out["k6_f32"] = multi
            for wp, (pk, scales, deq) in packed.items():
                got = serve_mega_cuda.serve_mega_multi_packed_margins(
                    stream, res, W, pk, scales, lanes, 100, skip, stride, wp, n, K)
                k6 = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, deq, lanes, 100,
                                                              skip, stride, n, K)
                assert got.cpu().numpy().tobytes() == k6.cpu().numpy().tobytes()
                out["k6_" + wp] = got
        assert set(planned.seen) == {design}
        after = (ingest_cuda.ANY_DESIGN_PHASE, ingest_cuda.ANY_DESIGN_RING,
                 serve_mega_cuda.ANY_DESIGN_PHASE, serve_mega_cuda.ANY_DESIGN_RING)
        grew = [a - b for a, b in zip(after, counters)]
        assert grew[1 - design] == 0 and grew[3 - design] == 0
        assert grew[design] > 0 and grew[2 + design] > 0
        outs[design] = {k: v.cpu().numpy().tobytes() for k, v in out.items()}
    assert outs[generic_plan.PHASE_DESIGN] == outs[generic_plan.RING_DESIGN]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "int4"])
@pytest.mark.parametrize("n,K,skip", [(256, 16, 175), (333, 20, 100), (512, 16, 175)])
def test_float_k1_rows_equal_the_features_behind_k5_margins(n, K, skip, precision):
    """K1-any on float32 samples equals, bit for bit, the rows K5-any-f32s
    dots with its weights: with the weights the unit vector e_i, a margin is
    feature i itself (one FMA by 1, the rest by 0), so C * K launches of K5
    give the rows of a capacity-64 batch, which K1 at the windows' starts
    must equal."""
    dev = _card()
    C, capacity = 3, 64
    stride = serve_mega.padded_stride(100, 750)
    raw, ones = _float_stream(dev, C, capacity * stride, seed=n + K)
    W = _operator_of(dev, n, K)
    starts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
    rows = ingest_cuda.ingest_features(raw, ones, starts, W, 100, skip, precision, n, K)
    features = torch.empty_like(rows)
    for i in range(C * K):
        unit = torch.zeros(C * K, device=dev)
        unit[i] = 1.0
        features[:, i] = serve_mega_cuda.serve_mega_margins(raw, ones, W, unit, 100, skip,
                                                            stride, precision, n, K)
    assert features.cpu().numpy().tobytes() == rows.cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["ring", "tiles"])
@pytest.mark.parametrize("precision", ["f32", "int8", "int4"])
def test_float_k1_rows_equal_the_features_behind_k5_margins_in_each_design(precision, design,
                                                                          monkeypatch):
    """At 512 / 16, K1-f32's rows (the ring engine) equal bit for bit the
    features behind K5-f32s margins with each megakernel design forced:
    the unit vector e_i as the weights makes a margin feature i itself, so
    48 launches give the rows of a batch of 1,001 windows (not a multiple
    of the tile design's 4)."""
    dev = _card()
    C, capacity = 3, 1001
    stride = serve_mega.padded_stride(100, 750)
    raw, ones = _float_stream(dev, C, capacity * stride, seed=7)
    W = _operator(dev)
    starts = torch.arange(capacity, dtype=torch.int32, device=dev) * stride
    rows = ingest_cuda.ingest_features(raw, ones, starts, W, 100, 175, precision)
    index = serve_mega_cuda.MEGA_DESIGNS.index(design)
    monkeypatch.setattr(serve_mega_cuda, "mega_design", lambda *a: index)
    designs = _design_counts()
    features = torch.empty_like(rows)
    for i in range(C * 16):
        unit = torch.zeros(C * 16, device=dev)
        unit[i] = 1.0
        features[:, i] = serve_mega_cuda.serve_mega_margins(raw, ones, W, unit, 100, 175, stride,
                                                            precision)
    assert features.cpu().numpy().tobytes() == rows.cpu().numpy().tobytes()
    assert _designs_moved(designs) == ((48, 0) if design == "ring" else (0, 48))


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,n", [(64, 64), (1001, 1001), (4099, 4000)])
@pytest.mark.parametrize("kernel", ["f32", "int8", "int4", "stack_f32", "stack_int8",
                                    "stack_int4"])
def test_float_mega_designs_give_the_same_margins(kernel, capacity, n, monkeypatch):
    """K5-f32s at each rung and K6-f32s on each stack: the margins of the
    same windows are the same bytes with run_windows and with the tile
    design forced, at a serve batch, at 1,001 windows and past the
    crossover with padded slots (exactly 0 in both)."""
    dev = _card()
    stream, res, W, weights, stride = _float_mega_inputs(dev, capacity, n,
                                                         (30000, -30000, 29500), 1500, seed=n)
    stack, lanes = _stack_and_lanes(dev, capacity, n, "cycling", seed=capacity)
    if kernel.startswith("stack"):
        wp = kernel.split("_")[1]
        if wp == "f32":
            def fn():
                return serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100,
                                                                175, stride)
        else:
            packed, scales, _deq = _packed_stack(dev, np.random.RandomState(n), 48, wp)

            def fn():
                return serve_mega_cuda.serve_mega_multi_packed_margins(
                    stream, res, W, packed, scales, lanes, 100, 175, stride, wp)
    else:
        def fn():
            return serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride,
                                                      kernel)
    outs = {}
    for design, index in (("ring", 0), ("tiles", 1)):
        monkeypatch.setattr(serve_mega_cuda, "mega_design", lambda *a, index=index: index)
        designs = _design_counts()
        out = fn()
        torch.cuda.synchronize()
        assert _designs_moved(designs) == ((1, 0) if design == "ring" else (0, 1))
        assert bool(torch.isfinite(out).all()) and (out[n:] == 0).all()
        outs[design] = out.cpu().numpy().tobytes()
    assert outs["ring"] == outs["tiles"]


@pytest.mark.cuda
def test_the_tile_design_refuses_what_it_cannot_reach(monkeypatch):
    """Forced on launches outside its reach (int16 samples, four channels,
    a stream off a 16-byte boundary), the tile design raises and counts no
    launch: nothing runs run_windows in its place."""
    dev = _card()
    W = _operator(dev)
    stride = serve_mega.padded_stride(100, 750)
    monkeypatch.setattr(serve_mega_cuda, "mega_design", lambda *a: 1)
    int16, res16 = _float_stream(dev, 3, 64 * stride, seed=1, samples="int16")
    four, ones4 = _float_stream(dev, 4, 64 * stride, seed=2)
    shifted = torch.zeros(3 * 64 * stride + 1, device=dev)[1:].view(3, 64 * stride)
    cases = ((int16, res16, 48), (four, ones4, 64), (shifted, torch.ones(3, device=dev), 48))
    for stream, res, terms in cases:
        before = ({name: getattr(serve_mega_cuda, name) for name in _ALL_MEGA_COUNTERS},
                  _design_counts())
        with pytest.raises(RuntimeError, match="launch failed"):
            serve_mega_cuda.serve_mega_margins(stream, res, W, torch.ones(terms, device=dev), 100,
                                               175, stride)
        assert ({name: getattr(serve_mega_cuda, name) for name in _ALL_MEGA_COUNTERS},
                _design_counts()) == before


@pytest.mark.cuda
def test_float_generic_reach_is_unchanged_at_the_widest_row():
    """76 channels x 740 coefficients of float32 samples at a 750-sample
    window, the widest row the int16 engine takes too: K1-any and
    K5-any-f32s run and match their plain versions; 741 coefficients raise
    the ValueError naming the sizes, before any launch."""
    dev = _card()
    C, n, skip = 76, 750, 0
    stride = 1024
    raw = torch.from_numpy(_samples("float32", C, 4 * stride, seed=3, dc=9000)).to(dev)
    ones = torch.ones(C, device=dev)
    starts = torch.tensor([-40, 0, stride + 5, 3 * stride], dtype=torch.int32, device=dev)
    W = _operator_of(dev, n, 740)
    got = ingest_cuda.ingest_features(raw, ones, starts, W, 100, skip, "f32", n, 740)
    torch.cuda.synchronize()
    want = device_ingest.ingest_features_plain(raw, ones, starts, W, 100, skip)
    assert (got - want).abs().max().item() <= 2e-6
    weights = torch.from_numpy(np.random.RandomState(1).randn(C * 740).astype(np.float32)).to(dev)
    margins = serve_mega_cuda.serve_mega_margins(raw, ones, W, weights, 100, skip, stride, "f32",
                                                 n, 740)
    plain = serve_mega.serve_mega_margins_plain(raw, ones, W, weights, 100, skip, stride)
    assert (margins - plain).abs().max().item() <= 2e-6 * weights.abs().sum().item()
    before = (_generic_counters(), serve_mega_cuda.ANY_LAUNCHES_F32S)
    W1 = _operator_of(dev, n, 741)
    with pytest.raises(ValueError, match="76 channels x 741 coefficients at epoch_size 750"):
        ingest_cuda.ingest_features(raw, ones, starts, W1, 100, skip, "f32", n, 741)
    with pytest.raises(ValueError, match="76 channels x 741 coefficients at epoch_size 750"):
        serve_mega_cuda.serve_mega_margins(raw, ones, W1, torch.zeros(C * 741, device=dev), 100,
                                           skip, stride, "f32", n, 741)
    assert (_generic_counters(), serve_mega_cuda.ANY_LAUNCHES_F32S) == before


@pytest.mark.cuda
def test_float_mega_on_the_widest_montage_and_one_channel_more_is_refused():
    """76 channels of float32 samples at 512 / 16 (a float ring slot holds
    half the samples of an int16 one, so the pieces differ): K5-f32s
    within 2e-6 * ||w||_1 of the plain version, K6-f32s bit-equal per
    lane to K5-f32s; 77 channels raise and count no launch."""
    dev = _card()
    W = _operator(dev)
    stride = serve_mega.padded_stride(100, 750)
    for C in (64, 76, 77):
        stream = torch.from_numpy(_samples("float32", C, 5 * stride, seed=C, dc=15000)).to(dev)
        res = torch.ones(C, device=dev)
        weights = torch.from_numpy(np.random.RandomState(C).randn(C * 16).astype(np.float32)
                                   ).to(dev)
        before = serve_mega_cuda.LAUNCHES_F32S
        if C == 77:
            with pytest.raises(RuntimeError, match="launch failed"):
                serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
            assert serve_mega_cuda.LAUNCHES_F32S == before
            continue
        got = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, stride)
        want = serve_mega.serve_mega_margins_plain(stream, res, W, weights, 100, 175, stride)
        assert (got - want).abs().max().item() <= 2e-6 * weights.abs().sum().item()
        stack = torch.from_numpy(np.random.RandomState(C + 1).randn(
            serve_mega.MAX_TENANTS, C * 16).astype(np.float32)).to(dev)
        lanes = torch.tensor([5, 127, 0, 64, 5], dtype=torch.int32)
        multi = serve_mega_cuda.serve_mega_multi_margins(stream, res, W, stack, lanes, 100, 175,
                                                         stride).cpu()
        for lane in (0, 5, 64, 127):
            solo = serve_mega_cuda.serve_mega_margins(stream, res, W, stack[lane], 100, 175,
                                                      stride).cpu()
            rows = (lanes == lane).nonzero().flatten()
            assert multi[rows].numpy().tobytes() == solo[rows].numpy().tobytes()


def _float_session(directory):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _torch_sessions import write_coded_recording

    lines = [write_coded_recording(directory, "flt_0", "IEEE_FLOAT_32", 200, 4, seed=1),
             write_coded_recording(directory, "i32_1", "INT_32", 150, 7, seed=2)]
    info = os.path.join(directory, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8", "int4"])
def test_float_session_serves_through_the_float_megakernel(tmp_path, precision):
    """serve=true on an IEEE_FLOAT_32 + INT_32 session on the card: the
    statistics of the card's batch load_clf= run and of the CPU's serve
    run, the requests served by K5-f32s at the precision (at least one
    launch a batch)."""
    _card()
    info = _float_session(str(tmp_path))
    q = f"info_file={info}&fe=dwt-8-fused"
    PipelineBuilder(f"{q}&train_clf=logreg&save_clf=true&save_name={tmp_path}/m").execute()
    load = f"{q}&load_clf=logreg&load_name={tmp_path}/m&precision={precision}"
    batch = PipelineBuilder(load).execute()
    counter = _f32s_counter(_COUNTER_OF[precision])
    before = getattr(serve_mega_cuda, counter)
    served = PipelineBuilder(f"{load}&serve=true")
    got = served.execute()
    assert getattr(serve_mega_cuda, counter) - before >= served.serve_block["batches"] >= 1
    assert served.serve_block["rung"] == "mega"
    cpu = PipelineBuilder(f"{load}&serve=true", device="cpu").execute()
    assert str(got) == str(batch) == str(cpu)


@pytest.mark.cuda
def test_host_extractor_service_launches_the_epoch_kernel_once_a_batch():
    """InferenceService(host_extractor=dwt-8-pallas) on the card: the host
    rung, one epoch-features launch a batch, predictions equal to the
    same service on the CPU."""
    from eeg_dataanalysispackage_tpu_torch.features import registry as fe_registry

    _card()
    clf = _random_linear(7)
    rng = np.random.RandomState(4)
    windows = [rng.randint(-3000, 3000, size=(3, 850)).astype(np.int16) for _ in range(100)]
    config = ServeConfig(max_batch=64)
    with InferenceService(clf, config=config,
                          host_extractor=fe_registry.create("dwt-8-pallas")) as svc:
        assert (svc.engine.rung, svc.engine.mode) == ("host", "host-extractor")
        before = dwt_cuda.LAUNCHES
        served = svc.predict_all(windows, RES)
        launches = dwt_cuda.LAUNCHES - before
        assert launches == svc.stats_block()["batches"] >= 2
    with InferenceService(clf, config=config, device="cpu",
                          host_extractor=fe_registry.create("dwt-8-pallas", device="cpu")) as cpu:
        want = cpu.predict_all(windows, RES)
    assert [r.prediction for r in served] == [r.prediction for r in want]


# -- threefry streams and the neural network on the card --------------------


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1])
def test_threefry_draws_on_the_card_equal_the_cpu(seed):
    """Integer threefry on the card: bits, uniforms, Bernoulli draws and
    the SGD mini-batch masks bit-equal to the CPU's."""
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.utils import threefry

    dev = _card()
    key = threefry.fold_in(threefry.prng_key(seed), 2**32 - 1)
    for shape in ((), (7,), (3, 5), (2135,), (1494, 64)):
        bits = threefry.random_bits(key, shape, dev)
        assert bits.device.type == "cuda"
        assert torch.equal(bits.cpu(), threefry.random_bits(key, shape))
        for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (-0.9544997, 0.9544997)):
            got = threefry.uniform(key, shape, lo, hi, dev).cpu().numpy()
            assert got.tobytes() == threefry.uniform(key, shape, lo, hi).numpy().tobytes()
        assert torch.equal(threefry.bernoulli(key, 0.7, shape, dev).cpu(),
                           threefry.bernoulli(key, 0.7, shape))
    p = torch.rand(50, 9, generator=torch.Generator().manual_seed(seed))
    assert torch.equal(threefry.bernoulli(key, p.to(dev)).cpu(), threefry.bernoulli(key, p))
    config = sgd.SGDConfig(mini_batch_fraction=0.5, seed=seed)
    for t in (1, 2, 100):
        assert torch.equal(sgd.mini_batch_mask(config, t, 2135, dev).cpu(),
                           sgd.mini_batch_mask(config, t, 2135, "cpu"))


def _nn_config(updater, algo="stochastic_gradient_descent"):
    cfg = {"config_seed": "3", "config_num_iterations": "20", "config_learning_rate": "0.05",
           "config_momentum": "0.9", "config_weight_init": "xavier",
           "config_updater": updater, "config_optimization_algo": algo,
           "config_pretrain": "true", "config_backprop": "true",
           "config_loss_function": "xent"}
    for i, (ltype, n, act, drop) in enumerate((("auto_encoder", 16, "sigmoid", "0.2"),
                                               ("graves_lstm", 8, "tanh", "0.0"),
                                               ("output", 2, "softmax", "0.0")), start=1):
        cfg.update({f"config_layer{i}_layer_type": ltype, f"config_layer{i}_n_out": str(n),
                    f"config_layer{i}_drop_out": drop,
                    f"config_layer{i}_activation_function": act})
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("updater,algo", [
    ("sgd", "stochastic_gradient_descent"), ("nesterovs", "stochastic_gradient_descent"),
    ("adam", "stochastic_gradient_descent"), ("adagrad", "stochastic_gradient_descent"),
    ("rmsprop", "stochastic_gradient_descent"), ("sgd", "conjugate_gradient"),
])
def test_nn_fit_on_the_card_matches_the_cpu(updater, algo):
    """One fit of each updater (and CG) on the card, with denoising
    pretraining, dropout and an LSTM: the parameters live on the card and
    the predictions lie within 1e-4 of the CPU fit's."""
    _card()
    rng = np.random.RandomState(0)
    x = rng.randn(300, 48).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    preds = {}
    for device in ("cuda", "cpu"):
        clf = registry.create("nn")
        clf.set_config(_nn_config(updater, algo))
        feats = torch.from_numpy(x).to(device)
        clf.fit(feats, torch.from_numpy(y).to(device))
        assert next(clf.net.parameters()).device.type == torch.device(device).type
        preds[device] = clf.predict(feats).cpu().numpy()
    assert preds["cuda"].dtype == np.float64 and np.isfinite(preds["cuda"]).all()
    assert np.abs(preds["cuda"] - preds["cpu"]).max() <= 1e-4


@pytest.mark.cuda
def test_nn_service_on_the_card_equals_the_nn_batch_run(tmp_path):
    """train_clf=nn on the card (fused features, K1), then load_clf=nn and
    serve=true&load_clf=nn on the card: the served statistics equal the
    batch load run's, the served predictions equal the batch
    classifier's, K1 launches, the megakernel does not."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=200)
    cfg = "&".join(f"{k}={v}" for k, v in _nn_config("adam").items())
    model = str(tmp_path / "model.nn")
    PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=nn&{cfg}"
                    f"&save_clf=true&save_name={model}").execute()
    base = f"info_file={info}&fe=dwt-8-fused&load_clf=nn&load_name={model}"
    batch = PipelineBuilder(base)
    want = str(batch.execute())
    ingest_before, mega_before = ingest_cuda.LAUNCHES, serve_mega_cuda.LAUNCHES
    served = PipelineBuilder(base + "&serve=true")
    assert str(served.execute()) == want
    block = served.serve_block
    assert (block["mode"], block["rung"], block["mega"]) == ("featurize+host", "fused", None)
    assert ingest_cuda.LAUNCHES - ingest_before >= block["batches"] >= 1
    assert serve_mega_cuda.LAUNCHES == mega_before
    from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.serve import engine as engine_mod

    provider = OfflineDataProvider([info], device="cpu")
    balance = BalanceState()
    windows, res = [], None
    for _rel, guessed, rec in provider.iter_recordings():
        ws, _ts, res = engine_mod.windows_from_recording(
            rec, provider.channel_indices_for(rec), guessed, balance=balance)
        windows.extend(ws)
    # the batch run's loaded classifier, on the card, served
    with InferenceService(batch.classifier) as svc:
        got = np.array([r.prediction for r in svc.predict_all(windows, res)])
    np.testing.assert_array_equal(got, batch.classifier.predict(batch.features).cpu().numpy())


# -- the tree families ---------------------------------------------------------------


def _tree_data(n=1494, d=48, seed=0):
    """L2-normalized float32 rows (the fused path's features) and labels."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d)
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    y = ((x[:, 0] + x[:, 5] + 0.2 * rng.randn(n)) > 0).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _same_tree(a, b, i=0, j=0):
    fa, fb = int(a["feature"][i]), int(b["feature"][j])
    if fa < 0 or fb < 0:
        return fa < 0 and fb < 0 and a["prediction"][i] == b["prediction"][j]
    return (fa == fb and a["threshold_bin"][i] == b["threshold_bin"][j]
            and _same_tree(a, b, a["left"][i], b["left"][j])
            and _same_tree(a, b, a["right"][i], b["right"][j]))


@pytest.mark.cuda
@pytest.mark.parametrize("impurity", ["gini", "entropy"])
def test_dt_tpu_on_the_card_equals_the_host_dt(impurity):
    """The device grower on the card grows the host dt grower's tree
    (split for split, leaf for leaf) from the same rows, and predicts on
    the card as the host tree does."""
    dev = _card()
    x, y = _tree_data()
    config = {"config_max_bins": "32", "config_impurity": impurity, "config_max_depth": "5",
              "config_min_instances_per_node": "1"}
    card, host = registry.create("dt-tpu"), registry.create("dt")
    for clf in (card, host):
        clf.set_config(config)
    card.fit(x.to(dev), y.to(dev))
    host.fit(x, y)
    assert _same_tree(card.trees[0], host.trees[0])
    got = card.predict(x.to(dev))
    assert got.device.type == dev.type and got.dtype == torch.float64
    np.testing.assert_array_equal(got.cpu().numpy(), host.predict(x).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rf-tpu", "gbt-tpu"])
def test_device_growers_on_the_card_equal_the_cpu(name):
    """rf-tpu (100 trees, sqrt subsets) and gbt-tpu (100 rounds) at the
    defaults: the card's tree arrays equal the CPU's (the impurities and
    gains are IEEE operations both devices share; gbt-tpu's float64
    histogram sums round to the same float32 values)."""
    dev = _card()
    x, y = _tree_data(seed=1)
    card, cpu = registry.create(name), registry.create(name)
    card.fit(x.to(dev), y.to(dev))
    cpu.fit(x, y)
    assert len(card.trees) == len(cpu.trees) == 100
    for a, b in zip(card.trees, cpu.trees):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(card.predict(x.to(dev)).cpu().numpy(),
                                  cpu.predict(x).numpy())


@pytest.mark.cuda
def test_argmax_ties_on_the_card_take_the_first_index():
    """Rows of exactly equal maxima (and of -inf) pick the first index on
    the card, as on the CPU: the growers' tie-break."""
    dev = _card()
    rng = np.random.RandomState(0)
    scores = np.full((512, 48 * 31), -np.inf, np.float32)
    for r in range(512):
        k = rng.randint(1, 40)
        at = np.sort(rng.choice(scores.shape[1], size=k, replace=False))
        scores[r, at] = np.float32(0.125)
    scores[::7] = -np.inf
    t = torch.from_numpy(scores)
    got = torch.argmax(t.to(dev), dim=1).cpu()
    want = torch.from_numpy(np.argmax(scores, axis=1))
    assert torch.equal(got, want) and torch.equal(torch.argmax(t, dim=1), want)
    from eeg_dataanalysispackage_tpu_torch.models import trees_device
    x = np.repeat(np.arange(4.0), 10)[:, None]
    binned = np.concatenate([x, x, x], axis=1).astype(np.int64)  # identical columns
    y = torch.from_numpy((x[:, 0] >= 2).astype(np.int64))[None]
    mask = torch.ones((1, 3, 3), dtype=torch.bool)
    for device in (dev, torch.device("cpu")):
        heap = trees_device._grow_one(
            torch.from_numpy(binned)[None].to(device), y.to(device), mask.to(device),
            max_bins=4, impurity="gini", max_depth=2, min_instances=1)
        assert int(heap["feature"][0, 0]) == 0 and int(heap["threshold_bin"][0, 0]) == 1


@pytest.mark.cuda
def test_served_rf_on_the_card_equals_the_batch_run(tmp_path):
    """train_clf=rf on the card's fused features, then serve=true&load_clf=rf:
    mode featurize+host on the fused rung, no megakernel, statistics equal
    to the batch load run's."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=300)
    model = str(tmp_path / "rf")
    PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=rf&save_clf=true"
                    f"&save_name={model}").execute()
    base = f"info_file={info}&fe=dwt-8-fused&load_clf=rf&load_name={model}"
    want = str(PipelineBuilder(base).execute())
    mega_before = serve_mega_cuda.LAUNCHES
    served = PipelineBuilder(base + "&serve=true")
    assert str(served.execute()) == want
    block = served.serve_block
    assert (block["mode"], block["rung"], block["mega"]) == ("featurize+host", "fused", None)
    assert serve_mega_cuda.LAUNCHES == mega_before


# -- the training surface: populations, elastic, line searches ----------------


def _population_data(n=400, d=48, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return x, y


@pytest.mark.cuda
@pytest.mark.parametrize("frac,multi_fold", [(1.0, False), (0.5, False), (0.5, True)])
def test_batched_linear_engine_on_the_card_equals_looped(frac, multi_fold):
    """The batched engine on CUDA tensors at the default early stop, for
    logistic and hinge members: each member stops after as many updates
    as the looped step function on the card (and the batched engine on
    the CPU), and its weights lie within 1e-6 of theirs. A hinge member
    may differ beyond that only where a row's activity (y m < 1) differs
    at the final weights, a decision roundoff can move: those rows are
    counted and printed."""
    import dataclasses

    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import population as engines

    dev = _card()
    x, y = _population_data()
    masks = (np.random.RandomState(1).rand(4, len(y)) > 0.3).astype(np.float32) \
        if multi_fold else None
    steps, regs, seeds = [1.0, 0.5, 1.0, 0.25], [0.0, 0.01, 0.01, 0.0], [42, 43, 44, 45]
    xs, ys = torch.from_numpy(x), torch.from_numpy(y)
    y_signed = 2.0 * y.astype(np.float64) - 1.0
    flipped = []
    for loss in ("logistic", "hinge"):
        config = sgd.SGDConfig(num_iterations=200, mini_batch_fraction=frac, loss=loss)
        args = (config, steps, regs, seeds, masks)
        got = engines.train_linear_population(xs.to(dev), ys.to(dev), *args)
        assert got[0].device.type == "cuda"
        looped_w = engines.train_linear_population_looped(xs.to(dev), ys.to(dev), *args)
        looped = []
        for i in range(len(seeds)):
            cfg = dataclasses.replace(config, step_size=steps[i], reg_param=regs[i],
                                      seed=seeds[i])
            looped.append(sgd.partial_fit_linear(
                sgd.partial_fit_carry(x.shape[1], device=dev), 0, xs, ys, cfg, 200,
                sample_mask=None if masks is None else masks[i], device=dev))
        assert torch.equal(looped_w, torch.stack([c[0] for c in looped]))
        on_cpu = engines.train_linear_population(xs, ys, *args)
        for i in range(len(seeds)):
            rows = np.ones(len(y), bool) if masks is None else masks[i] > 0
            w_got = got[0][i].double().cpu().numpy()
            for name, (w, n_updates) in (("looped", (looped[i][0], looped[i][2])),
                                         ("cpu", (on_cpu[0][i], on_cpu[2][i]))):
                assert int(got[2][i]) == int(n_updates), (loss, i, name)
                w = w.double().cpu().numpy()
                if np.abs(w_got - w).max() <= 1e-6:
                    continue
                active = [(y_signed * (x.astype(np.float64) @ v) < 1.0) & rows
                          for v in (w_got, w)]
                differ = np.nonzero(active[0] != active[1])[0]
                assert loss == "hinge" and len(differ), (loss, i, name)
                flipped += [(i, name, int(r)) for r in differ]
    print(f"frac {frac}, multi-fold {multi_fold}: {len(flipped)} rows of differing hinge "
          f"activity {flipped}")


@pytest.mark.cuda
def test_member_masks_on_the_card_equal_mini_batch_mask():
    from eeg_dataanalysispackage_tpu_torch.models import sgd

    dev = _card()
    seeds, ts = torch.tensor([42, 43, 7, 2**31 - 1]), torch.arange(1, 70)
    got = sgd.mini_batch_masks(seeds.to(dev), ts.to(dev), 2135, 0.5)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), sgd.mini_batch_masks(seeds, ts, 2135, 0.5))
    for i in (0, 33, 68):
        for j, seed in enumerate(seeds.tolist()):
            config = sgd.SGDConfig(mini_batch_fraction=0.5, seed=seed)
            assert torch.equal(got[i, j], sgd.mini_batch_mask(config, i + 1, 2135, dev))


@pytest.mark.cuda
def test_batched_linear_engine_reads_back_only_at_its_polls():
    """No host read-back per iteration: the synchronizing calls of a run
    do not grow with its iterations without the early stop, and grow by
    its polls alone with it (torch's sync debug mode counts them)."""
    import warnings

    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import population as engines

    dev = _card()
    x, y = _population_data()
    xs, ys = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    def syncs(iterations, tol, frac=1.0):
        config = sgd.SGDConfig(num_iterations=iterations, convergence_tol=tol,
                               mini_batch_fraction=frac)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                engines.train_linear_population(xs, ys, config, [1.0, 0.5], [0.0, 0.01],
                                                [1, 2], None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum(1 for w in caught if "synchroniz" in str(w.message))

    syncs(10, 1e-12, 0.5)  # the first call's one-time initializations
    for frac in (1.0, 0.5):
        assert syncs(100, 0.0, frac) == syncs(1000, 0.0, frac)
    polls = (1000 - 1) // engines.POLL_EVERY - (100 - 1) // engines.POLL_EVERY
    assert syncs(1000, 1e-12) - syncs(100, 1e-12) == polls


@pytest.mark.cuda
def test_nn_population_on_the_card_equals_looped():
    """The vmapped network engine on the card (dropout on): each member's
    predictions within 1e-5 of its own fit on the card."""
    dev = _card()
    x, y = _population_data(n=300)
    cfg = _nn_config("nesterovs", "stochastic_gradient_descent")
    cfg.update(config_pretrain="false")
    clf = registry.create("nn")
    clf.set_config(cfg)
    feats, labels = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    nets = clf.population_fit(feats, labels, [1, 2], [0.01, 0.005])
    for net, (seed, lr) in zip(nets, [(1, 0.01), (2, 0.005)]):
        assert next(net.parameters()).device.type == "cuda"
        single = registry.create("nn")
        single.set_config(dict(cfg, config_seed=str(seed), config_learning_rate=str(lr)))
        single.fit(feats, labels)
        clf.net = net
        assert (clf.predict(feats) - single.predict(feats)).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["lbfgs", "line_gradient_descent"])
def test_line_search_fit_on_the_card_matches_the_cpu(algo, tmp_path):
    """The optimizer alone on real rows: 20 updates of an 8-unit network
    on a synthetic session's feature rows, the same rows on the card and
    on the CPU. The card takes the CPU's line-search steps at every update
    and predicts within 1e-4 of it."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    from eeg_dataanalysispackage_tpu_torch.utils import java_compat

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=300)
    rows = PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=logreg", device="cpu")
    rows.execute()
    train, _test = java_compat.train_test_split_indices(len(rows.targets), seed=1)
    x = rows.features[torch.as_tensor(train)]
    y = torch.as_tensor(rows.targets)[torch.as_tensor(train)].float()
    cfg = {"config_seed": "1", "config_num_iterations": "20", "config_learning_rate": "0.1",
           "config_momentum": "0.9", "config_weight_init": "xavier",
           "config_updater": "nesterovs", "config_optimization_algo": algo,
           "config_pretrain": "false", "config_backprop": "true",
           "config_loss_function": "xent"}
    for i, (ltype, n, act) in enumerate((("dense", 8, "relu"), ("output", 2, "softmax")), 1):
        cfg.update({f"config_layer{i}_layer_type": ltype, f"config_layer{i}_n_out": str(n),
                    f"config_layer{i}_drop_out": "0.0",
                    f"config_layer{i}_activation_function": act})
    preds, history = {}, {}
    for device in ("cuda", "cpu"):
        clf = registry.create("nn")
        clf.set_config(cfg)
        clf.fit(x.to(device), y.to(device))
        preds[device] = clf.predict(rows.features.to(device)).cpu().numpy()
        history[device] = [steps for steps, _ in clf.linesearch_history]
    assert len(history["cuda"]) == 20 and history["cuda"] == history["cpu"]
    assert np.abs(preds["cuda"] - preds["cpu"]).max() <= 1e-4


@pytest.mark.cuda
def test_probe_devices_on_the_card():
    from eeg_dataanalysispackage_tpu_torch.obs import failure

    _card()
    probe = failure.probe_devices()
    assert probe.all_healthy
    assert [d.type for d in probe.healthy] == ["cuda"] * torch.cuda.device_count()


# -- the seizure workload on the card ------------------------------------------


@pytest.fixture(scope="module")
def seizure_session(tmp_path_factory):
    import _synthetic

    return _synthetic.write_seizure_session(
        str(tmp_path_factory.mktemp("cuda_seizure")), n_files=2, n_samples=40000)


@pytest.mark.cuda
@pytest.mark.parametrize("multi_fold", [False, True])
def test_stacked_features_engine_on_the_card_equals_looped(multi_fold):
    """The fe_sweep= engine (a (P, n, d) stack, one matrix per member) on
    CUDA tensors: each member stops after as many updates as its looped
    twin on the card, weights within 1e-6 of it and of the CPU's."""
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import population as engines

    dev = _card()
    x0, y = _population_data()
    x1, _ = _population_data(seed=1)
    xs = torch.from_numpy(np.stack([x0, x1, x0, x1]))
    ys = torch.from_numpy(y)
    masks = (np.random.RandomState(1).rand(4, len(y)) > 0.3).astype(np.float32) \
        if multi_fold else None
    config = sgd.SGDConfig(num_iterations=200)
    args = (config, [1.0, 1.0, 0.5, 0.5], [0.01] * 4, [42] * 4, masks)
    kw = dict(weight_pos=[1.0, 8.0, 1.0, 8.0])
    got = engines.train_linear_population(xs.to(dev), ys.to(dev), *args, **kw)
    assert got[0].device.type == "cuda"
    looped = engines.train_linear_population_looped(xs.to(dev), ys.to(dev), *args, **kw)
    on_cpu = engines.train_linear_population(xs, ys, *args, **kw)
    assert torch.equal(got[2].cpu(), on_cpu[2])
    for other in (looped, on_cpu[0]):
        assert (got[0].cpu().double() - other.cpu().double()).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_seizure_pallas_rows_on_the_card_match_the_plain_version(seizure_session):
    """task=seizure&fe=dwt-8-pallas at 768-sample windows: one
    epoch-features launch over the run's windows, rows within 2e-6 of
    the plain version's on the same float32 windows, the statistics the
    CPU run's under the near-threshold rule."""
    q = (f"info_file={seizure_session}&task=seizure&fe=dwt-8-pallas&window=768"
         "&stride=384&train_clf=logreg")
    _card()
    before = dwt_cuda.LAUNCHES
    gpu = PipelineBuilder(q)
    gpu.execute()
    assert dwt_cuda.LAUNCHES - before == 1
    assert gpu.features.device.type == "cuda"
    epochs = torch.from_numpy(np.ascontiguousarray(gpu.batch.epochs, dtype=np.float32))
    plain = dwt.epoch_features(epochs, 8, 175, 512, 16)
    assert (gpu.features.cpu() - plain).abs().max().item() <= 2e-6
    cpu = PipelineBuilder(q, device="cpu")
    cpu.execute()
    a, b = gpu.statistics, cpu.statistics
    if str(a) != str(b):
        rows = torch.as_tensor(np.asarray(cpu.test_index, np.int64))
        margins = cpu.classifier.margin(cpu.features[rows]).double().numpy()
        assert np.abs(margins).min() < 1e-4, (str(a), str(b))


@pytest.mark.cuda
def test_seizure_serving_launches_the_epoch_kernel_once_a_batch(seizure_session, tmp_path):
    """task=seizure&serve=true with fe=dwt-8-pallas on the card: the host
    rung, one epoch-features launch a batch (and the warmup's), the
    statistics the card's batch load_clf= run's."""
    base = (f"info_file={seizure_session}&task=seizure&fe=dwt-8-pallas&window=768"
            "&stride=384")
    _card()
    model = str(tmp_path / "model")
    PipelineBuilder(f"{base}&train_clf=logreg&save_clf=true&save_name={model}").execute()
    batch = PipelineBuilder(f"{base}&load_clf=logreg&load_name={model}").execute()
    before = dwt_cuda.LAUNCHES
    served = PipelineBuilder(f"{base}&load_clf=logreg&load_name={model}&serve=true")
    got = served.execute()
    block = served.serve_block
    assert (block["rung"], block["mode"]) == ("host", "host-extractor")
    assert dwt_cuda.LAUNCHES - before == block["batches"] + 1  # + the warmup's window
    assert str(got) == str(batch)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 31])
def test_epoch_kernel_at_seizure_serve_batch_shapes(seizure_session, n):
    """The epoch-features kernel on a seizure serve batch's shape, (n, 3,
    768) sliding windows of the session (64 a full batch, 31 a last
    one), within 2e-6 of the plain version on the same float32 windows."""
    from eeg_dataanalysispackage_tpu_torch.epochs.sliding import SlidingConfig
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    dev = _card()
    batch = OfflineDataProvider([seizure_session], device="cpu").load_sliding(
        SlidingConfig(window=768, stride=384))
    x = torch.from_numpy(np.ascontiguousarray(batch.epochs[-n:], dtype=np.float32)).to(dev)
    got = dwt_cuda.epoch_features_cuda(x, 8, 175, 512, 16)
    assert got.shape == (n, 48)
    assert (got - dwt.epoch_features(x, 8, 175, 512, 16)).abs().max().item() <= 2e-6


@pytest.fixture()
def feature_cache_dir(tmp_path, monkeypatch):
    """The feature cache on, in a fresh directory."""
    monkeypatch.delenv("EEG_TPU_NO_FEATURE_CACHE", raising=False)
    monkeypatch.setenv("EEG_TPU_FEATURE_CACHE_DIR", str(tmp_path / "feature-cache"))
    return tmp_path / "feature-cache"


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_cache_hit_on_the_card_stays_there_and_launches_no_kernel(tmp_path, feature_cache_dir,
                                                                  precision):
    """A fused run twice into a fresh cache: the miss launches the ingest
    kernel, the hit launches none (no gate either), returns the miss's
    rows on the card in float32 and the miss's statistics; cache=false
    launches again."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=200)
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&precision={precision}"
    counter = "LAUNCHES" if precision == "f32" else "LAUNCHES_INT8"
    before = getattr(ingest_cuda, counter)
    miss = PipelineBuilder(q)
    miss.execute()
    assert getattr(ingest_cuda, counter) > before
    before_hit = (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_INT8)
    hit = PipelineBuilder(q)
    hit.execute()
    assert (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_INT8) == before_hit
    assert hit.backend_resolved["landed"] == "cache"
    assert hit.features.device.type == "cuda" and hit.features.dtype == torch.float32
    assert torch.equal(hit.features, miss.features)
    assert str(hit.statistics) == str(miss.statistics)
    PipelineBuilder(q + "&cache=false").execute()
    assert getattr(ingest_cuda, counter) > before_hit[0 if precision == "f32" else 1]


@pytest.mark.cuda
def test_seizure_cache_hit_launches_no_epoch_kernel(seizure_session, feature_cache_dir):
    q = (f"info_file={seizure_session}&task=seizure&fe=dwt-8-pallas&window=768"
         "&stride=384&train_clf=logreg")
    _card()
    before = dwt_cuda.LAUNCHES
    miss = PipelineBuilder(q)
    miss.execute()
    assert dwt_cuda.LAUNCHES - before == 1
    hit = PipelineBuilder(q)
    hit.execute()
    assert dwt_cuda.LAUNCHES - before == 1
    assert hit.features.device.type == "cuda" and torch.equal(hit.features, miss.features)
    assert str(hit.statistics) == str(miss.statistics)


@pytest.mark.cuda
def test_trace_path_holds_the_ingest_kernel(tmp_path):
    """trace_path= on the card: the Chrome trace holds the ingest kernel's
    device record and the run's stages."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=200)
    PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"
                    f"&trace_path={tmp_path / 'trace'}&report={tmp_path / 'report'}").execute()
    (trace,) = glob.glob(str(tmp_path / "trace" / "torch-trace-*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("ingest_features_kernel" in name for name in kernels), sorted(set(kernels))[:20]
    assert "stage.train" in {e.get("name") for e in events}


# -- the input pipeline: the parse pool, overlapped staging, the native stage


@pytest.fixture(scope="module")
def pipeline_session(tmp_path_factory):
    """Four recordings: overlap is about recording K+1 against K."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    d = tmp_path_factory.mktemp("input_pipeline")
    lines = []
    for i in range(4):
        _synthetic.write_recording(str(d), name=f"ip_{i}", n_markers=300, guessed=2 + i,
                                   seed=40 + i)
        lines.append(f"ip_{i}.eeg {2 + i}")
    (d / "info.txt").write_text("\n".join(lines) + "\n")
    return str(d / "info.txt")


@pytest.mark.cuda
@pytest.mark.parametrize("device", ["cuda", "cuda:0"])
def test_overlap_features_on_the_card_equal_serial_over_20_repeats(pipeline_session, device):
    """A wrong lifetime (a pinned buffer reused before its copy ran, a
    producer-stream tensor handed out again before the consumer read it)
    gives wrong rows only sometimes: 20 overlapped runs at depths 1, 2
    and 5, every one bit-equal to the serial run, K1 once a recording."""
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    _card()
    want, want_t = OfflineDataProvider([pipeline_session], device=device,
                                       workers=1).load_features_device(overlap=False)
    for i in range(20):
        before = ingest_cuda.LAUNCHES
        odp = OfflineDataProvider([pipeline_session], device=device, workers=4,
                                  prefetch_depth=(1, 2, 5)[i % 3])
        got, got_t = odp.load_features_device(overlap=True)
        assert ingest_cuda.LAUNCHES - before == 4
        assert got.device.type == "cuda" and torch.equal(got, want), i
        assert np.array_equal(got_t, want_t)
        assert "wall" in odp.timings


@pytest.mark.cuda
def test_overlap_launches_the_ingest_kernel_on_a_stream_of_its_own(pipeline_session, tmp_path):
    """Under overlap=true the profiler's trace shows every K1 record on a
    stream other than the consumer's (where the rows are concatenated),
    and the recordings' samples reach the card from pinned memory."""
    from torch.profiler import ProfilerActivity, profile

    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    _card()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        OfflineDataProvider([pipeline_session]).load_features_device(overlap=True)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "ingest_features_kernel" in e["name"]]
    assert len(k1) == 4
    consumer = {e["args"]["stream"] for e in kernels if "CatArray" in e["name"]}
    k1_streams = {e["args"]["stream"] for e in k1}
    assert consumer and not (k1_streams & consumer), (k1_streams, consumer)
    copies = [e["name"] for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
    assert sum("Pinned" in name for name in copies) >= 4, copies


@pytest.mark.cuda
def test_stage_raw_equals_a_pageable_copy_behind_a_busy_stream(pipeline_session):
    """Pinned, non-blocking staging behind a stream kept busy: each
    recording's staged tensor (and its zeroed padding) equals a plain
    pageable copy, so no pinned block was handed out again before its
    copy ran."""
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    dev = _card()
    odp = OfflineDataProvider([pipeline_session], device="cpu", workers=1)
    recs = [rec for _rel, _g, rec in odp.iter_recordings()]
    indices = [odp.channel_indices_for(rec) for rec in recs]
    staged = []
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the stream's time ahead of every copy
    for _ in range(3):
        for rec, idx in zip(recs, indices):
            staged.append(device_ingest.stage_raw(rec, idx, dev))
    torch.cuda.synchronize()
    for k, (raw, res, n) in enumerate(staged):
        rec, idx = recs[k % 4], indices[k % 4]
        want = torch.from_numpy(rec.raw_int16(idx))
        assert torch.equal(raw[:, :n].cpu(), want)
        assert not raw[:, n:].any()
        assert torch.equal(res.cpu(), torch.from_numpy(rec.resolutions(idx)))
        cpu_raw, _r, _n = device_ingest.stage_raw(rec, idx, torch.device("cpu"))
        assert torch.equal(raw.cpu(), cpu_raw)


@pytest.mark.cuda
def test_the_native_epoch_stage_equals_numpy_on_the_cards_host(pipeline_session, monkeypatch):
    """The host fe=dwt-8-pallas run through the native epoch stage and
    through the numpy paths (EEG_TPU_NATIVE=0): epochs bit-equal,
    statistics byte-equal, the epoch-features kernel once each."""
    from eeg_dataanalysispackage_tpu_torch.io import native

    _card()
    assert native.available()
    q = f"info_file={pipeline_session}&fe=dwt-8-pallas&train_clf=logreg"
    before = dwt_cuda.LAUNCHES
    nat = PipelineBuilder(q)
    nat_stats = str(nat.execute())
    assert dwt_cuda.LAUNCHES - before >= 1
    monkeypatch.setenv("EEG_TPU_NATIVE", "0")
    before = dwt_cuda.LAUNCHES
    plain = PipelineBuilder(q)
    assert str(plain.execute()) == nat_stats
    assert dwt_cuda.LAUNCHES - before >= 1
    assert np.array_equal(nat.batch.epochs, plain.batch.epochs)
    assert np.array_equal(nat.batch.targets, plain.batch.targets)


@pytest.mark.cuda
@pytest.mark.parametrize("pinned", [False, True])
def test_prefetch_stages_through_pinned_memory_and_hands_over_an_event(pinned):
    """The built-in stage from numpy and from an already pinned source:
    the consumer's stream waits on the producer's event, so a consumer
    kernel reading the tensor at once sees the staged values, with the
    producer's stream held busy before each copy."""
    from eeg_dataanalysispackage_tpu_torch.io import staging

    dev = _card()
    rng = np.random.RandomState(5)
    arrays = [rng.randn(1 << 20).astype(np.float32) for _ in range(6)]

    def source():
        for a in arrays:
            torch.cuda._sleep(50_000_000)  # on the producer's stream
            yield (torch.from_numpy(a).pin_memory() if pinned else a,)

    sums = []
    for (t,) in staging.prefetch(source(), device=dev, buffer_size=2):
        assert t.device.type == "cuda"
        sums.append(t.double().sum())  # the consumer's stream, no sync first
    torch.cuda.synchronize()
    for s, a in zip(sums, arrays, strict=True):
        assert s.item() == torch.from_numpy(a).double().sum().item()


# -- single-process meshes (devices=, mesh_axes=) and the raw-stream trainers ---------


def _mesh4():
    """Four shards: four distinct cards where there are four, else the
    first card four times (streams of their own, one device)."""
    from eeg_dataanalysispackage_tpu_torch.parallel import mesh as pmesh

    _card()
    n = torch.cuda.device_count()
    return [torch.device("cuda", i if n >= 4 else 0) for i in range(4)], pmesh


@pytest.mark.cuda
def test_devices_one_through_the_builder_equals_the_unmeshed_run(pipeline_session):
    _card()
    q = f"info_file={pipeline_session}&fe=dwt-8-fused&train_clf=logreg&cv=2&cache=false"
    plain = PipelineBuilder(q).execute()
    b = PipelineBuilder(q + "&devices=1")
    assert str(b.execute()) == str(plain)
    assert b.mesh_resolved["rung"] == "mesh" and b.population_block["mode"] == "sharded"
    with pytest.raises(ValueError, match="present"):
        PipelineBuilder(q + f"&devices={torch.cuda.device_count() + 1}").execute()
    from eeg_dataanalysispackage_tpu_torch.parallel import distributed

    with pytest.raises(distributed.PodBootstrapError, match="no coordinator address"):
        PipelineBuilder(q + "&processes=2").execute()


@pytest.mark.cuda
def test_sharded_fused_ingest_on_the_card_equals_the_unsharded_kernel(pipeline_session):
    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider

    shards, pmesh = _mesh4()
    mesh = pmesh.make_mesh(devices=shards, axes=("time",))
    ref, ref_t = OfflineDataProvider([pipeline_session]).load_features_device()
    cpu, _ = OfflineDataProvider([pipeline_session], device="cpu").load_features_device()
    before = ingest_cuda.LAUNCHES
    got, got_t = OfflineDataProvider([pipeline_session]).load_features_device(mesh=mesh)
    assert ingest_cuda.LAUNCHES - before == 4 * 4  # a launch a shard and recording
    assert np.array_equal(got_t, ref_t)
    assert (got - ref).abs().max().item() <= 2e-6
    assert (got.cpu() - cpu).abs().max().item() <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("members", [4, 11])
def test_sharded_population_on_the_card_equals_the_unsharded_engine(members):
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import population as engines

    shards, pmesh = _mesh4()
    rng = np.random.RandomState(members)
    x = torch.from_numpy(rng.randn(300, 48).astype(np.float32)).cuda()
    y = torch.from_numpy((rng.rand(300) > 0.5).astype(np.float32)).cuda()
    cfg = sgd.SGDConfig(num_iterations=100, convergence_tol=0.0)
    steps = [1.0 / (1 + i % 3) for i in range(members)]
    regs = [0.01 * (i % 2) for i in range(members)]
    seeds = list(range(members))
    got = engines.train_linear_population_sharded(x, y, cfg, steps, regs, seeds, None,
                                                  pmesh.make_mesh(devices=shards))
    want, _, _ = engines.train_linear_population(x, y, cfg, steps, regs, seeds, None)
    assert got.shape == (members, 48) and got.device == want.device
    assert (got - want).abs().max().item() <= 5e-6


@pytest.mark.cuda
def test_grow_forest_sharded_on_the_card_is_bit_equal():
    from eeg_dataanalysispackage_tpu_torch.models import trees_device as td

    shards, pmesh = _mesh4()
    rng = np.random.RandomState(0)
    binned = torch.from_numpy(rng.randint(0, 16, size=(400, 6))).cuda()
    labels = torch.from_numpy((rng.rand(400) > 0.5).astype(np.int64)).cuda()
    boot = torch.from_numpy(rng.randint(0, 400, size=(11, 400))).cuda()
    masks = torch.from_numpy(td.draw_feature_masks(11, td.n_heap_nodes(3), 6, 3)).cuda()
    kw = dict(max_bins=16, impurity="entropy", max_depth=4, min_instances=1)
    got = td.grow_forest_sharded(binned, labels, boot, masks, mesh=pmesh.make_mesh(devices=shards),
                                 **kw)
    want = td.grow_forest(binned, labels, boot, masks, **kw)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
def test_data_parallel_sgd_and_prefetch_on_the_card():
    from eeg_dataanalysispackage_tpu_torch.io import staging
    from eeg_dataanalysispackage_tpu_torch.models import sgd

    shards, pmesh = _mesh4()
    mesh = pmesh.make_mesh(devices=shards)
    rng = np.random.RandomState(1)
    x = rng.randn(203, 16).astype(np.float32)
    y = (x @ rng.randn(16) > 0).astype(np.float32)
    cfg = sgd.SGDConfig(num_iterations=40)
    w = sgd.train_linear(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(), cfg, mesh=mesh)
    w1 = sgd.train_linear(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda(), cfg)
    assert (w.to(w1.device) - w1).abs().max().item() <= 2e-5
    batches = [(rng.randn(n, 3).astype(np.float32),) for n in (10, 7)]
    for (a,), (xs, mask) in zip(batches, staging.prefetch(iter(batches), mesh=mesh)):
        assert [s.device.type for s in xs.shards] == ["cuda"] * 4
        assert torch.equal(xs.gather().cpu()[: len(a)], torch.from_numpy(a))
        assert float(mask.sum()) == len(a)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["raw_bank", "bank128", "bank128_bf16"])
def test_raw_stream_trainers_launch_the_kernel_and_follow_the_cpu(mode):
    """K2's two call sites on the card: one launch a step (K1, or K2-bf16
    at ``bank128_bf16``), 10 steps' losses within 1e-5 of the CPU run's
    from the same weights."""
    from eeg_dataanalysispackage_tpu_torch.parallel import train as ptrain

    _card()
    rng = np.random.RandomState(2)
    n, stride, first = 256, 800, 150
    S = first + n * stride + 1024
    raw = rng.randint(-3000, 3000, size=(3, S)).astype(np.int16)
    labels = rng.randint(0, 2, size=n).astype(np.float32)
    positions = np.sort(rng.choice(np.arange(200, S - 900), size=n, replace=False))
    params = {k: v.numpy() for k, v in ptrain.init_mlp_params(0, device="cpu").items()}

    def make(device):
        if mode == "raw_bank":
            init, step = ptrain.make_raw_train_step(stride, n, formulation="bank", device=device)
            return init, step, (RES, labels, np.ones(n, np.float32), first)
        init, step = ptrain.make_irregular_bank_train_step(positions, mode=mode, device=device)
        return init, step, (RES, labels)

    losses = {}
    for device in ("cuda", "cpu"):
        init, step, args = make(device)
        state = init(params)
        before = (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_BF16)
        out = []
        for _ in range(10):
            state, loss = step(state, torch.from_numpy(raw).to(device), *args)
            out.append(float(loss))
        launched = (ingest_cuda.LAUNCHES - before[0], ingest_cuda.LAUNCHES_BF16 - before[1])
        if device == "cuda":
            assert launched == ((0, 10) if mode == "bank128_bf16" else (10, 0))
        else:
            assert launched == (0, 0)
        losses[device] = out
    assert np.max(np.abs(np.array(losses["cuda"]) - np.array(losses["cpu"]))) <= 1e-5


# -- multi-process runs and the streaming front end ------------------------------


def _pod_session(directory, n_files=4, n_markers=200):
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    lines = []
    for i in range(n_files):
        _synthetic.write_recording(str(directory), name=f"pod_{i}", n_markers=n_markers,
                                   guessed=2 + i, seed=60 + i)
        lines.append(f"pod_{i}.eeg {2 + i}")
    (directory / "info.txt").write_text("\n".join(lines) + "\n")
    return str(directory / "info.txt")


@pytest.mark.cuda
def test_hybrid_mesh_on_the_card_covers_the_visible_cards():
    from eeg_dataanalysispackage_tpu_torch.parallel import distributed

    _card()
    n = torch.cuda.device_count()
    mesh = distributed.hybrid_mesh()
    assert mesh.shape == {"hosts": 1, "data": n}
    assert mesh.local_devices == [torch.device("cuda", i) for i in range(n)]
    with pytest.raises(ValueError, match="local devices"):
        distributed.hybrid_mesh(ici_shape=(n + 1,))


@pytest.mark.cuda
def test_a_two_rank_pod_on_the_card_equals_the_one_process_run(tmp_path, monkeypatch):
    """processes=2 through spawn_pod_member on the card: each rank launches
    K1 once per recording it owns, its exchanged matrix is the one-process
    card run's rows bit for bit, and its statistics are that run's."""
    import hashlib

    from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
    from eeg_dataanalysispackage_tpu_torch.parallel import distributed, pod

    _card()
    info = _pod_session(tmp_path)
    q = (f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&cv=2&sweep=lr:1.0,0.5"
         "&cache=false")
    plain = PipelineBuilder(q).execute()
    rows, _ = OfflineDataProvider([info]).load_features_device()
    rows_sha = hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = distributed.free_port_pair()
    procs = [pod.spawn_pod_member(q, f"127.0.0.1:{port}", 2, r, timeout_s="120")
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, o in enumerate(outs):
        assert o["statistics"] == str(plain)
        assert o["features_sha256"] == rows_sha
        assert o["k1"] == 2 == o["metrics"]["pod.recordings_owned"]
        assert o["mesh"]["rung"] == "pod" and o["mesh"]["process_id"] == pid
        assert o["mesh"]["backend"] == "gloo"  # both ranks see every card


def _two_card_ranks(params_path):
    """The two ranks of tests/_torch_distributed_worker.py on the card."""
    from eeg_dataanalysispackage_tpu_torch.parallel import distributed

    here = os.path.dirname(os.path.abspath(__file__))
    port = distributed.free_port_pair()
    procs = []
    for pid in range(2):
        env = dict(os.environ, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(pid), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(here, "_torch_distributed_worker.py"), params_path,
             "cuda"], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


@pytest.mark.cuda
def test_the_two_process_worker_on_the_card_is_one_process_over_four_shards(tmp_path):
    """Two ranks x two shards of the card: the train step, data-parallel
    SGD, the member-sharded population, the streaming extractor and the
    sharded ingest (halos across the process boundary) give the bits one
    process gives over four shards of the card."""
    from eeg_dataanalysispackage_tpu_torch.models import sgd
    from eeg_dataanalysispackage_tpu_torch.parallel import (
        mesh as pmesh, population, sharded_ingest, streaming, train as ptrain,
    )

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_distributed_worker as worker

    _card()
    params = {k: v.numpy() for k, v in ptrain.init_mlp_params(0, device="cpu").items()}
    path = str(tmp_path / "params.npz")
    np.savez(path, **params)
    outs = _two_card_ranks(path)

    def arr(h, shape):
        return np.frombuffer(bytes.fromhex(h), dtype=np.float32).reshape(shape)

    epochs, labels, sig, raw, markers, x, y = worker.cases()
    four = [torch.device("cuda", 0)] * 4
    mesh4 = pmesh.make_mesh(devices=four)
    tmesh4 = pmesh.make_mesh(devices=four, axes=("time",))
    init, step = ptrain.make_train_step(mesh4)
    _, loss = step(init(params), epochs, labels, np.ones(4, np.float32))
    feats = streaming.make_streaming_extractor(tmesh4)(sig)
    T = raw.shape[1]
    plan = sharded_ingest.plan_sharded_ingest(markers, 2, T, 4, T // 4)
    rows = sharded_ingest.make_sharded_ingest(tmesh4)(raw, np.full(3, 0.1, np.float32), plan)
    xs, ys = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    steps, regs, seeds = worker.population_args()
    pop = population.train_linear_population_sharded(
        xs, ys, sgd.SGDConfig(num_iterations=200, convergence_tol=0.0), steps, regs, seeds,
        None, mesh4)
    for o in outs:
        assert o["backend"] == "gloo" and o["mesh"] == {"hosts": 2, "data": 2}
        assert o["grad"] == [26.0, 30.0, 34.0] and o["total"] == 90.0
        np.testing.assert_array_equal(arr(o["loss"], (1,)), loss.reshape(1).cpu().numpy())
        np.testing.assert_array_equal(arr(o["stream"], (8, 32)), feats.cpu().numpy())
        np.testing.assert_array_equal(arr(o["ingest"], (3, 48)), rows.cpu().numpy())
        np.testing.assert_array_equal(arr(o["population"], (worker.POP_MEMBERS, 16)),
                                      pop.cpu().numpy())
        for name, cfg in worker.SGD_CONFIGS.items():
            w = sgd.train_linear(xs, ys, sgd.SGDConfig(**cfg), mesh=mesh4)
            np.testing.assert_array_equal(arr(o["sgd"][name], (16,)), w.cpu().numpy())


@pytest.mark.cuda
def test_streaming_on_the_card_follows_the_cpu():
    """The time-sharded extractor on four shards of the card, at 64
    channels, and the blocked iterator: within 2e-5 of the CPU."""
    from eeg_dataanalysispackage_tpu_torch.parallel import streaming

    shards, pmesh = _mesh4()
    rng = np.random.RandomState(7)
    raw = (rng.randn(64, 4 * 4096) * 500).astype(np.int16)
    res = np.full(64, 0.1, np.float32)
    tmesh = pmesh.make_mesh(devices=shards, axes=("time",))
    got = streaming.make_streaming_extractor(tmesh, resolutions=res)(
        streaming.stage_recording(raw, tmesh, dtype=torch.int16))
    assert got.is_cuda and got.shape == (4 * 4096 // 256, 64 * 16)
    cpu_mesh = pmesh.make_mesh(4, axes=("time",), device="cpu")
    want = streaming.make_streaming_extractor(cpu_mesh, resolutions=res)(raw)
    assert (got.cpu() - want).abs().max().item() <= 2e-5
    card = streaming.blocked_features(raw, block=2048, resolutions=res)
    host = streaming.blocked_features(raw, block=2048, resolutions=res, device="cpu")
    assert np.abs(card - host).max() <= 2e-5


# -- the plan executor on the card


@pytest.mark.cuda
def test_two_concurrent_fused_plans_on_the_card_equal_solo(tmp_path):
    """Two fused plans through ``PlanExecutor(max_concurrent=2)`` on the
    card, at once: each one's statistics byte-equal to its solo run on the
    card, and K1 launched once a recording a plan (``dedup=false``: each
    plan runs its own ingest)."""
    from eeg_dataanalysispackage_tpu_torch.scheduler import PlanExecutor

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=200)
    n_files = sum(1 for line in open(info) if line.strip())
    queries = [f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&config_step_size={s}"
               "&config_num_iterations=40&config_mini_batch_fraction=1.0&dedup=false"
               for s in ("1.0", "0.5")]
    solo = [str(PipelineBuilder(q).execute()) for q in queries]
    before = ingest_cuda.LAUNCHES
    with PlanExecutor(max_concurrent=2, journal_dir=str(tmp_path / "journal")) as ex:
        handles = [ex.submit(q) for q in queries]
        results = [h.result(timeout=300) for h in handles]
    assert ingest_cuda.LAUNCHES - before == 2 * n_files
    assert [str(r.statistics) for r in results] == solo
    assert all(r.builder.device.type == "cuda" and r.attempts == 1 for r in results)


@pytest.mark.cuda
def test_a_dedup_pair_on_the_card_launches_k1_once(tmp_path):
    """A logreg and an svm plan over one session through the executor on
    the card: K1 runs once a recording for the pair, the follower fits on
    the leader's card tensor, both statistics byte-equal to solo."""
    from eeg_dataanalysispackage_tpu_torch.scheduler import PlanExecutor, dedup

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    _card()
    info = _synthetic.write_session(str(tmp_path), n_markers=200)
    n_files = sum(1 for line in open(info) if line.strip())
    base = (f"info_file={info}&fe=dwt-8-fused&config_num_iterations=40"
            "&config_mini_batch_fraction=1.0&config_step_size=1.0&cache=false")
    queries = [base + "&train_clf=logreg", base + "&train_clf=svm&config_reg_param=0.1"]
    solo = [str(PipelineBuilder(q + "&dedup=false").execute()) for q in queries]
    dedup.reset()
    before = ingest_cuda.LAUNCHES
    with PlanExecutor(max_concurrent=2) as ex:
        results = [h.result(timeout=300) for h in [ex.submit(q) for q in queries]]
    assert ingest_cuda.LAUNCHES - before == n_files
    assert [str(r.statistics) for r in results] == solo
    roles = sorted(r.builder.dedup_resolved["role"] for r in results)
    assert roles == ["follower", "leader"]
    assert results[0].builder.features is results[1].builder.features
    assert results[0].builder.features.device.type == "cuda"
    dedup.reset()


@pytest.mark.cuda
def test_plan_executor_takes_the_card_by_default():
    """``PlanExecutor()`` (``device=None``) runs on the card, and raises on
    a host without one: nothing falls back to the CPU."""
    from eeg_dataanalysispackage_tpu_torch.scheduler import PlanExecutor

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            PlanExecutor()
        return
    ex = PlanExecutor()
    try:
        assert ex.device == torch.device("cuda")
    finally:
        ex.close()


@pytest.mark.cuda
def test_save_memory_profile_writes_the_allocators_snapshot(tmp_path):
    """On the card ``obs.save_memory_profile`` pickles
    ``torch.cuda.memory_snapshot()``: the live block of a held tensor is
    in one of its segments."""
    import pickle

    from eeg_dataanalysispackage_tpu_torch import obs

    dev = _card()
    held = torch.ones(1 << 20, device=dev)
    path = tmp_path / "prof" / "mem.pkl"
    assert obs.save_memory_profile(str(path)) is True
    with open(path, "rb") as f:
        segments = pickle.load(f)
    blocks = [b for s in segments for b in s["blocks"] if b["state"] == "active_allocated"]
    assert any(b["size"] >= held.numel() * 4 for b in blocks)
    assert {"device", "address", "total_size", "blocks"} <= set(segments[0])
