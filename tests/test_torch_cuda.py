"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither JAX nor the JAX package, so it
runs on a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance 2e-6 on features: a kernel and its plain version compute the
same float32 arithmetic and differ only in summation order (the
baseline mean, summed exactly in float64 by both, agrees bit for bit).
On margins, 2e-6 * ||w||_1: the margin error a 2e-6 feature error can
make.
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu_torch.ops import (
    device_ingest, dwt, ingest_cuda, serve_mega, serve_mega_cuda,
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
