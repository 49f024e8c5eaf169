"""The CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card (a CUDA kernel has no CPU mode) and skip
without one. The file imports neither JAX nor the JAX package, so it
runs on a machine with only the port installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance 2e-6: the kernel and its plain version compute the same
float32 arithmetic and differ only in summation order (the baseline
mean, summed exactly in float64 by both, agrees bit for bit).
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, dwt, ingest_cuda

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
