"""The fused ingest and serve megakernel functions on wide montages and
long baselines, on the CPU against the JAX package.

The kernels take every channel count and baseline length the
one-window-per-block kernels before them took: up to 76 channels of int16
or float32 samples at the 100-sample baseline (a 64-channel 10-20
montage, say), and baselines of tens of thousands of samples at one or two
channels. On the card they are held against their plain versions there
(``tests/test_torch_cuda.py``); here the plain versions, which the
wrappers run for CPU tensors, are held against the JAX package's decode
``slice`` rung and its serve megakernel's XLA lowering, at 1e-6 on
features (only summation orders differ) and the megakernel gate's
tolerance on margins, as at three channels (tests/test_torch_ingest.py,
tests/test_torch_serve_mega.py).
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.ops import decode_ingest as jax_decode_ingest
from eeg_dataanalysispackage_tpu.ops import serve_mega as jax_serve_mega
from eeg_dataanalysispackage_tpu_torch.ops import (
    dwt, dwt_cuda, ingest_cuda, serve_mega, serve_mega_cuda,
)


def _montage(C, S, seed):
    """(C, S) int16 with per-channel DC offsets as large as those of the
    three-channel fixture (tests/test_torch_ingest.py), where the JAX
    package's float32 baseline mean stays within 1e-6, and resolutions
    0.1 or 0.2."""
    rng = np.random.RandomState(seed)
    dc = rng.randint(-2200, 2200, size=(C, 1))
    raw = np.clip(rng.randint(-3000, 3000, size=(C, S)) + dc, -32768, 32767).astype(np.int16)
    res = np.where(rng.rand(C) < 0.5, 0.1, 0.2).astype(np.float32)
    return raw, res


def _operator():
    return dwt.cascade_matrix(8, 512, 16).astype(np.float32)


def _padded(positions, capacity):
    pos = np.zeros(capacity, np.int32)
    pos[:len(positions)] = positions
    mask = np.zeros(capacity, bool)
    mask[:len(positions)] = True
    return pos, mask


def _jax_rows(raw, res, positions, pre):
    pos, mask = _padded(positions, 64)
    featurize = jax_decode_ingest.make_decode_ingest_featurizer(formulation="slice", pre=pre)
    return np.asarray(featurize(raw, res, pos, mask))[:len(positions)]


@pytest.mark.parametrize("C", [1, 2, 5, 8, 16, 23, 32, 45, 64, 76])
def test_plain_ingest_matches_jax_on_wide_montages(C):
    S = 6000
    raw, res = _montage(C, S, seed=C)
    positions = np.array([100, 101, 777, 2048, 4100, S - 686, S - 1, S + 100])
    pos, mask = _padded(positions, 64)
    got = ingest_cuda.make_cuda_ingest_featurizer()(
        torch.from_numpy(raw), torch.from_numpy(res), pos, mask).numpy()
    want = _jax_rows(raw, res, positions, 100)
    assert got.shape == (64, C * 16)
    np.testing.assert_allclose(got[:len(positions)], want, rtol=0, atol=1e-6)
    assert not got[len(positions):].any()


@pytest.mark.parametrize("C", [1, 32, 45, 76])
def test_plain_ingest_on_a_float32_montage_equals_the_int16_one(C):
    """A float32 recording is staged already scaled, with unit
    resolutions: its rows equal the int16 stream's within 1e-6."""
    raw, res = _montage(C, 5000, seed=C + 1)
    scaled = torch.from_numpy(raw.astype(np.float32) * res[:, None])
    starts = torch.tensor([-40, 0, 3, 1999, 4000, 4999, 5000], dtype=torch.int32)
    got = ingest_cuda.ingest_features(scaled, torch.ones(C), starts,
                                      torch.from_numpy(_operator()))
    want = ingest_cuda.ingest_features(torch.from_numpy(raw), torch.from_numpy(res), starts,
                                       torch.from_numpy(_operator()))
    assert got.shape == (7, C * 16)
    assert (got - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("C,pre", [(1, 57_000), (1, 20_000), (2, 28_200), (2, 3_000),
                                   (16, 2_800), (16, 1_000)])
def test_plain_ingest_matches_jax_on_long_baselines(C, pre):
    S = pre + 3000
    raw, res = _montage(C, S, seed=pre)
    positions = np.array([pre, pre + 5, pre + 1001, S - 686, S])
    pos, mask = _padded(positions, 64)
    got = ingest_cuda.make_cuda_ingest_featurizer(pre=pre)(
        torch.from_numpy(raw), torch.from_numpy(res), pos, mask).numpy()
    want = _jax_rows(raw, res, positions, pre)
    np.testing.assert_allclose(got[:len(positions)], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("C", [2, 16, 45, 64, 76])
def test_plain_mega_margins_match_jax_on_wide_montages(C):
    pre, post, capacity = 100, 750, 64
    rng = np.random.RandomState(C)
    windows = [np.clip(rng.randint(-3000, 3000, size=(C, pre + post))
                       + rng.randint(-2200, 2200, size=(C, 1)), -32768, 32767).astype(np.int16)
               for _ in range(5)]
    res = np.where(rng.rand(C) < 0.5, 0.1, 0.2).astype(np.float32)
    weights = rng.randn(C * 16).astype(np.float32)
    stride = serve_mega.padded_stride(pre, post)
    stream = serve_mega.stage_mega_stream(windows, C, pre + post, stride, capacity)
    got = serve_mega_cuda.serve_mega_margins(torch.from_numpy(stream), torch.from_numpy(res),
                                             torch.from_numpy(_operator()),
                                             torch.from_numpy(weights), pre, 175,
                                             stride).numpy()
    import jax

    program = jax_serve_mega.make_serve_mega_program(
        n_channels=C, pre=pre, post=post, capacity=capacity, lowering="xla", donate=False)
    jstream = jax_serve_mega.stage_mega_stream(windows, C, pre + post, stride, capacity)
    want = np.asarray(program(jax.device_put(jstream), res, weights))
    assert got.shape == want.shape == (capacity,)
    assert np.max(np.abs(got[:5] - want[:5])) <= jax_serve_mega.MEGA_GATE_TOL
    assert not got[5:].any()


def test_cpu_tensors_run_the_plain_versions_at_any_channel_count():
    """200 channels, more than any kernel launch takes: on CPU tensors the
    wrappers run the plain versions and launch nothing."""
    C = 200
    raw, res = _montage(C, 2000, seed=0)
    W = torch.from_numpy(_operator())
    counters = (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32, serve_mega_cuda.LAUNCHES,
                dwt_cuda.LAUNCHES)
    rows = ingest_cuda.ingest_features(torch.from_numpy(raw), torch.from_numpy(res),
                                       torch.tensor([0, 900], dtype=torch.int32), W)
    assert rows.shape == (2, C * 16) and torch.isfinite(rows).all()
    stride = serve_mega.padded_stride(100, 750)
    stream = torch.zeros((C, 2 * stride), dtype=torch.int16)
    margins = serve_mega_cuda.serve_mega_margins(stream, torch.from_numpy(res), W,
                                                 torch.ones(C * 16), 100, 175, stride)
    assert margins.shape == (2,) and (margins == 0).all()
    assert counters == (ingest_cuda.LAUNCHES, ingest_cuda.LAUNCHES_F32,
                        serve_mega_cuda.LAUNCHES, dwt_cuda.LAUNCHES)
