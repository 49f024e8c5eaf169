"""The fused ingest kernel's plain version against the JAX package.

On the CPU the wrapper (``ops/ingest_cuda.ingest_features_cuda``) runs
the kernel's plain PyTorch version; these tests hold it against the JAX
package's Pallas kernels in interpret mode and against its CPU decode
rung, on the same numpy inputs.

Tolerances: 1e-6 against ``exact`` and the decode ``slice`` rung (both
subtract the baseline first; only summation orders differ), 5e-5
against ``bank128`` and ``aligned8`` (the JAX package's two-term
formulations, whose own tolerance class is 5e-5). The DC-heavy stream
is the JAX package's own DC-offset fixture shape
(tests/test_ingest_pallas.py): at DC near the int16 limit the JAX
kernels' float32 baseline mean carries errors above 1e-6 by itself,
while the port sums the baseline in float64.
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.ops import decode_ingest, ingest_pallas
from eeg_dataanalysispackage_tpu_torch.ops import dwt, ingest_cuda

RES = np.array([0.1, 0.1, 0.2], np.float32)


def _stream(kind, S=30000, seed=0):
    rng = np.random.RandomState(seed)
    noise = rng.randint(-3000, 3000, size=(3, S))
    dc = {"random": [[0], [0], [0]], "dc_heavy": [[1800], [-2200], [900]]}[kind]
    return np.clip(noise + np.array(dc), -32768, 32767).astype(np.int16)


def _positions(case, S):
    base = 100 + 173 * np.arange(60)
    if case == "dense":  # overlapping windows, n not a multiple of any tile
        return (100 + 37 * np.arange(101)).astype(np.int64)
    if case == "single":
        return np.array([5000], np.int64)
    if case == "overhang":  # windows running past the end of the stream
        return np.concatenate([base, [S - 300, S - 686, S - 100]]).astype(np.int64)
    if case == "unsorted":
        return np.random.RandomState(3).permutation(base).astype(np.int64)
    raise ValueError(case)


def _port(raw, positions):
    return ingest_cuda.ingest_features_cuda(
        torch.from_numpy(raw), torch.from_numpy(RES), positions
    ).numpy()


def _pallas(raw, positions, mode):
    return np.asarray(
        ingest_pallas.ingest_features_pallas(
            raw, RES, positions, chunk=8192, tile_b=8, interpret=True, mode=mode
        )
    )


CASES = [(k, c) for k in ("random", "dc_heavy")
         for c in ("dense", "single", "overhang", "unsorted")]


@pytest.mark.parametrize("mode,tol", [("exact", 1e-6), ("bank128", 5e-5), ("aligned8", 5e-5)])
@pytest.mark.parametrize("kind,case", CASES)
def test_plain_version_matches_pallas_kernels(kind, case, mode, tol):
    raw = _stream(kind)
    positions = _positions(case, raw.shape[1])
    got = _port(raw, positions)
    want = _pallas(raw, positions, mode)
    assert got.shape == want.shape == (len(positions), 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("kind,case", CASES)
def test_plain_version_matches_decode_slice_rung(kind, case):
    raw = _stream(kind)
    positions = _positions(case, raw.shape[1])
    cap = ((len(positions) + 63) // 64) * 64
    pos = np.zeros(cap, np.int32)
    pos[: len(positions)] = positions
    mask = np.zeros(cap, bool)
    mask[: len(positions)] = True
    want = np.asarray(
        decode_ingest.make_decode_ingest_featurizer(formulation="slice")(raw, RES, pos, mask)
    )
    got = ingest_cuda.make_cuda_ingest_featurizer()(
        torch.from_numpy(raw), torch.from_numpy(RES), pos, mask
    ).numpy()
    assert got.shape == want.shape == (cap, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not got[len(positions):].any()  # padded rows are zero


def test_window_starting_at_the_end_is_a_zero_row():
    """A window starting exactly at n_samples is valid (Java copyOfRange)
    and reads only zeros: zeros out, not NaN. The JAX package's exact
    kernel agrees; its bank128 formulation returns a unit-norm row of
    cancellation residue there (recorded in ROADMAP.md)."""
    raw = _stream("dc_heavy")
    S = raw.shape[1]
    positions = np.array([5000, S + 100], np.int64)
    got = _port(raw, positions)
    assert np.isfinite(got).all()
    assert not got[1].any()
    np.testing.assert_allclose(got, _pallas(raw, positions, "exact"), rtol=0, atol=1e-6)
    bank = _pallas(raw, positions, "bank128")
    np.testing.assert_allclose(got[0], bank[0], rtol=0, atol=5e-5)
    assert abs(np.linalg.norm(bank[1]) - 1.0) < 1e-3


def test_baseline_sum_is_order_independent_at_int16_limit_dc():
    """The float64 baseline sum is exact for int16 x resolution terms, so
    the kernel's order (32 lane-strided partial sums, then an xor-shuffle
    tree) gives the plain version's mean bit for bit, even at DC near the
    int16 limit where float32 sums of the same terms disagree."""
    rng = np.random.RandomState(9)
    raw = np.clip(rng.randint(-300, 300, size=(3, 100)) + np.array([[30000], [-30000], [29000]]),
                  -32768, 32767).astype(np.int16)
    x = raw.astype(np.float32) * RES[:, None]  # (3, 100) scaled baseline
    plain = torch.from_numpy(x).double().sum(dim=-1).numpy()
    lanes = np.zeros((3, 32))
    for j in range(100):
        lanes[:, j % 32] += x[:, j].astype(np.float64)
    off = 16
    while off:
        lanes = lanes + lanes[:, np.arange(32) ^ off]
        off //= 2
    assert np.array_equal(lanes[:, 0], plain)
    f32_forward = np.cumsum(x, axis=1, dtype=np.float32)[:, -1]
    f32_backward = np.cumsum(x[:, ::-1], axis=1, dtype=np.float32)[:, -1]
    assert not np.array_equal(f32_forward, f32_backward)


def _float64_features(raw, positions):
    """Float64 features from the same float32 sample products: the
    reference chain without any float32 sums."""
    W = dwt.cascade_matrix(8, 512, 16)
    x = np.pad(raw.astype(np.float32) * RES[:, None], ((0, 0), (0, 800))).astype(np.float64)
    rows = []
    for p in positions:
        seg = x[:, p - 100 : p + 687]
        y = ((seg[:, 275:] - seg[:, :100].mean(axis=1, keepdims=True)) @ W).reshape(-1)
        rows.append(y / max(np.sqrt((y * y).sum()), 1e-30))
    return np.array(rows)


@pytest.mark.parametrize("dc,noise", [((28000, -28000, 25000), 2500), ((30000, -30000, 29000), 300)])
def test_port_is_closer_to_float64_than_reference_at_int16_limit_dc(dc, noise):
    """At DC near the int16 limit the reference's float32 baseline mean
    carries the largest error; the port's float64 baseline sum removes
    it. Prints both deviations from the float64 features (run with -s)."""
    rng = np.random.RandomState(0)
    raw = np.clip(rng.randint(-noise, noise, size=(3, 30000)) + np.array(dc)[:, None],
                  -32768, 32767).astype(np.int16)
    positions = (100 + 173 * np.arange(100)).astype(np.int64)
    exact = _float64_features(raw, positions)
    port = np.abs(_port(raw, positions) - exact).max()
    reference = np.abs(_pallas(raw, positions, "exact") - exact).max()
    print(f"dc={dc} noise={noise}: port {port:.3e}, reference exact {reference:.3e}")
    assert port < reference


def test_wrapper_rejects_bad_inputs():
    raw = torch.zeros((3, 1000), dtype=torch.int16)
    res = torch.from_numpy(RES)
    W = torch.zeros((512, 16))
    starts = torch.zeros(4, dtype=torch.int32)
    # int16 and float32 streams run; other sample types raise
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features(raw.double(), res, starts, W)
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features(raw.int(), res, starts, W)
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features(raw, res.double(), starts, W)
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features(raw, res, starts.long(), W)
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features(raw, res, starts, torch.zeros((256, 16)))
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features(raw[:, ::2], res, starts, W)  # not contiguous
    with pytest.raises(ValueError):
        ingest_cuda.ingest_features_cuda(raw, res, np.array([50]))  # start < 0
    with pytest.raises(ValueError):
        ingest_cuda.make_cuda_ingest_featurizer(epoch_size=256)(
            raw, res, np.zeros(64, np.int32), np.zeros(64, bool)
        )


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = ingest_cuda.LAUNCHES
    _port(_stream("random"), _positions("single", 30000))
    assert ingest_cuda.LAUNCHES == before

