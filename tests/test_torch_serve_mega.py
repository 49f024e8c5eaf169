"""The serve megakernel's plain version against the JAX package.

On the CPU the megakernel program (``ops/serve_mega.make_serve_mega_program``)
runs its plain PyTorch version; these tests hold it against the JAX
package's Pallas megakernel in interpret mode and against its XLA twin,
on the same numpy inputs, within the JAX package's own margin gate
``MEGA_GATE_TOL`` (5e-5). The observed deviation is printed (``-s``);
the two compute the same float32 chain and differ by summation order
and by the port's float64 baseline mean, about 1e-6 on these inputs.
"""

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.ops import serve_mega as jax_serve_mega
from eeg_dataanalysispackage_tpu_torch.ops import dwt, serve_mega, serve_mega_cuda

_C, _PRE, _POST = 3, 100, 750
_WIN = _PRE + _POST
_RES = np.full(_C, 0.1, np.float32)


def _windows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (
            rng.randint(-3000, 3000, size=(_C, _WIN))
            + np.asarray([12000, -9000, 6000])[:, None]
        ).astype(np.int16)
        for _ in range(n)
    ]


def _port_margins(windows, weights, capacity):
    program = serve_mega.make_serve_mega_program(
        n_channels=_C, pre=_PRE, post=_POST, capacity=capacity
    )
    stride = serve_mega.padded_stride(_PRE, _POST)
    stream = serve_mega.stage_mega_stream(windows, _C, _WIN, stride, capacity)
    return program(
        torch.from_numpy(stream), torch.from_numpy(_RES), torch.from_numpy(weights)
    ).numpy()


def _jax_margins(windows, weights, capacity, lowering):
    import jax

    program = jax_serve_mega.make_serve_mega_program(
        n_channels=_C, pre=_PRE, post=_POST, capacity=capacity,
        lowering=lowering, interpret=True, donate=False,
    )
    stride = jax_serve_mega.padded_stride(_PRE, _POST)
    stream = jax_serve_mega.stage_mega_stream(windows, _C, _WIN, stride, capacity)
    return np.asarray(program(jax.device_put(stream), _RES, weights))


@pytest.mark.parametrize("lowering", ["pallas", "xla"])
@pytest.mark.parametrize("capacity", [64, 128])
def test_plain_mega_margins_match_jax_kernel(lowering, capacity):
    weights = np.random.RandomState(1).randn(_C * 16).astype(np.float32)
    for n in (1, 3, capacity):
        windows = _windows(n, seed=n)
        got = _port_margins(windows, weights, capacity)
        want = _jax_margins(windows, weights, capacity, lowering)
        assert got.shape == want.shape == (capacity,)
        dev = float(np.max(np.abs(got[:n] - want[:n])))
        print(f"mega {lowering} capacity={capacity} n={n}: max abs dev {dev:.3e}")
        assert dev <= jax_serve_mega.MEGA_GATE_TOL
        # padded capacity rows are exactly zero
        assert np.all(got[n:] == 0.0)


def test_window_margin_is_the_same_in_any_batch():
    weights = np.random.RandomState(2).randn(_C * 16).astype(np.float32)
    windows = _windows(7, seed=7)
    batch = _port_margins(windows, weights, 64)
    for i, w in enumerate(windows):
        assert _port_margins([w], weights, 64)[0] == batch[i]


def test_stride_and_staging_equal_jax_package():
    for pre, post in ((100, 750), (0, 512), (1, 127), (100, 900)):
        assert serve_mega.padded_stride(pre, post) == jax_serve_mega.padded_stride(pre, post)
    windows = _windows(5, seed=3)
    stride = serve_mega.padded_stride(_PRE, _POST)
    for capacity in (5, 64):
        got = serve_mega.stage_mega_stream(windows, _C, _WIN, stride, capacity)
        want = jax_serve_mega.stage_mega_stream(windows, _C, _WIN, stride, capacity)
        assert got.dtype == want.dtype == np.int16
        assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="expected"):
        serve_mega.stage_mega_stream([np.zeros((3, 10), np.int16)], _C, _WIN, stride, 4)


def test_gate_tolerance_and_override(monkeypatch):
    assert serve_mega.MEGA_GATE_TOL == jax_serve_mega.MEGA_GATE_TOL == 5e-5
    monkeypatch.delenv("EEG_TPU_MEGA_GATE_TOL", raising=False)
    assert serve_mega.mega_gate_tolerance() == 5e-5
    monkeypatch.setenv("EEG_TPU_MEGA_GATE_TOL", "1e-3")
    assert serve_mega.mega_gate_tolerance() == 1e-3
    monkeypatch.setenv("EEG_TPU_MEGA_GATE_TOL", "loose")
    assert serve_mega.mega_gate_tolerance() == jax_serve_mega.mega_gate_tolerance() == 5e-5


def test_program_rejects_bad_geometry():
    with pytest.raises(ValueError, match="pre >= 1"):
        serve_mega.make_serve_mega_program(n_channels=_C, pre=0, post=512)
    with pytest.raises(ValueError, match="exceeds the padded stride"):
        serve_mega.make_serve_mega_program(n_channels=_C, pre=100, post=600)
    for precision in ("int8", "int4"):  # ported: zero windows give margin 0
        quantized = serve_mega.make_serve_mega_program(precision=precision)
        zeros = torch.zeros((3, 64 * 896), dtype=torch.int16)
        assert bool((quantized(zeros, torch.ones(3), torch.ones(48)) == 0).all())
    with pytest.raises(ValueError, match="bf16 has no mega twin"):
        serve_mega.make_serve_mega_program(precision="bf16")
    program = serve_mega.make_serve_mega_program(capacity=64)
    with pytest.raises(ValueError, match="stream must be"):
        program(torch.zeros((3, 63 * 896), dtype=torch.int16), torch.ones(3),
                torch.zeros(48))


def test_wrapper_checks_inputs_and_runs_plain_on_cpu():
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32))
    stream = torch.zeros((3, 2 * 896), dtype=torch.int16)
    res, weights = torch.ones(3), torch.ones(48)
    before = serve_mega_cuda.LAUNCHES
    out = serve_mega_cuda.serve_mega_margins(stream, res, W, weights, 100, 175, 896)
    assert out.shape == (2,) and bool((out == 0).all())
    assert serve_mega_cuda.LAUNCHES == before  # the plain version is no launch
    bad = {
        "stream must be": (stream.to(torch.int32), res, W, weights, 100, 175, 896),
        "resolutions must be": (stream, res.double(), W, weights, 100, 175, 896),
        "operator must be": (stream, res, W[:256], weights, 100, 175, 896),
        "weights must be": (stream, res, W, torch.ones(47), 100, 175, 896),
        "pre >= 1": (stream, res, W, weights, 0, 175, 896),
        "<= stride": (stream, res, W, weights, 100, 300, 896),
        "multiple of the stride": (stream[:, :1000].contiguous(), res, W, weights, 100, 175, 896),
        "contiguous": (stream, res, W.t().contiguous().t(), weights, 100, 175, 896),
    }
    for match, args in bad.items():
        with pytest.raises(ValueError, match=match):
            serve_mega_cuda.serve_mega_margins(*args)
