"""The quantized tenant weight stack's ops against the JAX package, on the CPU.

The port's weight-stack half of ``ops/quant.py`` (the host quantizer,
the dequantize, the weights gate's tolerance, the resident bytes) is
held byte for byte against the JAX package's on seeded numpy stacks.
The plain version of K6-w8 and K6-w4
(``serve_mega.serve_mega_multi_packed_margins_plain``, which the
kernels' wrapper runs for CPU tensors) equals the plain K6 on the
dequantized stack bit for bit, and agrees with the JAX package's
packed-stack megakernel program (its Pallas kernel in interpret mode
and its XLA twin) within ``MEGA_GATE_TOL`` (5e-5) at the main path's
size and at generic sizes: the two compute the same float32 chain in
other summation orders.
"""

import jax
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.ops import quant as jax_quant
from eeg_dataanalysispackage_tpu.ops import serve_mega as jax_serve_mega
from eeg_dataanalysispackage_tpu_torch.ops import dwt, quant, serve_mega, serve_mega_cuda

_C, _PRE, _POST = 3, 100, 750
_RES = np.full(_C, 0.1, np.float32)


def _stack(case, d=48, seed=0):
    """A (d, 128) float32 host mirror: random lanes, some lanes zero (free
    lanes), all zero, one tenant only, or lanes of tiny magnitude."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d, 128).astype(np.float32)
    if case == "zero_lanes":
        w[:, ::3] = 0.0
    elif case == "all_zero":
        w[:] = 0.0
    elif case == "one_tenant":
        w[:, 1:] = 0.0
    elif case == "tiny":
        w *= np.float32(1e-20)
    return w


@pytest.mark.parametrize("case", ["random", "zero_lanes", "all_zero", "one_tenant", "tiny"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantize_weight_stack_is_byte_equal_to_jax(precision, case):
    w = _stack(case)
    packed, scales = quant.quantize_weight_stack(w, precision)
    jpacked, jscales = jax_quant.quantize_weight_stack(w, precision)
    assert packed.dtype == jpacked.dtype and packed.shape == jpacked.shape
    assert packed.tobytes() == jpacked.tobytes()
    assert scales.dtype == np.float32 and scales.tobytes() == jscales.tobytes()
    assert packed.shape == ((48, 128) if precision == "int8" else (24, 128))


@pytest.mark.parametrize("case", ["random", "zero_lanes"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_dequantize_weight_stack_is_byte_equal_to_jax(precision, case):
    packed, scales = jax_quant.quantize_weight_stack(_stack(case, seed=1), precision)
    ours = quant.dequantize_weight_stack(torch.from_numpy(packed), torch.from_numpy(scales),
                                         precision, 48)
    theirs = np.asarray(jax_quant.dequantize_weight_stack(jax.device_put(packed), scales,
                                                          precision, 48))
    assert ours.dtype == torch.float32 and ours.shape == (48, 128)
    assert ours.numpy().tobytes() == theirs.tobytes()


@pytest.mark.parametrize("env", [None, "1e-3", "0", "not-a-float"])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_weights_gate_tolerance_equals_jax(precision, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("EEG_TPU_WEIGHTS_GATE_TOL", raising=False)
    else:
        monkeypatch.setenv("EEG_TPU_WEIGHTS_GATE_TOL", env)
    w = _stack("random", seed=2)
    assert quant.weights_gate_tolerance(precision, w) == jax_quant.weights_gate_tolerance(
        precision, w)
    assert quant.WEIGHTS_GATE_HEADROOM == jax_quant.WEIGHTS_GATE_HEADROOM == 4.0


@pytest.mark.parametrize("precision,nbytes", [("int8", 6656), ("int4", 3584)])
def test_resident_bytes_equal_jax(precision, nbytes):
    packed, scales = quant.quantize_weight_stack(_stack("random"), precision)
    assert quant.resident_weight_bytes(packed, scales) == nbytes
    assert jax_quant.resident_weight_bytes(packed, scales) == nbytes


def test_refusals_carry_the_jax_package_messages():
    for fn in (quant.quantize_weight_stack, jax_quant.quantize_weight_stack):
        with pytest.raises(ValueError, match="has no quantized form"):
            fn(_stack("random"), "f32")
        with pytest.raises(ValueError, match="even row count, got 47"):
            fn(_stack("random", d=47), "int4")
    with pytest.raises(ValueError, match="has no quantized form"):
        quant.dequantize_weight_stack(torch.zeros((48, 128), dtype=torch.int8),
                                      torch.ones(128), "bf16", 48)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_one_lane_swap_leaves_every_other_lane_unchanged(precision):
    """Per-lane scales: rewriting one lane's weights moves that lane's
    packed bytes and scale only."""
    w = _stack("random", seed=3)
    packed, scales = quant.quantize_weight_stack(w, precision)
    w2 = w.copy()
    w2[:, 7] = np.random.RandomState(4).randn(48).astype(np.float32) * 9.0
    packed2, scales2 = quant.quantize_weight_stack(w2, precision)
    others = np.arange(128) != 7
    assert packed2[:, others].tobytes() == packed[:, others].tobytes()
    assert scales2[others].tobytes() == scales[others].tobytes()
    assert packed2[:, 7].tobytes() != packed[:, 7].tobytes() and scales2[7] != scales[7]


def _mega_case(capacity, count, n=512, K=16, skip=175, seed=0):
    rng = np.random.RandomState(seed)
    windows = [(rng.randint(-3000, 3000, size=(_C, _PRE + _POST))
                + np.array([[12000], [-9000], [6000]])).astype(np.int16) for _ in range(count)]
    stride = serve_mega.padded_stride(_PRE, _POST)
    stream = serve_mega.stage_mega_stream(windows, _C, _PRE + _POST, stride, capacity)
    lanes = np.zeros(capacity, np.int32)
    lanes[:count] = rng.randint(0, 128, count)
    w = rng.randn(_C * K, 128).astype(np.float32)
    return stream, lanes, w, stride


@pytest.mark.parametrize("capacity,count", [(64, 1), (64, 64), (128, 77)])
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_plain_packed_k6_equals_plain_k6_on_the_dequantized_stack(precision, capacity, count):
    stream, lanes, w, stride = _mega_case(capacity, count, seed=capacity + count)
    packed, scales = quant.quantize_weight_stack(w, precision)
    packed_t = torch.from_numpy(np.ascontiguousarray(packed.T))
    W = dwt.kernel_operator(8, 512, 16, torch.device("cpu"))
    args = (torch.from_numpy(stream), torch.from_numpy(_RES), W)
    got = serve_mega_cuda.serve_mega_multi_packed_margins(
        *args, packed_t, torch.from_numpy(scales), torch.from_numpy(lanes), _PRE, 175, stride,
        precision)
    deq = quant.dequantize_weight_stack(torch.from_numpy(packed), torch.from_numpy(scales),
                                        precision, 48).t().contiguous()
    want = serve_mega.serve_mega_multi_margins_plain(*args, deq, torch.from_numpy(lanes), _PRE,
                                                     175, stride)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    assert (got[count:] == 0).all()


# (epoch_size, feature_size, skip, lowering): the main path against the
# JAX package's Pallas kernel in interpret mode, generic sizes against
# its XLA twin (the same function)
_JAX_CASES = [(512, 16, 175, "pallas"), (256, 16, 175, "xla"), (333, 20, 100, "xla"),
              (700, 32, 50, "xla")]


@pytest.mark.parametrize("n,K,skip,lowering", _JAX_CASES)
@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_packed_k6_program_matches_jax_packed_program(precision, n, K, skip, lowering):
    capacity = 64
    stream, lanes, w, _stride = _mega_case(capacity, 20, n, K, skip, seed=n + K)
    packed, scales = quant.quantize_weight_stack(w, precision)
    ours = serve_mega.make_serve_mega_multi_program(
        8, n, skip, K, _C, _PRE, _POST, capacity, weights_precision=precision)(
        torch.from_numpy(stream), torch.from_numpy(_RES),
        torch.from_numpy(np.ascontiguousarray(packed.T)), torch.from_numpy(scales),
        torch.from_numpy(lanes)).numpy()
    theirs = np.asarray(jax_serve_mega.make_serve_mega_multi_program(
        8, n, skip, K, _C, _PRE, _POST, capacity, lowering=lowering, interpret=True,
        donate=False, weights_precision=precision)(jax.device_put(stream), _RES, packed, scales,
                                                   lanes))
    dev = float(np.max(np.abs(ours - theirs)))
    print(f"\n{precision} ({n}, {K}) vs JAX {lowering}: {dev:.3e}")
    assert dev <= serve_mega.MEGA_GATE_TOL


def test_packed_program_and_wrapper_check_their_inputs():
    stream, lanes, w, stride = _mega_case(64, 3)
    packed, scales = quant.quantize_weight_stack(w, "int4")
    packed_t = torch.from_numpy(np.ascontiguousarray(packed.T))
    s = torch.from_numpy(scales)
    W = dwt.kernel_operator(8, 512, 16, torch.device("cpu"))
    call = serve_mega_cuda.serve_mega_multi_packed_margins
    args = (torch.from_numpy(stream), torch.from_numpy(_RES), W)
    ln = torch.from_numpy(lanes)
    bad = {
        "packed must be \\(128, 24\\) uint8": (packed_t.to(torch.int8), s, ln, "int4"),
        "packed must be \\(128, 48\\) int8": (packed_t, s, ln, "int8"),
        "packed must be contiguous": (packed_t.t().contiguous().t(), s, ln, "int4"),
        "scales must be a contiguous \\(128,\\) float32": (packed_t, s[:5], ln, "int4"),
        "no packed stack": (packed_t, s, ln, "f32"),
        "lanes must lie in": (packed_t, s, torch.where(ln == ln[0], 200, ln), "int4"),
    }
    for match, (p, sc, lanes_t, wp) in bad.items():
        with pytest.raises(ValueError, match=match):
            call(*args, p, sc, lanes_t, _PRE, 175, stride, wp)
    with pytest.raises(ValueError, match="weights_precision"):
        serve_mega.make_serve_mega_multi_program(capacity=64, weights_precision="fp8")
