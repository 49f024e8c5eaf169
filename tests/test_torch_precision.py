"""The port's precision= rungs (bf16, int8, int4) against the JAX package.

On the CPU the kernels' wrappers run their plain versions; these tests
hold them against the JAX package on the same numpy inputs:

- the quantizers are bit-equal to the JAX package's functions (random
  rows, zero rows, all-zero groups, exact .5 ties), and so are the
  subband groups, lane masks and the packed int4 representation;
- bf16 rows within 5e-4 of the JAX package's decode slice twin on a
  +-2,000 DC stream, and within 5e-3 of the Pallas ``bank128_bf16`` mode
  in interpret mode (it centres on a slab mean before its cast, another
  rounding);
- int8/int4 rows within 1e-6 of the JAX package's decode featurizer,
  except quantization-boundary flips, each exactly one step of its group;
- megakernel int8/int4 margins against the JAX package's XLA twin and
  its Pallas kernel's function (the kernel itself does not trace in
  interpret mode under the installed JAX): 5e-5 on rows without a flip,
  the rung's tolerance on rows with one;
- gate records, ``precision_resolved`` and statistics equal to the JAX
  package's for every rung, trained and saved -> loaded, and for a run
  forced to trip its gate; served statistics equal the batch ``load_clf=``
  run's at every rung.

The JAX package's jitted quantizers (``int8_feature_path``, its serving
programs) differ from its un-jitted functions: XLA turns the division by
the constant qmax into a multiplication by its float32 reciprocal. The
port computes the IEEE division, as the un-jitted function and the
card's kernel do; against the jitted paths the rows then agree at the
flip-aware tolerance above. Observed deviations print with ``-s``.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.ops import decode_ingest as jax_decode
from eeg_dataanalysispackage_tpu.ops import ingest_pallas as jax_pallas
from eeg_dataanalysispackage_tpu.ops import quant as jax_quant
from eeg_dataanalysispackage_tpu.ops import serve_mega as jax_serve_mega
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.ops import (
    decode_ingest, device_ingest, dwt, ingest_cuda, quant, serve_mega,
)
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import InferenceService, engine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

_K = 16
_RES = np.array([0.1, 0.1, 0.2], np.float32)
_QMAX = {"int8": 127.0, "int4": 7.0}
_TOL_ENV = {"bf16": "EEG_TPU_BF16_GATE_TOL", "int8": "EEG_TPU_INT8_GATE_TOL",
            "int4": "EEG_TPU_INT4_GATE_TOL"}


def _unit_rows(n, seed, C=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, C * _K).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _quantizer_rows(qmax):
    """Random unit rows, a zero row, rows with all-zero groups, and rows
    whose groups hit exact .5 ties (a power-of-two scale: max = qmax *
    2^-k, so g / s is exact)."""
    rows = [_unit_rows(40, seed=int(qmax))]
    rows.append(np.zeros((1, 48), np.float32))
    zero_groups = _unit_rows(6, seed=3)
    zero_groups[:, 0] = 0.0             # channel 0's approximation group
    zero_groups[:, 16 + 8:16 + 16] = 0.0  # channel 1's finest band
    zero_groups[:3, 32:48] = 0.0        # channel 2 entirely
    rows.append(zero_groups)
    step = np.float32(2.0 ** -7) if qmax == 127.0 else np.float32(2.0 ** -3)
    ties = np.zeros((4, 48), np.float32)
    for c in range(3):
        base = c * _K
        for lo, hi in decode_ingest.subband_group_bounds(_K):
            ties[:, base + lo] = np.float32(qmax) * step  # the group max
            for j in range(lo + 1, hi):
                ties[:, base + j] = np.float32((j % 7) + 0.5) * step * np.float32(
                    1 if j % 2 else -1)
    ties[1] *= -1
    ties[2, :] = np.float32(0.5) * step
    ties[2, ::5] = np.float32(qmax) * step
    rows.append(ties)
    return np.concatenate(rows)


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantizer_is_bit_equal_to_jax(precision):
    qmax = _QMAX[precision]
    rows = _quantizer_rows(qmax)
    ours_fn = (decode_ingest.quantize_dequantize_int8 if precision == "int8"
               else quant.quantize_dequantize_int4)
    theirs_fn = (jax_decode.quantize_dequantize_int8 if precision == "int8"
                 else jax_quant.quantize_dequantize_int4)
    got, got_s = ours_fn(torch.from_numpy(rows), _K)
    want, want_s = theirs_fn(jax.numpy.asarray(rows), _K)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    assert got_s.numpy().tobytes() == np.asarray(want_s).tobytes()
    assert bool((got[40] == 0).all())  # the zero row stays zero
    # the exact ties round half to even: 2.5 -> 2, 3.5 -> 4, 5.5 -> 6,
    # -6.5 -> -6, 0.5 -> 0
    q = decode_ingest.quantize_levels(torch.from_numpy(rows[-4:]), _K, qmax)[0]
    assert [q[0, j].item() for j in (9, 3, 5, 6)] == [2.0, 4.0, 6.0, -6.0]
    assert q[2, 9].item() == 0.0
    # the masked (full-row) spelling is the same function
    masks = quant.subband_lane_masks(3, _K)
    masked = quant.masked_quantize_dequantize(torch.from_numpy(rows), masks, qmax)
    jax_masked = jax_quant.masked_quantize_dequantize(
        jax.numpy.asarray(rows), jax_quant.subband_lane_masks(3, _K), qmax)
    assert masked.numpy().tobytes() == got.numpy().tobytes()
    assert masked.numpy().tobytes() == np.asarray(jax_masked).tobytes()


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantizer_against_the_jitted_jax_path(precision):
    """XLA multiplies by qmax's float32 reciprocal where the source
    divides: scales may differ by an ulp, so values differ by at most
    ~qmax ulps of the scale, and a level flips only on an exact tie."""
    qmax = _QMAX[precision]
    rows = _quantizer_rows(qmax)
    ours = (decode_ingest.int8_feature_path if precision == "int8"
            else quant.int4_feature_path)(torch.from_numpy(rows), _K).numpy()
    theirs = np.asarray((jax_decode.int8_feature_path if precision == "int8"
                         else jax_quant.int4_feature_path)(jax.numpy.asarray(rows), _K))
    flips, dev = _flips(ours, theirs, rows, qmax)
    print(f"{precision} port vs jitted JAX: {len(flips)} flips, max dev {dev:.3e}")
    assert dev <= 1e-6
    assert len(flips) <= 40  # the tie rows' elements at most


def test_subband_groups_and_masks_equal_jax():
    for K in (1, 2, 5, 16, 17, 64):
        assert decode_ingest.subband_group_bounds(K) == jax_decode.subband_group_bounds(K)
    with pytest.raises(ValueError, match="feature_size"):
        decode_ingest.subband_group_bounds(0)
    for C in (1, 3):
        ours, theirs = quant.subband_lane_masks(C, _K), jax_quant.subband_lane_masks(C, _K)
        assert len(ours) == len(theirs) == 5 * C
        for a, b in zip(ours, theirs):
            assert a.tobytes() == b.tobytes()


def test_int4_packing_equals_jax_and_round_trips():
    rows = _quantizer_rows(7.0)
    packed, scales = quant.quantize_int4_packed(rows, _K)
    j_packed, j_scales = jax_quant.quantize_int4_packed(rows, _K)
    assert packed.tobytes() == j_packed.tobytes() and packed.dtype == np.uint8
    assert scales.tobytes() == j_scales.tobytes()
    assert (packed & 0xF).min() >= 1 and (packed >> 4).min() >= 1  # the +8 tripwire
    back = quant.dequantize_int4_packed(packed, scales, _K)
    want = quant.quantize_dequantize_int4(torch.from_numpy(rows), _K)[0].numpy()
    assert back.tobytes() == want.tobytes()
    assert back.tobytes() == jax_quant.dequantize_int4_packed(j_packed, j_scales, _K).tobytes()
    levels = np.arange(-7, 9).reshape(2, 8) % 15 - 7
    assert np.array_equal(quant.unpack_int4_rows(quant.pack_int4_rows(levels)), levels)
    with pytest.raises(ValueError, match=r"out of \[-7, 7\]"):
        quant.pack_int4_rows(np.array([[8, 0]]))
    with pytest.raises(ValueError, match="even"):
        quant.pack_int4_rows(np.zeros((2, 3)))


def test_gate_tolerances_and_overrides(monkeypatch, caplog):
    assert decode_ingest.PRECISIONS == jax_decode.PRECISIONS
    assert (decode_ingest.BF16_GATE_TOL, decode_ingest.INT8_GATE_TOL, quant.INT4_GATE_TOL) == (
        jax_decode.BF16_GATE_TOL, jax_decode.INT8_GATE_TOL, jax_quant.INT4_GATE_TOL)
    assert quant.INT4_QMAX == jax_quant.INT4_QMAX
    for precision, env in _TOL_ENV.items():
        monkeypatch.delenv(env, raising=False)
        assert decode_ingest.precision_gate_tolerance(precision) == \
            jax_decode.precision_gate_tolerance(precision)
        monkeypatch.setenv(env, "1e-9")
        assert decode_ingest.precision_gate_tolerance(precision) == 1e-9
        monkeypatch.setenv(env, "tight")
        with caplog.at_level("WARNING"):
            assert decode_ingest.precision_gate_tolerance(precision) == \
                jax_decode.precision_gate_tolerance(precision)
        assert f"{env}='tight' is not a float" in caplog.text
    with pytest.raises(ValueError, match="no accuracy gate"):
        decode_ingest.precision_gate_tolerance("f32")


def test_feature_gate_record_equals_jax():
    rows = _unit_rows(8, seed=5)
    for drift, precision in ((1e-3, "bf16"), (1e-2, "bf16"), (3e-2, "int8"), (0.1, "int4")):
        ours = decode_ingest.feature_precision_gate(
            torch.from_numpy(rows + np.float32(drift)), torch.from_numpy(rows), precision)
        theirs = jax_decode.feature_precision_gate(rows + np.float32(drift), rows, precision)
        assert ours == theirs
    with pytest.raises(ValueError, match="misaligned"):
        decode_ingest.feature_precision_gate(rows[:2], rows, "int8")


def _dc_stream(n=96, seed=0, dc=(2000, -2000, 2000)):
    """A +-2,000 DC int16 stream with irregular marker positions; returns
    (raw, positions, mask, n) in the decode plan's form."""
    rng = np.random.RandomState(seed)
    S = 200 + n * 750 + 1000
    raw = (rng.randint(-3000, 3000, size=(3, S)) + np.asarray(dc)[:, None]).astype(np.int16)
    positions = np.clip(np.arange(n) * 750 + 200 + rng.randint(-200, 200, size=n), 100, S - 800)
    cap = ((n + 63) // 64) * 64
    pos = np.zeros(cap, np.int32)
    pos[:n] = positions
    mask = np.zeros(cap, bool)
    mask[:n] = True
    return raw, pos, mask, n


def _port_rows(raw, pos, mask, precision):
    featurize = ingest_cuda.make_cuda_ingest_featurizer(precision=precision)
    return featurize(torch.from_numpy(raw), torch.from_numpy(_RES), pos, mask).numpy()


def _jax_rows(raw, pos, mask, precision):
    return np.asarray(jax_decode.make_decode_ingest_featurizer(
        formulation="slice", precision=precision)(raw, _RES, pos, mask))


def test_bf16_rows_match_the_jax_slice_twin_and_bank_kernel():
    raw, pos, mask, n = _dc_stream()
    ours = _port_rows(raw, pos, mask, "bf16")
    slice_twin = _jax_rows(raw, pos, mask, "bf16")
    f32 = _port_rows(raw, pos, mask, "f32")
    assert np.all(ours[n:] == 0.0)
    dev_slice = float(np.abs(ours[:n] - slice_twin[:n]).max())
    bank = np.asarray(jax_pallas.ingest_features_pallas(
        raw, _RES, pos[:64].astype(np.int64), mode="bank128_bf16", interpret=True))
    dev_bank = float(np.abs(ours[:64] - bank).max())
    dev_f32 = float(np.abs(ours[:n] - f32[:n]).max())
    print(f"bf16 vs JAX slice twin {dev_slice:.3e}, vs bank128_bf16 {dev_bank:.3e}, "
          f"vs f32 {dev_f32:.3e}")
    assert dev_slice <= 5e-4
    assert dev_bank <= 5e-3
    assert 1e-6 < dev_f32 <= decode_ingest.BF16_GATE_TOL  # the rung really ran bf16


def _flips(ours, theirs, f32_rows, qmax):
    """Elements where two quantized row sets differ by more than 1e-6:
    each must be one quantization step of its group (the port's scale,
    within 1e-6). Returns (flips, max deviation elsewhere)."""
    diff = np.abs(ours - theirs)
    scales = decode_ingest.quantize_levels(torch.from_numpy(f32_rows), _K, qmax)[1].numpy()
    C = ours.shape[1] // _K
    flips = []
    for r, i in zip(*np.nonzero(diff > 1e-6)):
        c, k = divmod(int(i), _K)
        group = next(g for g, (lo, hi) in enumerate(decode_ingest.subband_group_bounds(_K))
                     if lo <= k < hi)
        step = float(scales[group, r, c])
        assert abs(diff[r, i] - step) <= 1e-6, (r, i, diff[r, i], step)
        flips.append((int(r), int(i), float(ours[r, i]), float(theirs[r, i])))
    rest = np.where(diff > 1e-6, 0.0, diff)
    assert C * _K == ours.shape[1]
    return flips, float(rest.max()) if rest.size else 0.0


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("dc", [(0, 0, 0), (2000, -2000, 2000)])
def test_quantized_rows_match_the_jax_decode_featurizer(precision, dc):
    raw, pos, mask, n = _dc_stream(n=200, seed=1, dc=dc)
    ours = _port_rows(raw, pos, mask, precision)
    theirs = _jax_rows(raw, pos, mask, precision)
    f32 = _port_rows(raw, pos, mask, "f32")
    assert np.all(ours[n:] == 0.0)
    flips, dev = _flips(ours[:n], theirs[:n], f32[:n], _QMAX[precision])
    print(f"{precision} dc={dc}: {len(flips)} boundary flips {flips[:4]}, "
          f"max dev elsewhere {dev:.3e}")
    assert dev <= 1e-6
    # the quantize step is the plain quantizer on the f32 rows
    assert ours.tobytes() == (decode_ingest.int8_feature_path if precision == "int8"
                              else quant.int4_feature_path)(torch.from_numpy(f32), _K
                                                            ).numpy().tobytes()


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("lowering", ["pallas", "xla"])
def test_quantized_mega_margins_match_jax(precision, lowering):
    C, pre, post, cap = 3, 100, 750, 64
    rng = np.random.RandomState(3)
    windows = [(rng.randint(-3000, 3000, size=(C, pre + post))
                + np.asarray([12000, -9000, 6000])[:, None]).astype(np.int16)
               for _ in range(cap)]
    weights = rng.randn(C * _K).astype(np.float32)
    stride = serve_mega.padded_stride(pre, post)
    stream = serve_mega.stage_mega_stream(windows, C, pre + post, stride, cap)
    program = serve_mega.make_serve_mega_program(capacity=cap, precision=precision)
    ours = program(torch.from_numpy(stream), torch.from_numpy(_RES),
                   torch.from_numpy(weights)).numpy()
    jax_program = jax_serve_mega.make_serve_mega_program(
        capacity=cap, lowering=lowering, interpret=True, donate=False, precision=precision)
    # flip rows: the port's quantized rows against the JAX package's
    # quantizer on its own f32 rows of the same windows
    starts = torch.arange(cap, dtype=torch.int32) * stride
    W = torch.from_numpy(dwt.cascade_matrix(8, 512, 16).astype(np.float32))
    q_rows = device_ingest.ingest_features_plain(
        torch.from_numpy(stream), torch.from_numpy(_RES), starts, W, pre, 175, precision).numpy()
    jax_f32 = _jax_rows(stream, (np.arange(cap) * stride + pre).astype(np.int32),
                        np.ones(cap, bool), "f32")
    jax_q = np.asarray((jax_decode.quantize_dequantize_int8 if precision == "int8"
                        else jax_quant.quantize_dequantize_int4)(jax_f32, _K)[0])
    if lowering == "pallas":
        # The JAX package's quantized Pallas megakernel does not trace
        # under the installed JAX: its body captures the lane masks as
        # constants, which pallas_call refuses. Its function is the masked
        # quantizer on the f32 rows, then the dot; that is what the port
        # is held against here.
        with pytest.raises(ValueError, match="captures constants"):
            jax_program(jax.device_put(stream), _RES, weights)
        masks = jax_quant.subband_lane_masks(C, _K)
        theirs = np.asarray(jax_quant.masked_quantize_dequantize(
            jax.numpy.asarray(jax_f32), masks, _QMAX[precision])) @ weights
    else:
        theirs = np.asarray(jax_program(jax.device_put(stream), _RES, weights))
    flip_rows = np.nonzero(np.abs(q_rows - jax_q).max(axis=1) > 1e-6)[0]
    dev = np.abs(ours - theirs)
    clean = np.setdiff1d(np.arange(cap), flip_rows)
    print(f"mega {precision} {lowering}: flip rows {flip_rows.tolist()}, clean max dev "
          f"{dev[clean].max():.3e}, flip max dev {dev[flip_rows].max() if flip_rows.size else 0:.3e}")
    assert dev[clean].max() <= jax_serve_mega.MEGA_GATE_TOL
    assert dev.max() <= decode_ingest.precision_gate_tolerance(precision)
    assert ours.tobytes() == (torch.from_numpy(q_rows) @ torch.from_numpy(weights)).numpy().tobytes()


def test_mega_precision_validation():
    for precision in ("bf16", "f16"):
        with pytest.raises(ValueError, match="bf16 has no mega twin"):
            serve_mega.make_serve_mega_program(precision=precision)
    with pytest.raises(ValueError, match="unknown precision"):
        ingest_cuda.make_cuda_ingest_featurizer(precision="f16")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Two recordings x 120 markers; a logreg model trained and saved by
    each package."""
    d = tmp_path_factory.mktemp("precision_session")
    lines = []
    for i, guessed in enumerate((3, 6)):
        _synthetic.write_recording(str(d), name=f"rec_{i}", n_markers=120,
                                   guessed=guessed, seed=40 + i)
        lines.append(f"rec_{i}.eeg {guessed}")
    info = str(d / "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    models = {"port": str(d / "model_port"), "jax": str(d / "model_jax")}
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&save_clf=true"
    PipelineBuilder(q + f"&save_name={models['port']}", device="cpu").execute()
    JaxBuilder(q + f"&save_name={models['jax']}&cache=false").execute()
    return {"info": info, "models": models}


def _assert_same_statistics(ours, theirs, label):
    """str-equal statistics; otherwise name the test rows whose
    predictions differ, with both margins."""
    if str(ours.statistics) == str(theirs.statistics):
        return
    rows = []
    if ours.features is not None:
        idx = torch.as_tensor(ours.test_index)
        m = ours.classifier.margin(ours.features[idx]).double().numpy()
        rows = [(int(ours.test_index[r]), float(m[r]))
                for r in np.nonzero(np.abs(m - ours.classifier.margin_threshold) < 1e-2)[0]]
    raise AssertionError(f"{label}: statistics differ; near-threshold test rows {rows}")


def _env(monkeypatch, env):
    for name in _TOL_ENV.values():
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("EEG_TPU_PRECISION", raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)


_RUNS = [
    pytest.param("bf16", {}, id="bf16"),
    pytest.param("int8", {}, id="int8"),
    pytest.param("int4", {}, id="int4"),
    pytest.param("int4", {"EEG_TPU_INT4_GATE_TOL": "1e-9"}, id="int4-gate-tripped"),
]


@pytest.mark.parametrize("clf", ["logreg", "svm"])
@pytest.mark.parametrize("precision,env", _RUNS)
def test_trained_statistics_and_gate_equal_jax(session, monkeypatch, precision, env, clf):
    _env(monkeypatch, env)
    q = (f"info_file={session['info']}&fe=dwt-8-fused&train_clf={clf}"
         f"&precision={precision}")
    ours = PipelineBuilder(q, device="cpu")
    ours.execute()
    theirs = JaxBuilder(q + "&cache=false")
    theirs.execute()
    _assert_same_statistics(ours, theirs, f"{precision} {clf}")
    got, want = ours.precision_resolved, theirs.precision_resolved
    print(f"{precision} {env}: port gate {got['gate']}, JAX gate {want['gate']}")
    assert (got["requested"], got["used"]) == (want["requested"], want["used"])
    assert sorted(got["gate"]) == sorted(want["gate"])
    assert got["gate"]["ok"] == want["gate"]["ok"]
    assert got["gate"]["rows_checked"] == want["gate"]["rows_checked"]
    assert got["gate"]["cached"] is False
    if env:
        assert got["used"] == "f32" and not got["gate"]["ok"]
        f32 = PipelineBuilder(q.replace(f"precision={precision}", "precision=f32"),
                              device="cpu")
        assert str(f32.execute()) == str(ours.statistics)
        assert f32.precision_resolved is None
    else:
        assert got["used"] == precision


@pytest.mark.parametrize("precision,env", _RUNS)
def test_loaded_statistics_equal_jax(session, monkeypatch, precision, env):
    """Each package's saved model, loaded by both, at the rung."""
    _env(monkeypatch, env)
    for owner, model in session["models"].items():
        q = (f"info_file={session['info']}&fe=dwt-8-fused&load_clf=logreg"
             f"&load_name={model}&precision={precision}")
        ours = PipelineBuilder(q, device="cpu")
        ours.execute()
        theirs = JaxBuilder(q + "&cache=false")
        theirs.execute()
        _assert_same_statistics(ours, theirs, f"{precision} load of the {owner} model")
        assert ours.precision_resolved["used"] == theirs.precision_resolved["used"]


@pytest.mark.parametrize("precision,env", _RUNS)
def test_served_statistics_equal_the_batch_run(session, monkeypatch, precision, env):
    _env(monkeypatch, env)
    q = (f"info_file={session['info']}&fe=dwt-8-fused&load_clf=logreg"
         f"&load_name={session['models']['port']}&precision={precision}")
    batch = PipelineBuilder(q, device="cpu")
    batch.execute()
    served = PipelineBuilder(q + "&serve=true", device="cpu")
    served.execute()
    jax_served = JaxBuilder(q + "&serve=true&cache=false")
    jax_served.execute()
    assert str(served.statistics) == str(batch.statistics)
    assert str(served.statistics) == str(jax_served.statistics)
    block = served.serve_block
    record = block["precision"]
    assert record["requested"] == precision
    assert record["gate"]["rows_checked"] == 16
    assert sorted(record["gate"]) == sorted(["precision", "max_abs_dev", "tolerance", "ok",
                                             "rows_checked"])
    used = "f32" if env else precision
    assert record["used"] == used
    if used == "bf16":
        assert block["mega"] is None and block["rung"] == "fused"
    else:
        assert block["rung"] == "mega" and block["mega"]["precision"] == used
        assert block["mega"]["gate"]["ok"]
        tol = (serve_mega.MEGA_GATE_TOL if used == "f32"
               else decode_ingest.precision_gate_tolerance(used))
        assert block["mega"]["gate"]["tolerance"] == tol
    assert block["requests"]["completed"] == len(batch.targets)


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_inference_service_records_the_rung(session, precision):
    with InferenceService.from_saved("logreg", session["models"]["port"], precision=precision,
                                     device="cpu") as svc:
        eng = svc.engine
        assert eng.precision_record["used"] == precision
        if precision == "bf16":
            assert eng.mega_record is None and eng.rung == "fused"
        else:
            assert eng.mega_record["precision"] == precision and eng.rung == "mega"
        windows, _ = eng._gate_windows()
        res = np.full(3, 0.1, np.float32)
        preds, margins = eng.execute(windows[:5], res)
        assert preds.shape == margins.shape == (5,)
    with pytest.raises(ValueError, match="unknown precision"):
        engine.ServingEngine(svc.engine.classifier, precision="f16", device="cpu")


@pytest.mark.parametrize("query,message", [
    ("fe=dwt-8&train_clf=logreg&precision=bf16", "applies to the fused fe= modes"),
    ("fe=dwt-8-tpu-bf16&train_clf=logreg&precision=bf16", "applies to the fused fe= modes"),
    ("fe=dwt-8-fused-pallas&train_clf=logreg&precision=int8", "rides the decode rung"),
    ("fe=dwt-8-fused-xla&train_clf=logreg&precision=int4", "rides the decode rung"),
    ("fe=dwt-8-fused&train_clf=logreg&precision=f16", "must be f32, bf16, int8, or int4"),
    ("train_clf=logreg&precision=bf16", "applies to the fused fe= modes"),
    ("fe=dwt-8-fused&precision=bf16", "Missing classifier argument"),
])
def test_precision_errors_equal_jax(session, query, message):
    q = f"info_file={session['info']}&{query}"
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    with pytest.raises(ValueError) as theirs:
        JaxBuilder(q).execute()
    assert message in str(ours.value)
    assert str(ours.value) == str(theirs.value)


def test_env_precision_and_serve_validation(session, monkeypatch):
    _env(monkeypatch, {"EEG_TPU_PRECISION": "int8"})
    q = f"info_file={session['info']}&fe=dwt-8-fused&train_clf=logreg"
    ours = PipelineBuilder(q, device="cpu")
    ours.execute()
    assert ours.precision_resolved["requested"] == "int8"
    assert str(ours.statistics) == str(
        PipelineBuilder(q + "&precision=int8", device="cpu").execute())
    serve_q = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true&load_clf=logreg"
               f"&load_name={session['models']['port']}&precision=f16")
    with pytest.raises(ValueError) as err:
        PipelineBuilder(serve_q, device="cpu").execute()
    with pytest.raises(ValueError) as jax_err:
        JaxBuilder(serve_q).execute()
    assert str(err.value) == str(jax_err.value)
