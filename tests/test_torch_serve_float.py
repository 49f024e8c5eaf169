"""Serving float32 windows and the host-extractor mode, on the CPU.

A recording in another binary format than INT_16 (IEEE_FLOAT_32, INT_32)
is staged already scaled, as float32 with unit resolutions; its serving
requests are float32 windows. Here such a session serves through the
port's ``serve=true``, ``InferenceService`` and ``MultiplexedService``
on the plain versions of the megakernel's float32-sample instantiations
(K5-f32s, K6-f32s and their int8/int4 forms) and of the fused ingest
kernel's (K1-f32), and is held against the JAX package's service and
the port's batch ``load_clf=`` run on the same session: windows byte for
byte, predictions equal, statistics ``str``-equal. Below that, the plain
float32 margins against the JAX package's megakernel (Pallas in
interpret mode, and its XLA twin) within ``MEGA_GATE_TOL``, and the
host-extractor mode (``ServingEngine(host_extractor=…)``) against the
JAX package's on int16 and float32 windows, with and without a
pre-stimulus segment.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.epochs.extractor import BalanceState as JaxBalance
from eeg_dataanalysispackage_tpu.features import registry as jax_fe_registry
from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.models import registry as jax_registry
from eeg_dataanalysispackage_tpu.ops import decode_ingest as jax_decode
from eeg_dataanalysispackage_tpu.ops import quant as jax_quant
from eeg_dataanalysispackage_tpu.ops import serve_mega as jax_serve_mega
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.serve import InferenceService as JaxService
from eeg_dataanalysispackage_tpu.serve import engine as jax_engine
from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
from eeg_dataanalysispackage_tpu_torch.features import registry as fe_registry
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import linear, registry
from eeg_dataanalysispackage_tpu_torch.ops import decode_ingest, dwt_cuda, serve_mega
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import (
    InferenceService,
    MultiplexedService,
    ServeConfig,
    engine,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _torch_sessions import write_coded_recording  # noqa: E402

_CONFIG = (
    "&config_num_iterations=20&config_step_size=1.0"
    "&config_mini_batch_fraction=1.0"
)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Two IEEE_FLOAT_32 recordings (multiplexed, vectorized) and one
    INT_32 recording; a logreg and an svm model trained and saved by the
    JAX package; the port's windows, targets and resolutions."""
    d = str(tmp_path_factory.mktemp("torch_serve_float"))
    lines = [
        write_coded_recording(d, "flt_0", "IEEE_FLOAT_32", 240, 4, seed=1),
        write_coded_recording(d, "flt_1", "IEEE_FLOAT_32", 180, 7, seed=2,
                              orientation="VECTORIZED"),
        write_coded_recording(d, "i32_2", "INT_32", 120, 2, seed=3),
    ]
    info = os.path.join(d, "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    models = {}
    for clf in ("logreg", "svm"):
        models[clf] = os.path.join(d, f"model_{clf}")
        JaxBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf={clf}&save_clf=true"
                   f"&save_name={models[clf]}&cache=false{_CONFIG}").execute()
    odp = OfflineDataProvider([info], device="cpu")
    balance = BalanceState()
    windows, targets, resolutions = [], [], []
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, res = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, pre=odp.pre, post=odp.post,
            balance=balance,
        )
        windows.extend(ws)
        targets.append(ts)
        resolutions.extend([res] * len(ws))
    classifier = registry.create("logreg")
    classifier.load(models["logreg"])
    return {"info": info, "models": models, "classifier": classifier, "windows": windows,
            "targets": np.concatenate(targets), "resolutions": resolutions}


def _batch_predictions(session, precision="f32"):
    feats, _ = OfflineDataProvider([session["info"]], device="cpu").load_features_device(
        precision=precision)
    return session["classifier"].predict(feats).numpy()


# -- requests --------------------------------------------------------------


def test_float_windows_from_recording_equal_jax_package(session):
    odp = jax_provider.OfflineDataProvider([session["info"]])
    balance = JaxBalance()
    want, want_targets, want_res = [], [], []
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, res = jax_engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, pre=odp.pre, post=odp.post,
            balance=balance,
        )
        want.extend(ws)
        want_targets.append(ts)
        want_res.extend([res] * len(ws))
    assert len(want) == len(session["windows"]) > 64
    for got, exp, res, exp_res in zip(session["windows"], want, session["resolutions"],
                                      want_res):
        assert got.dtype == np.asarray(exp).dtype == np.float32
        assert got.shape == (3, 850)
        assert got.tobytes() == np.asarray(exp).tobytes()
        assert res.tobytes() == np.asarray(exp_res).tobytes() == np.ones(3, np.float32).tobytes()
    np.testing.assert_array_equal(session["targets"], np.concatenate(want_targets))


# -- serve=true and the services ------------------------------------------


@pytest.mark.parametrize("clf", ["logreg", "svm"])
@pytest.mark.parametrize("precision", ["f32", "bf16", "int8", "int4"])
def test_float_serve_statistics_equal_jax_serve_and_port_batch(session, clf, precision,
                                                              tmp_path):
    """serve=true on the float session: the port's statistics equal its
    batch load_clf= run's and the JAX package's serve=true run's; f32,
    int8 and int4 serve on the mega rung (K5-f32s), bf16 on the fused
    rung (K1-f32's bf16 rung)."""
    base = (f"info_file={session['info']}&fe=dwt-8-fused&load_clf={clf}"
            f"&load_name={session['models'][clf]}&precision={precision}")
    batch = str(PipelineBuilder(base, device="cpu").execute())
    builder = PipelineBuilder(base + f"&serve=true&result_path={tmp_path}/serve.txt",
                              device="cpu")
    served = str(builder.execute())
    jax_served = str(JaxBuilder(base + "&serve=true&cache=false").execute())
    assert served == batch == jax_served
    assert (tmp_path / "serve.txt").read_text() == served + "\n"
    block = builder.serve_block
    assert block["rung"] == ("fused" if precision == "bf16" else "mega")
    assert block["requests"]["completed"] == len(session["windows"])
    assert block["drained_cleanly"] is True
    if precision != "f32":
        assert block["precision"]["used"] == precision


@pytest.mark.parametrize("rung,precision", [
    ("mega", "f32"), ("mega", "int8"), ("mega", "int4"),
    ("fused", "f32"), ("fused", "int8"), ("fused", "int4"), ("fused", "bf16"),
])
def test_float_served_predictions_equal_jax_service_and_port_batch(session, rung, precision):
    windows, res = session["windows"], session["resolutions"]
    with InferenceService.from_saved("logreg", session["models"]["logreg"], device="cpu",
                                     precision=precision, engine_rung=rung) as svc:
        assert svc.engine.rung == rung
        served = svc.predict_all(windows, res)
    with JaxService.from_saved("logreg", session["models"]["logreg"], precision=precision,
                               engine_rung=rung) as jax_svc:
        jax_served = jax_svc.predict_all(windows, res)
        assert jax_svc.engine.rung == rung
    predictions = [r.prediction for r in served]
    np.testing.assert_array_equal(predictions, [r.prediction for r in jax_served])
    np.testing.assert_array_equal(predictions, _batch_predictions(session, precision))
    dev = max(abs(a.margin - b.margin) for a, b in zip(served, jax_served))
    print(f"float session {rung} {precision}: max margin dev vs JAX {dev:.3e}")
    tol = serve_mega.MEGA_GATE_TOL
    if precision != "f32":
        tol = max(tol, decode_ingest.precision_gate_tolerance(precision))
    assert dev <= tol


def test_engine_serves_int16_and_float32_batches_side_by_side(session):
    """One engine serves batches of either dtype, each on its own
    sample type's instantiation, a float window's margin the same in
    any batch."""
    eng = engine.ServingEngine(session["classifier"], device="cpu")
    eng.warmup()
    w32 = session["windows"][0]
    preds, margins = eng.execute([w32, w32], np.ones(3, np.float32))
    assert preds.shape == margins.shape == (2,) and margins[0] == margins[1]
    assert eng.execute([np.zeros((3, 850), np.int16)], np.ones(3, np.float32))[1].shape == (1,)
    assert eng.execute([w32], np.ones(3, np.float32))[1][0] == margins[0]


def _dequantized_tenant(template, stack, lane):
    """``template`` with the weights of row ``lane`` of the served f32
    stack: the solo twin of a quantized-stack tenant."""
    clone = registry.create("logreg")
    clone.model = linear.LinearModel(stack[lane].cpu().contiguous(),
                                     float(template.model.intercept))
    clone.margin_threshold = template.margin_threshold
    return clone


@pytest.mark.parametrize("weights_precision", ["f32", "int8", "int4"])
def test_float_multiplexed_tenants_equal_solo_services(session, weights_precision):
    """Four tenants on float windows: each tenant's margins and
    predictions bit-equal to a solo service serving its (dequantized)
    weights."""
    base = session["classifier"]
    rng = np.random.RandomState(9)
    tenants = {"t0": base}
    for i in range(1, 4):
        clf = registry.create("logreg")
        w = base.model.weight.numpy() + rng.randn(48).astype(np.float32) * 0.05
        clf.model = linear.LinearModel(torch.from_numpy(w.astype(np.float32)),
                                       float(base.model.intercept))
        tenants[f"t{i}"] = clf
    windows, res = session["windows"], session["resolutions"]
    mix = [f"t{i % 4}" for i in range(len(windows))]
    svc = MultiplexedService(tenants, config=ServeConfig(max_batch=64),
                             weights_precision=weights_precision, device="cpu")
    with svc:
        assert svc.engine.rung == "mega"
        assert svc.engine.weights_precision == weights_precision
        served = svc.predict_all(windows, res, mix)
        stack = svc.engine._f32_stack(svc.engine._stack)
        lanes = {name: svc.engine.tenant_info(name)["lane"] for name in tenants}
    for name, clf in tenants.items():
        solo_clf = _dequantized_tenant(clf, stack, lanes[name])
        with InferenceService(solo_clf, config=ServeConfig(max_batch=64), device="cpu") as solo:
            alone = solo.predict_all(windows, res)
        rows = [i for i, t in enumerate(mix) if t == name]
        assert [served[i].margin for i in rows] == [alone[i].margin for i in rows]
        assert [served[i].prediction for i in rows] == [alone[i].prediction for i in rows]


def test_float_adapt_gate_off_equals_plain_serve_and_jax(session, tmp_path):
    """serve=true&adapt=true&swap_gate=off on the float session: the
    adapter featurizes the float feedback windows through the fused rung
    (K1-f32's plain version), and the statistics are the plain serve
    run's and the JAX package's same query's; the lifecycle block's
    counts are the JAX package's."""
    import json

    base = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
            f"&load_clf=logreg&load_name={session['models']['logreg']}")
    knobs = "&adapt=true&swap_gate=off&drift_window=16&adapt_batch=8"
    plain = PipelineBuilder(base, device="cpu").execute()
    builder = PipelineBuilder(base + knobs, device="cpu")
    adapted = builder.execute()
    report = str(tmp_path / "report")
    theirs = JaxBuilder(base + knobs + f"&report={report}").execute()
    assert str(adapted) == str(plain) == str(theirs)
    block = builder.serve_block["lifecycle"]
    assert block["feedback"]["received"] == len(session["windows"])
    assert block["feedback"]["failures"] == 0 and block["swaps"] == 0
    with open(os.path.join(report, "run_report.json")) as f:
        jax_block = json.load(f)["lifecycle"]
    for key in ("feedback", "candidate", "live_window", "baseline_cost", "gate", "swaps",
                "config", "state"):
        assert block[key] == jax_block[key], key


def test_featurize_on_float_windows_equals_the_batch_rows(session):
    """The lifecycle's feedback rows of float windows are the batch
    path's rows of the same epochs (the fused rung on float samples)."""
    eng = engine.ServingEngine(session["classifier"], device="cpu")
    eng.warmup()
    n = 70  # past one capacity: two slices
    rows = eng.featurize(session["windows"][:n], session["resolutions"][0])
    feats, _ = OfflineDataProvider([session["info"]], device="cpu").load_features_device()
    assert rows.dtype == np.float32 and rows.shape == (n, 48)
    np.testing.assert_allclose(rows, feats[:n].numpy(), rtol=0, atol=1e-6)


# -- the plain float32 margins against the JAX package's megakernel --------


def _float_windows(n, seed, dc=(12000, -9000, 6000), res=0.1):
    """Float32 windows of int16 noise over a DC offset, scaled by ``res``:
    what an INT_16 recording's windows are once staged as float32."""
    rng = np.random.RandomState(seed)
    return [((rng.randint(-3000, 3000, size=(3, 850)) + np.asarray(dc)[:, None])
             * np.float32(res)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("lowering", ["pallas", "xla"])
@pytest.mark.parametrize("precision", ["f32", "int8", "int4"])
def test_plain_float_mega_margins_match_jax_kernel(lowering, precision):
    cap = 64
    windows = _float_windows(cap, seed=5)
    ones = np.ones(3, np.float32)
    weights = np.random.RandomState(6).randn(48).astype(np.float32)
    stride = serve_mega.padded_stride(100, 750)
    stream = serve_mega.stage_mega_stream(windows, 3, 850, stride, cap)
    assert stream.dtype == np.float32
    ours = serve_mega.make_serve_mega_program(capacity=cap, precision=precision)(
        torch.from_numpy(stream), torch.from_numpy(ones), torch.from_numpy(weights)).numpy()
    if precision == "f32":
        program = jax_serve_mega.make_serve_mega_program(
            capacity=cap, lowering=lowering, interpret=True, donate=False)
        theirs = np.asarray(program(jax.device_put(stream), ones, weights))
        tol = jax_serve_mega.MEGA_GATE_TOL
    else:
        # the reference's quantized Pallas megakernel does not trace in
        # interpret mode (ROADMAP.md C4): its function is the masked
        # quantizer on the reference's f32 rows, then the dot
        feats = np.asarray(jax_decode.make_decode_ingest_featurizer(formulation="slice")(
            stream, ones, (np.arange(cap) * stride + 100).astype(np.int32),
            np.ones(cap, bool)))
        masks = jax_quant.subband_lane_masks(3, 16)
        qmax = 127.0 if precision == "int8" else 7.0
        theirs = np.asarray(jax_quant.masked_quantize_dequantize(
            jax.numpy.asarray(feats), masks, qmax)) @ weights
        tol = decode_ingest.precision_gate_tolerance(precision)
    dev = float(np.max(np.abs(ours - theirs)))
    print(f"float32 mega {precision} {lowering}: max abs dev {dev:.3e}")
    assert ours.shape == (cap,) and dev <= tol


def test_float_mega_wrapper_takes_float32_and_counts_nothing_on_cpu():
    from eeg_dataanalysispackage_tpu_torch.ops import dwt, serve_mega_cuda

    stride = serve_mega.padded_stride(100, 750)
    stream = torch.from_numpy(serve_mega.stage_mega_stream(_float_windows(3, 1), 3, 850,
                                                           stride, 64))
    W = dwt.kernel_operator(8, 512, 16, torch.device("cpu"))
    ones, w = torch.ones(3), torch.randn(48)
    names = [n for n in dir(serve_mega_cuda) if n.endswith("_F32S")]
    assert len(names) == 12
    before = {n: getattr(serve_mega_cuda, n) for n in names}
    got = serve_mega_cuda.serve_mega_margins(stream, ones, W, w, 100, 175, stride)
    want = serve_mega.serve_mega_margins_plain(stream, ones, W, w, 100, 175, stride)
    assert got.numpy().tobytes() == want.numpy().tobytes()
    lanes = torch.zeros(64, dtype=torch.int32)
    serve_mega_cuda.serve_mega_multi_margins(stream, ones, W, torch.randn(128, 48), lanes,
                                             100, 175, stride)
    assert {n: getattr(serve_mega_cuda, n) for n in names} == before
    with pytest.raises(ValueError, match="int16 or float32"):
        serve_mega_cuda.serve_mega_margins(stream.double(), ones, W, w, 100, 175, stride)


# -- the host-extractor mode -----------------------------------------------


def _host_windows(dtype, pre, n=40, seed=11):
    rng = np.random.RandomState(seed)
    x = rng.randint(-3000, 3000, size=(n, 3, pre + 750)) + np.asarray([900, -700, 500])[:, None]
    if dtype == "float32":
        return [(w * np.float32(0.1)).astype(np.float32) for w in x]
    return [w.astype(np.int16) for w in x]


@pytest.mark.parametrize("fe", ["dwt-8", "dwt-8-pallas"])
@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("pre", [100, 0])
def test_host_extractor_engine_equals_jax(session, fe, dtype, pre):
    windows = _host_windows(dtype, pre)
    res = np.full(3, 0.1 if dtype == "int16" else 1.0, np.float32)
    ours = engine.ServingEngine(session["classifier"], pre=pre, device="cpu",
                                host_extractor=fe_registry.create(fe, device="cpu"))
    jax_clf = jax_registry.create("logreg")
    jax_clf.load(session["models"]["logreg"])
    theirs = jax_engine.ServingEngine(jax_clf, pre=pre,
                                      host_extractor=jax_fe_registry.create(fe))
    ours.warmup()
    theirs.warmup()
    assert (ours.mode, ours.rung) == (theirs.mode, theirs.rung) == ("host-extractor", "host")
    assert ours.precision_record is theirs.precision_record is None
    assert ours.mega_record is theirs.mega_record is None
    launches = dwt_cuda.LAUNCHES
    preds, margins = ours.execute(windows, res)
    jax_preds, jax_margins = theirs.execute(windows, res)
    assert margins is None and jax_margins is None
    assert preds.dtype == np.float64
    np.testing.assert_array_equal(preds, np.asarray(jax_preds))
    rows, jax_rows = ours.featurize(windows, res), theirs.featurize(windows, res)
    assert rows.dtype == np.asarray(jax_rows).dtype == np.float32
    dev = float(np.max(np.abs(rows - np.asarray(jax_rows))))
    print(f"host extractor {fe} {dtype} pre={pre}: max feature dev {dev:.3e}")
    assert rows.shape == (len(windows), 48) and dev <= 2e-6
    assert dwt_cuda.LAUNCHES == launches  # the plain version on the CPU


@pytest.mark.parametrize("precision", ["bf16", "int8", "int4"])
def test_host_extractor_records_host_f64(session, precision):
    fe = fe_registry.create("dwt-8", device="cpu")
    with InferenceService(session["classifier"], host_extractor=fe, precision=precision,
                          device="cpu") as svc:
        assert svc.engine.rung == "host" and svc.engine._fused is None
        record = svc.engine.precision_record
        served = svc.predict_all(session["windows"][:20], session["resolutions"][:20])
        block = svc.stats_block()
    jax_clf = jax_registry.create("logreg")
    jax_clf.load(session["models"]["logreg"])
    theirs = jax_engine.ServingEngine(jax_clf, host_extractor=jax_fe_registry.create("dwt-8"),
                                      precision=precision)
    theirs.warmup()
    assert record == theirs.precision_record == {"requested": precision, "used": "host-f64",
                                                 "gate": None}
    assert block["mode"] == "host-extractor" and block["rung"] == "host"
    assert block["precision"] == record and block["mega"] is None
    assert all(r.margin is None for r in served)
    want = theirs.execute(session["windows"][:20], session["resolutions"][0])[0]
    np.testing.assert_array_equal([r.prediction for r in served], want)
