"""The port's online serving path against the JAX package, on the CPU.

A model trained and saved by the JAX package serves through the port's
``InferenceService(device="cpu")``: its predictions must equal the JAX
package's ``InferenceService.predict_all`` and the port's batch
predictions, and ``serve=true`` statistics must be ``str``-equal to the
JAX package's ``serve=true`` and to the port's batch ``load_clf=`` run.
Below that, the batcher's contracts (coalescing, shedding with
evidence, backpressure, deadlines, watchdog, retries, drain) and the
engine's (one shape for every batch size, the warmup gate, no
step-down). Every service runs under a context manager or a
``try/finally`` stop, with bounded ``result(timeout=...)`` waits.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.serve import InferenceService as JaxService
from eeg_dataanalysispackage_tpu.serve import engine as jax_engine
from eeg_dataanalysispackage_tpu.epochs.extractor import BalanceState as JaxBalance
from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
from eeg_dataanalysispackage_tpu_torch.features import registry as fe_registry
from eeg_dataanalysispackage_tpu_torch.io import deadline as deadline_mod
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import registry
from eeg_dataanalysispackage_tpu_torch.obs import metrics_export
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import (
    InferenceService,
    RequestFailedError,
    ServeConfig,
    ServiceClosedError,
    ServiceWedgedError,
    ShedError,
    batcher as batcher_mod,
    engine,
    pipeline as serve_pipeline,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

_CONFIG = (
    "&config_num_iterations=20&config_step_size=1.0"
    "&config_mini_batch_fraction=1.0"
)
_WINDOW = np.zeros((3, 850), np.int16)
_RES = np.ones(3, np.float32)


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The JAX package's serve fixture: two synthetic files x 90
    markers, a logreg and an svm model trained and saved by the JAX
    package, the port's windows and its batch predictions."""
    tmp = tmp_path_factory.mktemp("torch_serve_session")
    for i, (name, guessed) in enumerate((("synth_00", 2), ("synth_01", 5))):
        _synthetic.write_recording(str(tmp), name=name, n_markers=90,
                                   guessed=guessed, seed=i)
    info = str(tmp / "info.txt")
    with open(info, "w") as f:
        f.write("synth_00.eeg 2\nsynth_01.eeg 5\n")
    models = {}
    for clf in ("logreg", "svm"):
        models[clf] = str(tmp / f"model_{clf}")
        JaxBuilder(
            f"info_file={info}&fe=dwt-8-fused&train_clf={clf}"
            f"&save_clf=true&save_name={models[clf]}&cache=false{_CONFIG}"
        ).execute()
    odp = OfflineDataProvider([info], device="cpu")
    balance = BalanceState()
    windows, targets, resolutions = [], [], None
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, resolutions = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed,
            pre=odp.pre, post=odp.post, balance=balance,
        )
        windows.extend(ws)
        targets.append(ts)
    features, _ = OfflineDataProvider([info], device="cpu").load_features_device()
    classifier = registry.create("logreg")
    classifier.load(models["logreg"])
    return {
        "info": info,
        "models": models,
        "model": models["logreg"],
        "classifier": classifier,
        "windows": windows,
        "targets": np.concatenate(targets),
        "resolutions": resolutions,
        "batch_predictions": classifier.predict(features).numpy(),
    }


def _service(session, **config_kwargs) -> InferenceService:
    return InferenceService.from_saved(
        "logreg", session["model"], device="cpu",
        config=ServeConfig(**config_kwargs) if config_kwargs else None,
    )


# -- against the JAX package ----------------------------------------------


def test_windows_from_recording_equal_jax_package(session):
    odp = jax_provider.OfflineDataProvider([session["info"]])
    balance = JaxBalance()
    want, want_targets = [], []
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, res = jax_engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed,
            pre=odp.pre, post=odp.post, balance=balance,
        )
        want.extend(ws)
        want_targets.append(ts)
        assert res.tobytes() == session["resolutions"].tobytes()
    assert len(want) == len(session["windows"]) == len(session["batch_predictions"])
    for got, exp in zip(session["windows"], want):
        assert got.dtype == exp.dtype == np.int16
        assert got.tobytes() == exp.tobytes()
    np.testing.assert_array_equal(session["targets"], np.concatenate(want_targets))


def test_served_predictions_equal_jax_service_and_port_batch(session):
    with _service(session) as svc:
        assert svc.engine.rung == "mega"
        served = [r.prediction for r in svc.predict_all(session["windows"],
                                                        session["resolutions"])]
    with JaxService.from_saved("logreg", session["model"]) as jax_svc:
        jax_served = [r.prediction for r in jax_svc.predict_all(
            session["windows"], session["resolutions"])]
    np.testing.assert_array_equal(served, jax_served)
    np.testing.assert_array_equal(served, session["batch_predictions"])
    block = svc.stats_block()
    assert block["requests"]["completed"] == len(session["windows"])
    assert block["drained_cleanly"] is True
    assert block["mega"]["used"] == "mega" and block["mega"]["lowering"] == "plain"
    assert block["mega"]["gate"]["ok"]
    assert block["lifecycle"] is None and block["precision"] is None


@pytest.mark.parametrize("clf", ["logreg", "svm"])
def test_serve_statistics_equal_jax_serve_and_port_batch(session, clf, tmp_path):
    base = (
        f"info_file={session['info']}&fe=dwt-8-fused"
        f"&load_clf={clf}&load_name={session['models'][clf]}"
    )
    batch = str(PipelineBuilder(base, device="cpu").execute())
    builder = PipelineBuilder(base + f"&serve=true&result_path={tmp_path}/serve.txt",
                              device="cpu")
    served = str(builder.execute())
    jax_served = str(JaxBuilder(base + "&serve=true").execute())
    assert served == jax_served == batch
    assert (tmp_path / "serve.txt").read_text() == served + "\n"
    block = builder.serve_block
    n = len(session["windows"])
    assert block["rung"] == "mega"
    assert block["requests"]["completed"] == block["requests"]["total_epochs"] == n
    assert block["requests"]["shed"] == 0 and block["drained_cleanly"] is True
    assert block["latency_ms"]["p99"] >= block["latency_ms"]["p50"] > 0.0
    assert block["slo"]["requests_observed"] == n
    assert sorted(builder.timers) == ["ingest", "serve", "test"]


def test_serve_threshold_knob(session):
    q = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
         f"&load_clf=logreg&load_name={session['model']}&serve_threshold=1e9")
    builder = PipelineBuilder(q, device="cpu")
    stats = builder.execute()
    assert stats.true_positives == 0 and stats.false_negatives == 0  # swapped fp/fn report
    assert builder.serve_block["serve_threshold"] == 1e9


def test_conflicts_raise_the_reference_messages(session):
    info = f"info_file={session['info']}&serve=true"
    load = f"&load_clf=logreg&load_name={session['model']}"
    fused = info + "&fe=dwt-8-fused"
    for query in (fused + "&train_clf=logreg", fused + load + "&elastic=true",
                  fused + load + "&save_clf=true", fused + load + "&cv=3",
                  fused + load + "&seeds=3", fused + "&classifiers=logreg,svm", fused,
                  fused + "&load_clf=logreg", info + "&fe=dwt-8" + load):
        with pytest.raises(ValueError) as ours:
            PipelineBuilder(query, device="cpu").execute()
        with pytest.raises(ValueError) as theirs:
            JaxBuilder(query).execute()
        assert str(ours.value) == str(theirs.value), query


@pytest.mark.parametrize(
    "extra,match",
    # adapt=true itself runs (tests/test_torch_lifecycle.py); a run's
    # faults= spec naming a point the port has no site for does not
    [pytest.param("adapt=true&faults=staging.producer:once@1",
                  "fault point 'staging.producer' is not yet ported", id="adapt=true")]
    # a serve fault is retried and report= writes its report (under the
    # test's own directory): both serve the batch run's statistics
    + [pytest.param(e, None, id=e)
       for e in ("faults=serve.batch:once@1", "report=/tmp/never")]
    # task=seizure serves (tests/test_torch_seizure.py) host-extracted
    # features: a -fused fe= raises the JAX package's refusal
    + [pytest.param("task=seizure", "task=seizure serves host-extracted features; fe= must "
                    "be a registry form, not a -fused mode", id="task=seizure")]
    # explicit no-ops of the training modes serve, as in the JAX package
    + [pytest.param("save_clf=false&elastic=false", None, id="save_clf=false&elastic=false")]
    # precision=bf16 serves (tests/test_torch_precision.py); a precision
    # outside the ladder raises the JAX package's message
    + [pytest.param("precision=f16", "must be f32, bf16, int8, or int4", id="precision=bf16")],
)
def test_unported_serve_keys_raise(session, extra, match, tmp_path):
    extra = extra.replace("/tmp/never", str(tmp_path / "never"))
    q = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
         f"&load_clf=logreg&load_name={session['model']}&{extra}")
    if match is None:
        batch = q.replace("&serve=true", "")
        assert str(PipelineBuilder(q, device="cpu").execute()) == str(
            PipelineBuilder(batch, device="cpu").execute())
        return
    with pytest.raises(ValueError, match=match):
        PipelineBuilder(q, device="cpu").execute()


def test_serve_other_than_true_is_not_ported(session):
    """``serve=`` with a value other than ``true`` is not the serving
    mode: it runs the batch path (train or load), as the JAX package
    does, with the JAX package's statistics. (The name is kept from when
    the port refused such a value.)"""
    for clf_mode in ("train_clf=logreg", "load_clf=logreg"):
        q = (f"info_file={session['info']}&fe=dwt-8-fused&{clf_mode}"
             f"&load_name={session['model']}&serve=false&cache=false{_CONFIG}")
        ours = PipelineBuilder(q, device="cpu")
        assert str(ours.execute()) == str(JaxBuilder(q).execute()), clf_mode
        assert ours.serve_block is None


def test_no_silent_cpu_without_cuda(session):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        InferenceService(session["classifier"])
    q = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
         f"&load_clf=logreg&load_name={session['model']}")
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineBuilder(q)


def test_unported_engine_inputs_raise(session):
    clf = session["classifier"]
    with pytest.raises(ValueError, match="engine_rung"):
        engine.ServingEngine(clf, engine_rung="turbo", device="cpu")
    # int8 is served (tests/test_torch_precision.py); a bf16 engine pinned
    # to the mega rung stays on fused: bf16 has no megakernel
    bf16 = engine.ServingEngine(clf, precision="bf16", engine_rung="mega", device="cpu")
    bf16.warmup()
    assert bf16.rung == "fused" and bf16.mega_record is None
    with pytest.raises(ValueError, match="unknown precision"):
        engine.ServingEngine(clf, precision="f16", device="cpu")
    # the host-extractor mode is served (tests/test_torch_serve_float.py):
    # the engine is pinned to the host rung and builds no kernel
    host = InferenceService(clf, host_extractor=fe_registry.create("dwt-8", device="cpu"),
                            device="cpu")
    assert (host.engine.rung, host.engine.mode) == ("host", "host-extractor")
    # an untrained classifier is served as the JAX package serves it: the
    # featurize+host mode, whose warmup predict raises the classifier's own
    # message (the refusal this check pinned before nn serving was ported)
    from eeg_dataanalysispackage_tpu.models import registry as jax_registry
    untrained = engine.ServingEngine(registry.create("logreg"), device="cpu")
    jax_untrained = jax_engine.ServingEngine(jax_registry.create("logreg"))
    assert untrained.mode == jax_untrained.mode == "featurize+host"
    with pytest.raises(ValueError) as ours_err:
        untrained.warmup()
    with pytest.raises(ValueError) as jax_err:
        jax_untrained.warmup()
    assert str(ours_err.value) == str(jax_err.value) == "model not trained or loaded"
    assert untrained.mega_record is None
    eng = engine.ServingEngine(clf, capacity=4, device="cpu")
    assert eng.capacity == 64
    with pytest.raises(ValueError, match="shape"):
        eng.execute([np.zeros((3, 10), np.int16)], _RES)
    # float32 windows are served (tests/test_torch_serve_float.py); other
    # dtypes, and a batch mixing the two, are refused
    with pytest.raises(ValueError, match="int16 or float32"):
        eng.execute([_WINDOW.astype(np.float64)], _RES)
    with pytest.raises(ValueError, match="of one dtype"):
        eng.execute([_WINDOW, _WINDOW.astype(np.float32)], _RES)
    with pytest.raises(ValueError, match="capacity"):
        eng.execute([_WINDOW] * 65, _RES)
    preds, _ = eng.execute([], _RES)
    assert preds.shape == (0,)


# -- the engine ------------------------------------------------------------


@pytest.mark.parametrize("rung", ["auto", "mega", "fused"])
def test_one_shape_serves_every_batch_size(session, rung):
    eng = engine.ServingEngine(session["classifier"], capacity=8, engine_rung=rung,
                               device="cpu")
    eng.warmup()
    assert eng.rung == ("fused" if rung == "fused" else "mega")
    assert (eng.mega_record is None) == (rung == "fused")
    p1, m1 = eng.execute([session["windows"][0]], session["resolutions"])
    p8, m8 = eng.execute(session["windows"][:8], session["resolutions"])
    assert p1.shape == (1,) and p8.shape == (8,)
    assert m8[0] == m1[0]
    np.testing.assert_array_equal(p8, session["batch_predictions"][:8])


def test_mega_and_fused_services_agree(session):
    windows = session["windows"][:40]
    out = {}
    for rung in ("mega", "fused"):
        with InferenceService(session["classifier"], engine_rung=rung, device="cpu") as svc:
            out[rung] = [r.prediction for r in svc.predict_all(windows, session["resolutions"])]
    assert out["mega"] == out["fused"]


def test_failed_warmup_gate_raises(session, monkeypatch):
    monkeypatch.setenv("EEG_TPU_MEGA_GATE_TOL", "-1")
    svc = InferenceService(session["classifier"], device="cpu")
    with pytest.raises(RuntimeError, match="warmup gate failed"):
        svc.start()
    record = svc.engine.mega_record
    assert record["used"] == "fused" and record["gate"]["ok"] is False
    assert svc.engine.rung == "fused"


def test_mega_failure_is_not_stepped_down(session):
    """A mega failure mid-residency goes to the batcher's retries and
    then fails the request with its history; the engine stays on mega."""
    with _service(session, max_attempts=2, retry_backoff_s=0.01) as svc:
        real = svc.engine._mega_program

        def broken(*args):
            raise RuntimeError("mega kernel broke")

        svc.engine._mega_program = broken
        fut = svc.submit(session["windows"][0], session["resolutions"])
        with pytest.raises(RequestFailedError, match="attempt 2"):
            fut.result(timeout=10.0)
        assert svc.engine.rung == "mega"
        svc.engine._mega_program = real
        r = svc.predict_window(session["windows"][0], session["resolutions"])
        assert r.prediction == session["batch_predictions"][0]
    block = svc.stats_block()
    assert block["requests"]["failed"] == 1 and block["batch_failures"] == 2


def test_retry_absorbs_one_failure(session):
    with _service(session, retry_backoff_s=0.01) as svc:
        real, calls = svc.batcher._execute, {"n": 0}

        def flaky(*args):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
            return real(*args)

        svc.batcher._execute = flaky
        r = svc.submit(session["windows"][1], session["resolutions"]).result(timeout=10.0)
        assert r.attempts == 2 and r.prediction == session["batch_predictions"][1]
    assert svc.stats_block()["requests"]["retries"] == 1


# -- the batcher -----------------------------------------------------------


def test_concurrent_submits_coalesce_into_batches(session):
    windows = session["windows"]
    with _service(session, coalesce_s=0.02) as svc:
        futs = [
            svc.submit(windows[i % len(windows)], session["resolutions"], block_s=5.0)
            for i in range(64)
        ]
        results = [f.result(timeout=30.0) for f in futs]
    block = svc.stats_block()
    assert block["requests"]["completed"] == 64
    assert block["batches"] < 64 and block["mean_batch_size"] > 1
    assert any(r.batch_size > 1 for r in results)
    for i, r in enumerate(results):
        assert r.prediction == session["batch_predictions"][i % len(windows)]


def test_flush_window_fills_the_bucket(session):
    with _service(session, max_batch=8, coalesce_s=0.0, flush_us=200_000) as svc:
        futs = [svc.submit(session["windows"][i], session["resolutions"]) for i in range(8)]
        results = [f.result(timeout=10.0) for f in futs]
    assert all(r.batch_size == 8 for r in results)


def test_admission_shed_with_evidence(session):
    with _service(session, max_batch=2, queue_depth=1, coalesce_s=0.2) as svc:
        shed = 0
        for _ in range(16):
            try:
                svc.submit(_WINDOW, _RES)
            except ShedError as e:
                shed += 1
                assert "queue at depth 1" in str(e)
                assert e.evidence["reason"] == "queue_full"
                assert e.evidence["depth_limit"] == 1
        assert shed > 0
        assert svc.stats_block()["requests"]["shed"] == shed


def test_blocking_submit_cooperates_with_backpressure(session):
    with _service(session, queue_depth=4) as svc:
        futs = [
            svc.submit(session["windows"][i % len(session["windows"])],
                       session["resolutions"], block_s=10.0)
            for i in range(32)
        ]
        for f in futs:
            f.result(timeout=30.0)
    assert svc.stats_block()["requests"]["shed"] == 0


def test_deadline_expired_in_queue_fails_fast(session):
    block = threading.Event()
    svc = _service(session, watchdog_s=30.0)
    real_execute = svc.batcher._execute
    svc.batcher._execute = lambda *a: (block.wait(30), real_execute(*a))[1]
    svc.start()
    try:
        f1 = svc.submit(_WINDOW, _RES, deadline_s=60.0)
        f2 = svc.submit(_WINDOW, _RES, deadline_s=0.001)
        time.sleep(0.1)
        block.set()
        f1.result(timeout=30.0)
        with pytest.raises(deadline_mod.DeadlineExceededError, match="admission queue"):
            f2.result(timeout=30.0)
        assert svc.stats_block()["requests"]["deadline_exceeded"] == 1
    finally:
        block.set()
        svc.stop(drain=False)


def test_watchdog_fails_wedged_requests_fast(session):
    wedge = threading.Event()
    svc = _service(session, watchdog_s=0.3, drain_timeout_s=0.5)
    svc.batcher._execute = lambda *a, **k: wedge.wait(60) and None
    svc.start()
    try:
        fut = svc.submit(_WINDOW, _RES)
        with pytest.raises(ServiceWedgedError, match="heartbeat"):
            fut.result(timeout=10.0)
        with pytest.raises(ServiceWedgedError):
            svc.submit(_WINDOW, _RES)
        block = svc.stats_block()
        assert block["watchdog_trips"] == 1 and block["wedged"] is True
        # a request landing after the trip is still swept and failed
        late = batcher_mod.Request(window=_WINDOW, resolutions=_RES,
                                   deadline=deadline_mod.Deadline(30.0))
        svc.batcher.queue.readmit(late)
        with pytest.raises(ServiceWedgedError, match="tripped earlier"):
            late.future.result(timeout=5.0)
    finally:
        wedge.set()
        svc.stop(drain=False)


def test_graceful_drain_completes_in_flight_rejects_new(session):
    svc = _service(session)
    svc.start()
    futs = [svc.submit(session["windows"][i], session["resolutions"], block_s=5.0)
            for i in range(16)]
    assert svc.stop(drain=True) is True
    for i, f in enumerate(futs):
        assert f.result(timeout=1.0).prediction == session["batch_predictions"][i]
    with pytest.raises(ServiceClosedError, match="not accepting"):
        svc.submit(_WINDOW, _RES)
    assert svc.stats_block()["drained_cleanly"] is True


def test_mixed_resolutions_never_share_a_batch(session):
    other = session["resolutions"] * 2
    with _service(session, coalesce_s=0.05) as svc:
        futs = [svc.submit(session["windows"][i], session["resolutions"] if i % 2 else other)
                for i in range(8)]
        results = [f.result(timeout=10.0) for f in futs]
    # alternating keys: every head-key run is one request long
    assert all(r.batch_size == 1 for r in results)


def test_many_callers_lose_no_request_or_count(session):
    """More callers than cores under a short switch interval: every
    request is answered correctly and no counter update is lost."""
    from concurrent.futures import ThreadPoolExecutor

    windows, n_calls = session["windows"], 10
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _service(session, queue_depth=64) as svc:
            def caller(t):
                rows = [(t * 7 + i) % len(windows) for i in range(n_calls)]
                return rows, [svc.predict_window(windows[r], session["resolutions"],
                                                 deadline_s=30.0).prediction for r in rows]

            with ThreadPoolExecutor(32) as pool:
                outs = list(pool.map(caller, range(32)))
    finally:
        sys.setswitchinterval(old)
    for rows, preds in outs:
        np.testing.assert_array_equal(preds, session["batch_predictions"][rows])
    block = svc.stats_block()
    total = 32 * n_calls
    assert block["requests"]["submitted"] == block["requests"]["completed"] == total
    assert block["latency_ms"]["n"] == block["slo"]["requests_observed"] == total


# -- the port's copies of the JAX package's helpers -----------------------


def test_deadline_and_histogram_equal_jax_package():
    from eeg_dataanalysispackage_tpu.io import deadline as jax_deadline
    from eeg_dataanalysispackage_tpu.obs import metrics_export as jax_metrics

    now = [100.0]
    d = deadline_mod.Deadline(2.0, clock=lambda: now[0])
    jd = jax_deadline.Deadline(2.0, clock=lambda: now[0])
    for t in (100.0, 101.5, 102.0, 103.0):
        now[0] = t
        assert (d.remaining(), d.expired, d.can_cover(0.5)) == (
            jd.remaining(), jd.expired, jd.can_cover(0.5))
    assert issubclass(deadline_mod.DeadlineExceededError, TimeoutError)
    ours, theirs = metrics_export.LatencyHistogram(), jax_metrics.LatencyHistogram()
    for ms in (0.2, 0.5, 3.0, 49.9, 50.0, 51.0, 4000.0):
        ours.observe(ms)
        theirs.observe(ms)
    assert ours.snapshot() == theirs.snapshot()
    for q in (50, 99):
        assert ours.quantile(q) == theirs.quantile(q)
    merged = metrics_export.LatencyHistogram.from_snapshot(ours.snapshot()).merge(ours)
    assert merged.count == 2 * ours.count
    counts = {"completed": 90, "shed": 5, "failed": 3, "deadline_exceeded": 2}
    assert metrics_export.slo_block(ours, counts, 50.0, 0.99) == jax_metrics.slo_block(
        theirs, counts, 50.0, 0.99)


def test_config_knobs_parse_like_jax_package(monkeypatch):
    from eeg_dataanalysispackage_tpu.serve import pipeline as jax_pipeline

    q = {"serve_batch": "128", "serve_queue": "32", "serve_flush_us": "250",
         "serve_deadline_ms": "500", "serve_slo_ms": "20", "serve_slo_availability": "0.99"}
    ours, theirs = serve_pipeline.serve_config_from_query(q), \
        jax_pipeline.serve_config_from_query(q)
    for field in ("max_batch", "queue_depth", "flush_us", "default_deadline_s",
                  "slo_latency_ms", "slo_availability_target"):
        assert getattr(ours, field) == getattr(theirs, field), field
    monkeypatch.setenv("EEG_TPU_SERVE_FLUSH_US", "300")
    assert serve_pipeline.default_flush_us() == jax_pipeline.default_flush_us() == 300
    monkeypatch.setenv("EEG_TPU_SERVE_FLUSH_US", "soon")
    assert serve_pipeline.default_flush_us() == 0
    with pytest.raises(ValueError, match="must be an integer"):
        serve_pipeline.serve_config_from_query({"serve_batch": "many"})
    with pytest.raises(ValueError, match="must be a number"):
        serve_pipeline.serve_config_from_query({"serve_slo_ms": "fast"})


# -- a non-linear classifier (nn): the featurize+host mode -------------------

_NN_CONFIG = (
    "&config_seed=1&config_num_iterations=50&config_learning_rate=0.1"
    "&config_momentum=0.9&config_weight_init=xavier&config_updater=nesterovs"
    "&config_optimization_algo=stochastic_gradient_descent"
    "&config_pretrain=false&config_backprop=true&config_loss_function=xent"
    "&config_layer1_layer_type=dense&config_layer1_n_out=8"
    "&config_layer1_drop_out=0.0&config_layer1_activation_function=relu"
    "&config_layer2_layer_type=output&config_layer2_n_out=2"
    "&config_layer2_drop_out=0.0&config_layer2_activation_function=softmax"
)


@pytest.fixture(scope="module")
def nn_model(session, tmp_path_factory):
    """Configuration A trained and saved by the port on the session."""
    path = str(tmp_path_factory.mktemp("nn_model") / "model.nn")
    PipelineBuilder(f"info_file={session['info']}&fe=dwt-8-fused&train_clf=nn{_NN_CONFIG}"
                    f"&save_clf=true&save_name={path}", device="cpu").execute()
    return path


def test_nn_serve_statistics_equal_the_batch_load_run(session, nn_model, tmp_path):
    base = f"info_file={session['info']}&fe=dwt-8-fused&load_clf=nn&load_name={nn_model}"
    batch = PipelineBuilder(base, device="cpu")
    want = str(batch.execute())
    builder = PipelineBuilder(base + f"&serve=true&result_path={tmp_path}/serve.txt",
                              device="cpu")
    assert str(builder.execute()) == want
    assert (tmp_path / "serve.txt").read_text() == want + "\n"
    block = builder.serve_block
    assert (block["mode"], block["rung"], block["mega"]) == ("featurize+host", "fused", None)
    assert block["requests"]["completed"] == len(session["windows"])
    # the JAX package serves the same file in the same mode; predictions
    # agree within float32 rounding of the network's products
    jax_builder = JaxBuilder(base + "&serve=true")
    theirs = jax_builder.execute()
    ours = builder.statistics
    assert (ours.true_positives, ours.true_negatives, ours.false_positives,
            ours.false_negatives) == (theirs.true_positives, theirs.true_negatives,
                                      theirs.false_positives, theirs.false_negatives)
    np.testing.assert_allclose(ours.mse, theirs.mse, rtol=1e-4)


def test_nn_engine_predicts_on_the_fused_rows(session, nn_model):
    clf = registry.create("nn")
    clf.load(nn_model)
    eng = engine.ServingEngine(clf, capacity=64, device="cpu")
    eng.warmup()
    assert (eng.mode, eng.rung, eng.mega_record) == ("featurize+host", "fused", None)
    windows = session["windows"][:40]
    preds, margins = eng.execute(windows, session["resolutions"])
    assert margins is None and preds.dtype == np.float64
    feats = torch.from_numpy(eng.featurize(windows, session["resolutions"]))
    np.testing.assert_array_equal(preds, clf.predict(feats).numpy())
    from eeg_dataanalysispackage_tpu.models import registry as jax_registry
    jax_clf = jax_registry.create("nn")
    jax_clf.load(nn_model)
    jax_eng = jax_engine.ServingEngine(jax_clf)
    assert jax_eng.mode == eng.mode and jax_eng.mega_record is None
    # a hot swap into this engine takes any classifier with a predict
    assert eng.swap_model(registry.create("nn")) is clf


def test_nn_serve_refusals_match_jax(session, nn_model):
    base = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
            f"&load_clf=nn&load_name={nn_model}")
    for extra in ("&serve_threshold=0.3", "&adapt=true&swap_gate=off"):
        with pytest.raises(ValueError) as ours:
            PipelineBuilder(base + extra, device="cpu").execute()
        with pytest.raises(ValueError) as theirs:
            JaxBuilder(base + extra).execute()
        assert str(ours.value) == str(theirs.value), extra
    from eeg_dataanalysispackage_tpu.models import registry as jax_registry
    from eeg_dataanalysispackage_tpu.serve import multiplex as jax_multiplex
    from eeg_dataanalysispackage_tpu_torch.serve import multiplex
    clf, jax_clf = registry.create("nn"), jax_registry.create("nn")
    clf.load(nn_model)
    jax_clf.load(nn_model)
    with pytest.raises(ValueError) as ours:
        multiplex.MultiplexedEngine({"a": clf}, device="cpu")
    with pytest.raises(ValueError) as theirs:
        jax_multiplex.MultiplexedEngine({"a": jax_clf})
    assert str(ours.value) == str(theirs.value)
