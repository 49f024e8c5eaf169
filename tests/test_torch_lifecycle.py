"""The port's serving model lifecycle against the JAX package's, on the CPU.

``serve/lifecycle.py``: streaming partial fit on labeled feedback,
shadow-scored hot swap with rollback, drift detection and resumable
candidate checkpoints. The pins:

- the windowed statistics, the ``swap_gate=`` grammar, the query knobs
  and their refusals equal the JAX package's, messages included;
- a manager of each package, fed one deterministic stream through an
  identity featurizer and a stub engine, trains candidate weights within
  1e-5 of each other after every batch (the SGD tolerance) and makes the
  same gate decisions, swaps, rollbacks and drift events; a decision may
  differ only where its margin lies within 1e-4 of the threshold in both
  (such rows are counted, and with them the block counts may differ);
- ``serve=true&adapt=true&swap_gate=off`` gives statistics byte-identical
  to the plain serve run and to the JAX package's same query;
- a promoted model serves what the batch run of its ``promoted.npz``
  predicts, loaded in either package;
- a failed swap, a rollback, drift, closing, a wedged adapter and a swap
  during an in-flight batch behave as the JAX package's tests pin them;
- an adapter SIGKILLed after its 3rd checkpoint resumes to candidate
  weights byte-equal to an uninterrupted twin's, and either package
  resumes the other's checkpoints.

Small sessions (2 recordings x 90 markers) and no sleeps; every wait is
bounded.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.models import registry as jax_registry
from eeg_dataanalysispackage_tpu.models import stats as jax_stats
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.serve import lifecycle as jax_lifecycle
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import linear, registry, stats
from eeg_dataanalysispackage_tpu_torch.obs import chaos
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.serve import (
    InferenceService,
    LifecycleConfig,
    LifecycleManager,
    MultiplexedService,
    ServeConfig,
    ServiceClosedError,
    engine as engine_mod,
    lifecycle,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _lifecycle_worker  # noqa: E402
import _synthetic  # noqa: E402
import _torch_lifecycle_worker  # noqa: E402

_CONFIG = (
    "&config_num_iterations=20&config_step_size=1.0"
    "&config_mini_batch_fraction=1.0"
)
_WAIT = 60.0


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Two synthetic recordings x 90 markers, a logreg model trained and
    saved by the JAX package, the port's windows, targets and batch
    features, and the JAX package's batch features."""
    tmp = tmp_path_factory.mktemp("torch_lifecycle_session")
    for i, (name, guessed) in enumerate((("synth_00", 2), ("synth_01", 5))):
        _synthetic.write_recording(str(tmp), name=name, n_markers=90, guessed=guessed, seed=i)
    info = str(tmp / "info.txt")
    with open(info, "w") as f:
        f.write("synth_00.eeg 2\nsynth_01.eeg 5\n")
    model = str(tmp / "model")
    JaxBuilder(
        f"info_file={info}&fe=dwt-8-fused&train_clf=logreg"
        f"&save_clf=true&save_name={model}&cache=false{_CONFIG}"
    ).execute()
    odp = OfflineDataProvider([info], device="cpu")
    balance = BalanceState()
    windows, targets, resolutions = [], [], None
    for _rel, guessed, rec in odp.iter_recordings():
        ws, ts, resolutions = engine_mod.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, pre=odp.pre, post=odp.post,
            balance=balance,
        )
        windows.extend(ws)
        targets.append(ts)
    features, _ = OfflineDataProvider([info], device="cpu").load_features_device()
    jax_features, _ = jax_provider.OfflineDataProvider([info]).load_features_device(
        wavelet_index=8, backend="xla")
    classifier = registry.create("logreg")
    classifier.load(model)
    return {
        "info": info,
        "model": model,
        "windows": windows,
        "targets": np.concatenate(targets),
        "resolutions": resolutions,
        "batch_features": features,
        "jax_batch_features": np.asarray(jax_features),
        "batch_predictions": classifier.predict(features).numpy(),
    }


def _service(session, config=None, **lifecycle_kwargs) -> InferenceService:
    return InferenceService.from_saved(
        "logreg", session["model"], device="cpu", config=config,
        lifecycle=LifecycleConfig(**lifecycle_kwargs),
    )


def _feed_session(svc, session, repeats=1, flush=True, flip=False):
    for _ in range(repeats):
        for w, y in zip(session["windows"], session["targets"]):
            svc.feedback(w, session["resolutions"], 1.0 - float(y) if flip else float(y))
    if flush:
        assert svc.lifecycle.flush(timeout_s=_WAIT)


def _counter(name):
    return obs.metrics.snapshot()["counters"].get(name, 0.0)


# -- the host-side pieces -------------------------------------------------


@pytest.mark.parametrize("window,cost_fp,cost_fn", [(4, 1.0, 8.0), (16, 1.0, 1.0), (1, 2.5, 0.5)])
def test_windowed_statistics_match_jax(window, cost_fp, cost_fn):
    rng = np.random.RandomState(window)
    ours = stats.WindowedStatistics(window, cost_fp=cost_fp, cost_fn=cost_fn)
    theirs = jax_stats.WindowedStatistics(window, cost_fp=cost_fp, cost_fn=cost_fn)
    for w in (ours, theirs):
        assert np.isnan(w.expected_cost()) and np.isnan(w.recall()) and not w.full
    assert ours.summary() == theirs.summary()
    # half-up rounding on both the prediction and the label
    stream = list(zip(rng.choice([0.0, 0.49, 0.5, 1.0, 1.5], 40), rng.randint(0, 2, 40)))
    for i, (pred, label) in enumerate(stream):
        ours.add(pred, label)
        theirs.add(pred, label)
        assert ours.counts() == theirs.counts()
        assert ours.summary() == theirs.summary()
        assert ours.full == theirs.full and ours.n == theirs.n
        if i == 25:
            ours.reset()
            theirs.reset()
            assert ours.n == 0 and ours.seen == theirs.seen == 26
    assert ours.expected_cost() == theirs.expected_cost()


def test_windowed_statistics_refuse_an_empty_window():
    for cls in (stats.WindowedStatistics, jax_stats.WindowedStatistics):
        with pytest.raises(ValueError, match="window must be >= 1, got 0"):
            cls(0)


@pytest.mark.parametrize("value", ["off", "cost", "cost:2.5", "cost:0.25", "banana", "cost:x",
                                   "cost:0", "cost:-1", "cost:", "off:1"])
def test_parse_swap_gate_matches_jax(value):
    try:
        want = jax_lifecycle.parse_swap_gate(value)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            lifecycle.parse_swap_gate(value)
        assert str(ours.value) == str(e)
        return
    assert lifecycle.parse_swap_gate(value) == want


@pytest.mark.parametrize("query", [
    {}, {"adapt": "true"}, {"swap_gate": "off", "drift_window": "32"},
    {"swap_gate": "cost:1.5", "adapt_batch": "8", "adapt_iters": "5", "checkpoint_path": "/c"},
    {"adapt_batch": "0"}, {"adapt_iters": "x"}, {"drift_window": "-3"}, {"swap_gate": "nope"},
    {"checkpoint_path": ""},
])
def test_lifecycle_config_from_query_map_matches_jax(query):
    try:
        want = jax_lifecycle.LifecycleConfig.from_query_map(query, cost_fp=2.0, cost_fn=3.0)
    except ValueError as e:
        with pytest.raises(ValueError) as ours:
            LifecycleConfig.from_query_map(query, cost_fp=2.0, cost_fn=3.0)
        assert str(ours.value) == str(e)
        return
    got = LifecycleConfig.from_query_map(query, cost_fp=2.0, cost_fn=3.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


_BASE = "info_file=i.txt&fe=dwt-8-fused&load_clf=logreg&load_name=m"


@pytest.mark.parametrize("extra", [
    "serve=true&adapt=yes", "adapt=true", "serve=true&swap_gate=cost",
    "serve=true&adapt=true&swap_gate=nope", "serve=true&adapt=true&swap_gate=cost:0",
    "serve=true&adapt=true&swap_gate=cost:x", "serve=true&adapt=true&drift_window=0",
    "serve=true&drift_window=9", "serve=true&adapt=true&drift_window=x",
    "serve=true&adapt_batch=4", "adapt_iters=3", "serve=false&adapt=true",
])
def test_knob_grammar_refusals_carry_the_jax_messages(extra):
    """The JAX package's plan parser refuses each query; the port's
    builder refuses it with the same message, before reading anything."""
    query = f"{_BASE}&{extra}"
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(query)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(query, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("extra", [
    "checkpoint_path=/tmp/c", "serve=true&checkpoint_path=/tmp/c",
    "elastic=true&checkpoint_path=/tmp/c",
])
def test_checkpoint_path_outside_the_lifecycle_stays_refused(extra):
    """Since elastic training was ported, checkpoint_path= outside the
    lifecycle is what it is in the JAX package: elastic=true's directory,
    and ignored by a load or serve run. The query passes the JAX package's
    plan parser and the port's checks, and both packages fail alike on the
    missing session."""
    query = f"{_BASE}&{extra}"
    ExecutionPlan.parse(query)
    with pytest.raises(Exception) as theirs:
        JaxBuilder(query).execute()
    with pytest.raises(Exception) as ours:
        PipelineBuilder(query, device="cpu").execute()
    assert type(ours.value) is type(theirs.value) is FileNotFoundError


# -- the manager against the JAX package's, on one stream -----------------


class _StubEngine:
    """Just enough of a serving engine for a manager: the live
    classifier and its swap."""

    def __init__(self, classifier, device=None):
        self.classifier = classifier
        self.device = device

    def swap_model(self, classifier):
        old, self.classifier = self.classifier, classifier
        return old


def _recording(cls, live_weights, intercept_of):
    """``cls`` recording what each batch's shadow scoring saw."""

    class Recording(cls):
        def _score(self, feats, labels, cand_w_before):
            live = self.engine.classifier
            self.scored.append((
                np.array(feats), np.array(live_weights(live), np.float32),
                float(intercept_of(live)), float(live.margin_threshold),
                np.array(cand_w_before, np.float32),
            ))
            super()._score(feats, labels, cand_w_before)

    return Recording


def _stream(n_batches=24, batch=8, d=48, flip_from=8, seed=21):
    """Feature rows labeled by a fixed direction; from batch
    ``flip_from`` on the labels flip (the world drifts)."""
    rng = np.random.RandomState(seed)
    direction = rng.randn(d).astype(np.float32)
    out = []
    for b in range(n_batches):
        rows = rng.randn(batch, d).astype(np.float32) * 0.3
        labels = (rows @ direction > 0).astype(np.float64)
        if b >= flip_from:
            labels = 1.0 - labels
        out.append((rows, labels))
    return direction, out


def _identity(windows, _res):
    return np.stack([np.asarray(w, np.float32) for w in windows])


def test_manager_matches_jax_on_one_stream():
    """One stream through both packages' managers: after every batch the
    candidate weights agree within 1e-5, and the gate records, swaps,
    rollbacks, drift events and block counts are the same; the stream is
    built so that the run promotes, rolls back and drifts."""
    direction, stream = _stream()
    rng = np.random.RandomState(3)
    w_live = (direction + 0.6 * rng.randn(48).astype(np.float32)).astype(np.float32)
    config = {"config_num_iterations": "20", "config_step_size": "1.0",
              "config_mini_batch_fraction": "1.0"}
    ours_clf = linear.LogisticRegressionClassifier()
    ours_clf.set_config(config)
    ours_clf.model = linear.LinearModel(torch.from_numpy(w_live.copy()), 0.0)
    theirs_clf = jax_registry.create("logreg")
    theirs_clf.set_config(config)
    theirs_clf.weights = w_live.copy()
    theirs_clf.intercept = 0.0
    kwargs = dict(adapt_batch=8, adapt_iters=10, capacity=64, drift_window=16,
                  gate_mode="cost", gate_ratio=0.8, drift_factor=1.5)
    Ours = _recording(LifecycleManager, lambda c: c.model.weight.numpy(),
                      lambda c: c.model.intercept)
    Theirs = _recording(jax_lifecycle.LifecycleManager, lambda c: c.weights,
                        lambda c: c.intercept)
    ours = Ours(_StubEngine(ours_clf), LifecycleConfig(**kwargs), featurize=_identity,
                device="cpu")
    theirs = Theirs(_StubEngine(theirs_clf), jax_lifecycle.LifecycleConfig(**kwargs),
                    featurize=_identity)
    res = np.ones(3, np.float32)
    flips, diverged = 0, False
    weight_dev = 0.0
    for m in (ours, theirs):
        m.scored = []
        m.start()
    try:
        for b, (rows, labels) in enumerate(stream):
            for m in (ours, theirs):
                for i in range(len(rows)):
                    m.feedback(rows[i], res, float(labels[i]))
                assert m.flush(timeout_s=_WAIT)
            # the decisions each package's scoring made on this batch
            (f_o, lw_o, b_o, t_o, cw_o), (f_t, lw_t, b_t, t_t, cw_t) = (
                ours.scored[-1], theirs.scored[-1])
            assert f_o.tobytes() == f_t.tobytes()
            for w_o, w_t, bias, thr in ((lw_o, lw_t, b_o, t_o), (cw_o, cw_t, 0.0, t_o)):
                weight_dev = max(weight_dev, float(np.abs(w_o - w_t).max()))
                m_o, m_t = f_o @ w_o + bias, f_t @ w_t + bias
                differ = (m_o > thr) != (m_t > thr)
                assert np.all(np.abs(m_o[differ] - thr) <= 1e-4)
                assert np.all(np.abs(m_t[differ] - thr) <= 1e-4)
                flips += int(differ.sum())
            diverged = diverged or flips > 0
            cand_o, cand_t = ours.candidate, theirs.candidate
            assert (cand_o is None) == (cand_t is None) or diverged
            if cand_o is not None and cand_t is not None:
                np.testing.assert_allclose(cand_o.w, np.asarray(cand_t.w), rtol=0, atol=1e-5)
            np.testing.assert_allclose(ours.engine.classifier.model.weight.numpy(),
                                       np.asarray(theirs.engine.classifier.weights),
                                       rtol=0, atol=1e-5)
            if not diverged:
                bo, bt = ours.block(), theirs.block()
                for key in ("state", "generation", "feedback", "live_window", "baseline_cost",
                            "gate", "swaps", "swap_failures", "rollbacks", "rollback_armed",
                            "drift_events", "wedged", "config"):
                    assert bo[key] == bt[key], (b, key, bo[key], bt[key])
                assert (bo["candidate"] is None) == (bt["candidate"] is None)
                if bo["candidate"] is not None:
                    assert bo["candidate"] == bt["candidate"]
    finally:
        ours.close()
        theirs.close()
    block = theirs.block()
    print(f"\nmanager parity: {len(stream)} batches, max weight dev {weight_dev:.3e}, "
          f"near-threshold decision flips {flips}; swaps {block['swaps']}, rollbacks "
          f"{block['rollbacks']}, drift {block['drift_events']}")
    assert block["swaps"] >= 1 and block["rollbacks"] >= 1 and block["drift_events"] >= 1
    assert set(ours.block()) == set(block)
    assert flips == 0  # this seeded stream has no near-threshold row


def test_manager_refuses_what_it_cannot_train():
    class NotLinear:
        pass

    with pytest.raises(ValueError, match="no partial-fit surface"):
        LifecycleManager(_StubEngine(NotLinear(), "cpu"), featurize=_identity)
    with pytest.raises(ValueError, match="an engine or an explicit featurize"):
        LifecycleManager(None, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LifecycleManager(None, featurize=_identity)


def test_a_failed_chunk_retries_the_same_batch_then_drops_it():
    """serve.adapt fires inside the retry machinery: one firing costs one
    retry and the trajectory is the one a clean run takes; a batch that
    fails every attempt is dropped, counted."""
    _direction, stream = _stream(n_batches=3, flip_from=99)
    res = np.ones(3, np.float32)

    def run(spec):
        lc = LifecycleManager(None, LifecycleConfig(adapt_batch=8, adapt_iters=5, capacity=64,
                                                    gate_mode="off", gate_ratio=None),
                              featurize=_identity, device="cpu").start()
        try:
            with chaos.faults(spec) if spec else _nullcontext():
                for rows, labels in stream:
                    for i in range(len(rows)):
                        lc.feedback(rows[i], res, float(labels[i]))
                    assert lc.flush(timeout_s=_WAIT)
        finally:
            lc.close()
        return lc

    clean = run(None)
    before = _counter("chaos.fired.serve.adapt")
    once = run("serve.adapt:once@2")
    assert _counter("chaos.fired.serve.adapt") - before == 1
    assert once.block()["feedback"]["failures"] == 1
    assert once.candidate.w.tobytes() == clean.candidate.w.tobytes()
    always = run("serve.adapt:every@1")
    fb = always.block()["feedback"]
    assert fb["batches"] == 0 and fb["dropped_batches"] == 3 and fb["failures"] == 9
    assert always.candidate is None


def test_concurrent_feedback_loses_nothing():
    """16 feeding threads (more than the cores) against the adapter
    thread, with a shortened switch interval: every item is counted,
    queued, trained on and scored exactly once."""
    _direction, stream = _stream(n_batches=32, flip_from=99)
    items = [(rows[i], float(labels[i])) for rows, labels in stream for i in range(len(rows))]
    lc = LifecycleManager(None, LifecycleConfig(adapt_batch=8, adapt_iters=2, capacity=512,
                                                gate_mode="off", gate_ratio=None),
                          featurize=_identity, device="cpu").start()
    res = np.ones(3, np.float32)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda part=items[k::16]: [
            lc.feedback(row, res, label) for row, label in part]) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
        assert not any(t.is_alive() for t in threads)
        assert lc.flush(timeout_s=_WAIT)
    finally:
        sys.setswitchinterval(interval)
        lc.close()
    fb = lc.block()["feedback"]
    n = len(items)
    assert fb["received"] == n and fb["dropped"] == 0 and fb["failures"] == 0
    assert fb["batches"] == fb["chunks"] == n // 8
    assert lc.candidate.rows_seen == n and lc.candidate.window.seen == n
    assert lc.candidate.mask.sum() == n


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# -- end to end on the CPU ------------------------------------------------


def test_adapt_gate_off_statistics_byte_identical(session, tmp_path):
    """serve=true&adapt=true&swap_gate=off stages and shadow-scores a
    candidate on every batch of the session, yet its statistics are the
    plain serve run's byte for byte, and the JAX package's same query's;
    the lifecycle block's counts are the JAX package's."""
    base = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
            f"&load_clf=logreg&load_name={session['model']}")
    knobs = "&adapt=true&swap_gate=off&drift_window=16&adapt_batch=8"
    plain = PipelineBuilder(base, device="cpu").execute()
    builder = PipelineBuilder(base + knobs, device="cpu")
    adapted = builder.execute()
    report = str(tmp_path / "report")
    theirs = JaxBuilder(base + knobs + f"&report={report}").execute()
    assert str(adapted) == str(plain) == str(theirs)
    block = builder.serve_block["lifecycle"]
    assert block["enabled"] and block["swaps"] == 0
    assert block["feedback"]["received"] == len(session["windows"])
    assert block["feedback"]["batches"] >= 1 and block["feedback"]["failures"] == 0
    assert block["candidate"] is not None and block["config"]["swap_gate"] == "off"
    assert block["state"] == "closed"
    assert builder.timers["adapt"] > 0.0
    with open(os.path.join(report, "run_report.json")) as f:
        jax_block = json.load(f)["lifecycle"]
    for key in ("feedback", "candidate", "live_window", "baseline_cost", "gate", "swaps",
                "config", "state"):
        assert block[key] == jax_block[key], key


def test_adapt_chaos_statistics_byte_identical(session):
    """serve.adapt and serve.swap faults land in the adapter's retries:
    the served statistics do not move."""
    base = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true"
            f"&load_clf=logreg&load_name={session['model']}"
            "&adapt=true&swap_gate=off&adapt_batch=8")
    clean = PipelineBuilder(base, device="cpu").execute()
    before = (_counter("chaos.fired.serve.adapt"), _counter("serve.adapt_failures"))
    with chaos.faults("serve.adapt:once@1"):
        chaosed = PipelineBuilder(base, device="cpu").execute()
    assert str(chaosed) == str(clean)
    assert _counter("chaos.fired.serve.adapt") - before[0] == 1
    assert _counter("serve.adapt_failures") - before[1] == 1
    with chaos.faults("serve.swap:p=0.2;serve.adapt:p=0.2"):
        soaked = PipelineBuilder(base + "&swap_gate=cost:100", device="cpu").execute()
    assert str(soaked) == str(clean)


def test_promotion_parity_through_promoted_npz(session, tmp_path):
    """A permissive gate promotes; the service then serves what the batch
    run of ``promoted.npz`` predicts, loaded in the port or in the JAX
    package, and the promotion cleared the superseded checkpoints. The
    swap made no new mega program."""
    ckpt = str(tmp_path / "lc")
    svc = _service(session, adapt_batch=8, adapt_iters=10, drift_window=16, gate_mode="cost",
                   gate_ratio=100.0, checkpoint_dir=ckpt, rollback=False)
    program = svc.engine._mega_program
    before = _counter("serve.swaps")
    svc.start()
    try:
        _feed_session(svc, session, repeats=2)
        block = svc.lifecycle.block()
        assert block["swaps"] >= 1 and block["generation"] == block["swaps"]
        promoted_path = block["promoted_path"]
        assert promoted_path and os.path.exists(promoted_path)
        assert block["checkpoint"]["steps"] <= 2
        assert sorted(os.listdir(ckpt)) == ["candidate", "promoted.npz"]
        results = svc.predict_all(session["windows"], session["resolutions"])
    finally:
        svc.stop(drain=True)
    assert _counter("serve.swaps") > before
    assert svc.engine._mega_program is program
    assert svc.engine.classifier.model.weight.dtype == torch.float32
    served = np.array([r.prediction for r in results])
    ours = registry.create("logreg")
    ours.load(promoted_path)
    np.testing.assert_array_equal(served, ours.predict(session["batch_features"]).numpy())
    theirs = jax_registry.create("logreg")
    theirs.load(promoted_path)
    assert theirs.weights.tobytes() == ours.model.weight.numpy().tobytes()
    jax_preds = np.asarray(theirs.predict(session["jax_batch_features"]))
    np.testing.assert_array_equal(served, jax_preds)
    s_served = stats.ClassificationStatistics.from_arrays(served, session["targets"],
                                                          confusion_only=True)
    s_batch = jax_stats.ClassificationStatistics.from_arrays(jax_preds, session["targets"],
                                                             confusion_only=True)
    assert str(s_served) == str(s_batch)


def test_failed_swap_leaves_live_model_untouched(session):
    svc = _service(session, adapt_batch=8, adapt_iters=10, drift_window=16, gate_mode="cost",
                   gate_ratio=100.0)
    live = svc.engine.classifier
    before = (_counter("serve.swap_failures"), _counter("chaos.fired.serve.swap"))
    svc.start()
    try:
        with chaos.faults("serve.swap:every@1"):
            _feed_session(svc, session, repeats=2)
        block = svc.lifecycle.block()
        assert block["swaps"] == 0 and block["swap_failures"] >= 1
        assert block["candidate"] is not None  # kept, not burned
        assert svc.engine.classifier is live
        r = svc.predict_window(session["windows"][0], session["resolutions"])
        assert r.prediction == session["batch_predictions"][0]
    finally:
        svc.stop(drain=True)
    assert _counter("serve.swap_failures") > before[0]
    assert _counter("chaos.fired.serve.swap") > before[1]


def test_rollback_on_regression_restores_previous_model(session):
    svc = _service(session, adapt_batch=8, adapt_iters=5, drift_window=8, gate_mode="off",
                   gate_ratio=None)
    before = _counter("serve.rollbacks")
    svc.start()
    try:
        lc = svc.lifecycle
        original = svc.engine.classifier
        # a deliberately broken model with a perfect pre-swap record
        bad = lc._clone_with_weights(original, -original.model.weight.numpy(), 0.0)
        previous = svc.engine.swap_model(bad)
        lc._previous = (previous, 0.0)
        assert svc.engine.classifier is bad
        _feed_session(svc, session)
        assert svc.engine.classifier is previous
        block = lc.block()
        assert block["rollbacks"] == 1 and block["rollback_armed"] is False
        r = svc.predict_window(session["windows"][0], session["resolutions"])
        assert r.prediction == session["batch_predictions"][0]
    finally:
        svc.stop(drain=True)
    assert _counter("serve.rollbacks") > before


def test_drift_detection_fires_on_windowed_regression(session):
    svc = _service(session, adapt_batch=8, adapt_iters=5, drift_window=8, gate_mode="off",
                   gate_ratio=None, drift_factor=1.5)
    before = _counter("serve.drift")
    svc.start()
    try:
        _feed_session(svc, session)
        assert svc.lifecycle.baseline_cost is not None
        _feed_session(svc, session, flip=True)
        block = svc.lifecycle.block()
        assert block["drift_events"] >= 1
        assert block["live_window"]["expected_cost"] > block["baseline_cost"]
    finally:
        svc.stop(drain=True)
    assert _counter("serve.drift") > before


def test_feedback_after_close_raises(session):
    svc = _service(session, adapt_batch=8)
    svc.start()
    svc.feedback(session["windows"][0], session["resolutions"], float(session["targets"][0]))
    svc.stop(drain=True)
    with pytest.raises(ServiceClosedError, match="not accepting"):
        svc.feedback(session["windows"][0], session["resolutions"], 1.0)
    with pytest.raises(ServiceClosedError, match="lifecycle is closed"):
        svc.lifecycle.feedback(session["windows"][0], session["resolutions"], 1.0)
    assert svc.lifecycle.state == "closed"
    assert svc.lifecycle.block()["feedback"]["received"] == 1


def test_label_without_a_lifecycle_raises(session):
    with InferenceService.from_saved("logreg", session["model"], device="cpu") as svc:
        with pytest.raises(ValueError, match="adapt=true"):
            svc.submit(session["windows"][0], session["resolutions"], label=1.0)
        with pytest.raises(ValueError, match="adapt=true"):
            svc.feedback(session["windows"][0], session["resolutions"], 1.0)
        assert svc.stats_block()["lifecycle"] is None
    clf = registry.create("logreg")
    clf.load(session["model"])
    multi = MultiplexedService({"alice": clf}, device="cpu")
    with pytest.raises(ValueError, match="no lifecycle manager"):
        multi.submit(session["windows"][0], session["resolutions"], tenant="alice", label=1.0)
    with pytest.raises(ValueError, match="adapt=true"):
        multi.feedback(session["windows"][0], session["resolutions"], 1.0)


def test_submit_label_feeds_the_adapter(session):
    svc = _service(session, adapt_batch=4, gate_mode="off", gate_ratio=None)
    svc.start()
    try:
        futures = [
            svc.submit(session["windows"][i], session["resolutions"], block_s=5.0,
                       label=float(session["targets"][i]))
            for i in range(8)
        ]
        for f in futures:
            f.result(timeout=10.0)
        assert svc.lifecycle.flush(timeout_s=30.0)
        block = svc.stats_block()["lifecycle"]
        assert block["feedback"]["received"] == 8 and block["feedback"]["batches"] >= 2
    finally:
        svc.stop(drain=True)


def test_stop_during_adaptation_no_deadlock(session):
    svc = _service(session, config=ServeConfig(drain_timeout_s=30.0), adapt_batch=8,
                   adapt_iters=10, drift_window=16, gate_mode="cost", gate_ratio=100.0,
                   rollback=False)
    svc.start()
    _feed_session(svc, session, repeats=2, flush=False)
    t0 = time.monotonic()
    assert svc.stop(drain=True) is True
    assert time.monotonic() - t0 < _WAIT
    assert svc.lifecycle.state == "closed"
    clf = svc.engine.classifier
    assert clf.model.weight.dtype == torch.float32 and clf.model.weight.shape == (48,)


def test_wedged_adapter_discards_candidate_live_serving_continues(session):
    svc = _service(session, adapt_batch=4, watchdog_s=0.2, gate_mode="off", gate_ratio=None)
    release = threading.Event()

    def wedging_featurize(windows, _res):
        release.wait(30.0)
        return np.zeros((len(windows), 48), np.float32)

    before = _counter("serve.lifecycle_wedged")
    svc.start()
    try:
        for i in range(4):
            svc.feedback(session["windows"][i], session["resolutions"],
                         float(session["targets"][i]))
        assert svc.lifecycle.flush(timeout_s=30.0)
        assert svc.lifecycle.block()["candidate"] is not None
        svc.lifecycle._featurize = wedging_featurize
        for i in range(4):
            svc.feedback(session["windows"][i], session["resolutions"],
                         float(session["targets"][i]))
        assert svc.lifecycle.wedged.wait(10.0)
        block = svc.lifecycle.block()
        assert block["wedged"] and block["state"] == "wedged"
        assert block["candidate"] is None
        r = svc.predict_window(session["windows"][0], session["resolutions"])
        assert r.prediction == session["batch_predictions"][0]
        assert svc.feedback(session["windows"][0], session["resolutions"], 1.0) is False
        assert svc.lifecycle.block()["feedback"]["dropped"] >= 1
    finally:
        release.set()
        svc.stop(drain=True)
    assert _counter("serve.lifecycle_wedged") > before


@pytest.mark.parametrize("rung", ["mega", "fused"])
def test_swap_during_an_in_flight_batch_serves_it_wholly_by_one_model(session, rung):
    """A swap made while a batch is being featurized (a slow staging hook
    holds the batch until the swap is done) leaves that batch to the old
    model, weights, intercept and threshold alike; the next batch is the
    new model's, bit for bit."""
    clf = registry.create("logreg")
    clf.load(session["model"])
    new = registry.create("logreg")
    w = clf.model.weight.numpy()
    new.model = linear.LinearModel(torch.from_numpy(w * 0.5 + 0.01), 0.3)
    new.margin_threshold = 0.1
    windows, res = session["windows"][:16], session["resolutions"]

    def margins_of(model):
        eng = engine_mod.ServingEngine(model, capacity=64, device="cpu", engine_rung=rung)
        eng.warmup()
        return eng.execute(windows, res)

    want_old, want_new = margins_of(clf), margins_of(new)
    eng = engine_mod.ServingEngine(clf, capacity=64, device="cpu", engine_rung=rung)
    eng.warmup()
    assert eng.rung == rung
    entered, swapped = threading.Event(), threading.Event()
    hook = "_stage_mega" if rung == "mega" else "_fused_features"
    inner = getattr(eng, hook)

    def slow(*args):
        if not entered.is_set():
            entered.set()
            assert swapped.wait(10.0)
        return inner(*args)

    setattr(eng, hook, slow)
    out = {}
    worker = threading.Thread(target=lambda: out.update(r=eng.execute(windows, res)))
    worker.start()
    assert entered.wait(10.0)
    assert eng.swap_model(new) is clf
    swapped.set()
    worker.join(10.0)
    assert not worker.is_alive()
    for got, want in zip(out["r"], want_old):
        assert got.tobytes() == want.tobytes()
    for got, want in zip(eng.execute(windows, res), want_new):
        assert got.tobytes() == want.tobytes()


def test_engine_swap_refusals_carry_the_jax_messages(session):
    """A swap the kernels cannot take (another shape, another dtype, a
    classifier with no linear weights, a tenant key) raises the JAX
    package's message and leaves the served model as it was."""
    from eeg_dataanalysispackage_tpu.serve import engine as jax_engine

    clf = registry.create("logreg")
    clf.load(session["model"])
    eng = engine_mod.ServingEngine(clf, capacity=64, device="cpu")
    jclf = jax_registry.create("logreg")
    jclf.load(session["model"])
    jeng = jax_engine.ServingEngine(jclf, capacity=64)
    wrong_shape = registry.create("logreg")
    wrong_shape.model = linear.LinearModel(torch.zeros(47), 0.0)
    jwrong_shape = jax_registry.create("logreg")
    jwrong_shape.weights = np.zeros(47, np.float32)
    wrong_dtype = registry.create("logreg")
    wrong_dtype.model = linear.LinearModel(torch.zeros(48, dtype=torch.float64), 0.0)
    jwrong_dtype = jax_registry.create("logreg")
    jwrong_dtype.weights = np.zeros(48, np.float64)
    for ours_new, theirs_new in ((wrong_shape, jwrong_shape), (wrong_dtype, jwrong_dtype),
                                 (registry.create("logreg"), jax_registry.create("logreg"))):
        with pytest.raises(ValueError) as theirs:
            jeng.swap_model(theirs_new)
        with pytest.raises(ValueError) as ours:
            eng.swap_model(ours_new)
        assert str(ours.value) == str(theirs.value)
        assert eng.classifier is clf
    with pytest.raises(ValueError, match="MultiplexedEngine"):
        eng.swap_model(clf, tenant="a")


def test_featurize_matches_the_fused_rows_and_the_jax_engine(session):
    """The engine's featurize gives the fused rung's rows of the windows
    (capacity slices, padded rows dropped), within 2e-6 of the JAX
    engine's featurize."""
    from eeg_dataanalysispackage_tpu.serve import engine as jax_engine

    clf = registry.create("logreg")
    clf.load(session["model"])
    eng = engine_mod.ServingEngine(clf, capacity=16, device="cpu")
    eng.warmup()
    jclf = jax_registry.create("logreg")
    jclf.load(session["model"])
    jeng = jax_engine.ServingEngine(jclf, capacity=64)
    windows = session["windows"][:40]  # three capacity slices
    got = eng.featurize(windows, session["resolutions"])
    want = jeng.featurize(windows, session["resolutions"])
    assert got.shape == (40, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert eng.featurize([], session["resolutions"]).shape == (0, 48)
    solo = eng.featurize(windows[:5], session["resolutions"])
    assert solo.tobytes() == got[:5].tobytes()


# -- resume ---------------------------------------------------------------


def _run_worker(ckpt_dir, n_batches, kill_after=None):
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_torch_lifecycle_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, worker, ckpt_dir, str(n_batches)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)),
    )
    if kill_after is None:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-2000:]
        return out
    seen = 0
    try:
        for line in proc.stdout:
            if line.startswith("CKPT"):
                seen += 1
                if seen >= kill_after:
                    break
    finally:
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=60)
        proc.stdout.close()
        proc.stderr.close()
    assert seen == kill_after
    return None


def test_sigkill_mid_partial_fit_resumes_byte_identical(tmp_path):
    """An adapter SIGKILLed after its 3rd checkpoint restores its carry
    and ring and replays the rest of the feedback to candidate weights
    byte-equal to an uninterrupted twin's."""
    n_batches = 6
    twin = [ln for ln in _run_worker(str(tmp_path / "twin"), n_batches).splitlines()
            if ln.startswith("W ")][-1]
    killed = str(tmp_path / "killed")
    _run_worker(killed, n_batches, kill_after=3)
    assert any(s.startswith("step_") for s in os.listdir(os.path.join(killed, "candidate")))
    resumed_out = _run_worker(killed, n_batches)
    assert "CKPT 4" in resumed_out.splitlines()[0]  # resumed after batch 3
    resumed = [ln for ln in resumed_out.splitlines() if ln.startswith("W ")][-1]
    assert resumed == twin and twin != "W none"


def _feed_batches(lc, stream, start, stop):
    res = np.ones(3, np.float32)
    for b in range(start, stop):
        rows, labels = stream[b]
        for i in range(len(rows)):
            lc.feedback(rows[i], res, float(labels[i]))
        assert lc.flush(timeout_s=_WAIT)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_either_package_resumes_the_others_candidate(tmp_path, writer):
    """Three batches trained and checkpointed by one package; the other
    resumes the directory (the same weights, byte for byte, and the same
    position) and trains on to within 1e-5 of its own uninterrupted
    twin."""
    stream = _torch_lifecycle_worker.feedback_stream(6)
    makers = {"jax": _lifecycle_worker.make_lifecycle,
              "port": _torch_lifecycle_worker.make_lifecycle}
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path / "shared")
    first = makers[writer](d).start()
    _feed_batches(first, stream, 0, 3)
    first.close()
    second = makers[reader](d)
    assert second.batches_trained == 3 and second.candidate.t == first.candidate.t == 15
    assert np.asarray(second.candidate.w).tobytes() == np.asarray(first.candidate.w).tobytes()
    assert second.candidate.features.tobytes() == np.asarray(first.candidate.features).tobytes()
    second.start()
    _feed_batches(second, stream, 3, 6)
    second.close()
    twin = makers[reader](str(tmp_path / "twin")).start()
    _feed_batches(twin, stream, 0, 6)
    twin.close()
    np.testing.assert_allclose(np.asarray(second.candidate.w), np.asarray(twin.candidate.w),
                               rtol=0, atol=1e-5)
