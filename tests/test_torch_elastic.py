"""The port's elastic training (``elastic=true``) and failure handling
against the JAX package's.

Twins of ``tests/test_failure.py`` (the sentinel, ``run_resumable``,
``elastic_train`` over the checkpoint store and over an in-memory
manager, the probe's fail-fast and healthy-restart branches) in torch,
and of the elastic cases of ``tests/test_chaos.py`` through
``obs.chaos.faults`` (the port's ``faults=`` is not ported): a mid-train
``device.step`` fault recovers by one restart with the statistics of the
uninterrupted run, elastic equals monolithic training for logreg, svm,
nn (with lbfgs too) and the monolithic trees, on the fused and host
paths, and a finished run clears its checkpoints. A linear checkpoint
the JAX package wrote resumes in the port, and the reverse.
"""

import os
import sys

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.checkpoint.manager import CheckpointManager as JaxManager
from eeg_dataanalysispackage_tpu.models import sgd as jax_sgd
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.checkpoint.manager import (
    CheckpointManager,
    run_resumable,
)
from eeg_dataanalysispackage_tpu_torch.models import sgd
from eeg_dataanalysispackage_tpu_torch.obs import chaos, failure
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

NN_CONFIG = (
    "&config_seed=5&config_num_iterations=30&config_learning_rate=0.05"
    "&config_momentum=0.9&config_weight_init=xavier&config_updater=nesterovs"
    "&config_optimization_algo=stochastic_gradient_descent&config_pretrain=false"
    "&config_backprop=true&config_layer1_layer_type=dense&config_layer1_n_out=8"
    "&config_layer1_drop_out=0.2&config_layer1_activation_function=relu"
    "&config_layer2_layer_type=output&config_layer2_n_out=2&config_layer2_drop_out=0"
    "&config_layer2_activation_function=softmax"
    "&config_loss_function=negativeloglikelihood"
)


def test_probe_devices_all_healthy():
    probe = failure.probe_devices()
    assert probe.all_healthy and probe.healthy
    assert all(t >= 0 for t in probe.latencies_s)
    assert failure.probe_devices(["cpu"]).healthy == [torch.device("cpu")]


def test_sentinel_nonfinite_raises_at_step():
    s = failure.DivergenceSentinel()
    s.check(1, 0.5)
    with pytest.raises(failure.TrainingDiverged, match="step 2"):
        s.check(2, float("nan"))


def test_sentinel_explosion_needs_patience():
    s = failure.DivergenceSentinel(window=5, explode_factor=10.0, patience=2)
    for i in range(5):
        s.check(i, 1.0)
    s.check(5, 100.0)
    with pytest.raises(failure.TrainingDiverged, match="exploded"):
        s.check(6, 100.0)


def test_sentinel_single_spike_tolerated_and_reset():
    s = failure.DivergenceSentinel(window=5, explode_factor=10.0, patience=2)
    for i in range(5):
        s.check(i, 1.0)
    s.check(5, 100.0)
    s.check(6, 1.0)
    s.check(7, 100.0)
    s.reset()
    assert len(s._history) == 0 and s._strikes == 0
    s.check(10, 500.0)


def _sgd_step(state, x, y):
    w = torch.as_tensor(state["w"])
    grad = 2 * (w @ x - y) * x
    return {"w": w - 0.01 * grad}, torch.abs(w @ x - y)


def _batches():
    rng = np.random.RandomState(0)
    xs = rng.randn(30, 4).astype(np.float32)
    ys = (xs @ np.array([1.0, -2.0, 0.5, 0.0])).astype(np.float32)
    return [(torch.from_numpy(x), torch.tensor(y)) for x, y in zip(xs, ys)]


def test_elastic_train_survives_transient_crashes(tmp_path):
    batches = _batches()
    init = lambda: {"w": torch.zeros(4)}  # noqa: E731
    ref_state, ref_last = run_resumable(CheckpointManager(str(tmp_path / "ref")), init,
                                        _sgd_step, list(batches), save_every=1)
    calls, crashed = {"n": 0}, set()

    def flaky_step(state, x, y):
        calls["n"] += 1
        if calls["n"] in (7, 19) and calls["n"] not in crashed:
            crashed.add(calls["n"])
            raise RuntimeError(f"injected fault at call {calls['n']}")
        return _sgd_step(state, x, y)

    state, last, restarts = failure.elastic_train(
        CheckpointManager(str(tmp_path / "flaky")), init, flaky_step, lambda: list(batches),
        max_restarts=5, save_every=1, probe_on_failure=False)
    assert restarts == 2 and last == ref_last == 30
    np.testing.assert_array_equal(np.asarray(state["w"]), np.asarray(ref_state["w"]))


def test_elastic_train_deterministic_fault_surfaces_without_replay(tmp_path):
    calls = {"n": 0}

    def always_nan(state, x, y):
        calls["n"] += 1
        return state, torch.tensor(float("nan"))

    with pytest.raises(failure.TrainingDiverged):
        failure.elastic_train(
            CheckpointManager(str(tmp_path / "nan")), lambda: {"w": torch.zeros(2)},
            always_nan, lambda: [(torch.ones(2), torch.tensor(0.0))] * 3, max_restarts=2,
            save_every=1, sentinel=failure.DivergenceSentinel(), probe_on_failure=False)
    assert calls["n"] == 1


def test_elastic_train_restarts_skip_checkpointed_steps(tmp_path):
    executed, armed = [], {"on": True}

    def step(state, x, y):
        executed.append(float(x.sum()))
        if len(executed) == 6 and armed["on"]:
            armed["on"] = False
            raise RuntimeError("injected")
        return _sgd_step(state, x, y)

    batches = [(torch.full((2,), float(i)), torch.tensor(float(i))) for i in range(8)]
    _, last, restarts = failure.elastic_train(
        CheckpointManager(str(tmp_path / "skip")), lambda: {"w": torch.zeros(2)}, step,
        lambda: list(batches), max_restarts=2, save_every=2, probe_on_failure=False)
    assert restarts == 1 and last == 8 and len(executed) == 10


class _FakeManager:
    def __init__(self):
        self.saved, self.save_calls = {}, []

    def latest_step(self):
        return max(self.saved) if self.saved else None

    def save(self, step, state, extra=None):
        self.saved[step] = {k: torch.as_tensor(v).clone() for k, v in state.items()}
        self.save_calls.append(step)

    def restore(self, template, step=None):
        step = step if step is not None else self.latest_step()
        return self.saved[step], {"step": step, "extra": {}}


def test_elastic_train_restart_accounting_fake_manager():
    calls = {"n": 0}

    def scripted_step(state, x):
        calls["n"] += 1
        if calls["n"] in (3, 5):
            raise RuntimeError(f"scripted fault (call {calls['n']})")
        return {"w": state["w"] + x}, torch.tensor(1.0)

    mgr = _FakeManager()
    state, last, restarts = failure.elastic_train(
        mgr, lambda: {"w": torch.zeros(())}, scripted_step,
        lambda: [(torch.tensor(float(i)),) for i in range(1, 6)], max_restarts=3,
        save_every=1, probe_on_failure=False)
    assert (restarts, last, float(state["w"]), calls["n"]) == (2, 5, 15.0, 7)
    assert mgr.save_calls == [1, 2, 3, 4, 5]


def test_elastic_train_exhausted_restarts_reraises():
    mgr = _FakeManager()
    before = obs.metrics.snapshot()["counters"].get("elastic.exhausted", 0.0)

    def always_fail(state, x):
        raise RuntimeError("permanent fault")

    with pytest.raises(RuntimeError, match="permanent fault"):
        failure.elastic_train(mgr, lambda: {"w": torch.zeros(())}, always_fail,
                              lambda: [(torch.tensor(1.0),)], max_restarts=2, save_every=1,
                              probe_on_failure=False)
    assert mgr.save_calls == []
    assert obs.metrics.snapshot()["counters"]["elastic.exhausted"] - before == 1


def test_elastic_train_probe_on_failure_fails_fast(monkeypatch):
    calls = {"n": 0}

    def crash(state, x):
        calls["n"] += 1
        raise RuntimeError("device went away")

    monkeypatch.setattr(failure, "probe_devices", lambda *a, **k: failure.DeviceProbeResult(
        healthy=[], failed=[("fake-dev", "no response")], latencies_s=[]))
    with pytest.raises(RuntimeError, match="unhealthy after training") as ei:
        failure.elastic_train(_FakeManager(), lambda: {"w": torch.zeros(())}, crash,
                              lambda: [(torch.tensor(1.0),)] * 4, max_restarts=5,
                              save_every=1, probe_on_failure=True)
    assert "device went away" in str(ei.value.__cause__) and calls["n"] == 1


def test_elastic_train_healthy_probe_allows_restart(monkeypatch):
    probes, armed = {"n": 0}, {"fail": True}

    def healthy(*a, **k):
        probes["n"] += 1
        return failure.DeviceProbeResult(healthy=["fake-dev"], failed=[], latencies_s=[0.01])

    def step(state, x):
        if armed["fail"]:
            armed["fail"] = False
            raise RuntimeError("transient")
        return {"w": state["w"] + x}, torch.tensor(0.5)

    monkeypatch.setattr(failure, "probe_devices", healthy)
    _, last, restarts = failure.elastic_train(
        _FakeManager(), lambda: {"w": torch.zeros(())}, step,
        lambda: [(torch.tensor(1.0),)] * 3, max_restarts=2, save_every=1,
        probe_on_failure=True)
    assert (restarts, last, probes["n"]) == (1, 3, 1)


# -- elastic pipeline training -----------------------------------------------


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("elastic")), n_markers=90)


def _query(info, extra="", clf="logreg"):
    return (f"info_file={info}&train_clf={clf}&config_step_size=1.0"
            "&config_num_iterations=40&config_mini_batch_fraction=1.0" + extra)


def _counter(name):
    return obs.metrics.snapshot()["counters"].get(name, 0.0)


def test_elastic_requires_checkpoint_path(session):
    with pytest.raises(ValueError, match="checkpoint_path"):
        PipelineBuilder(_query(session, "&fe=dwt-8&elastic=true"), device="cpu").execute()


@pytest.mark.parametrize("fe,clf,extra", [
    ("dwt-8-fused", "logreg", ""),
    ("dwt-8", "logreg", ""),
    ("dwt-8-fused", "svm", "&config_reg_param=0.01&config_mini_batch_fraction=0.5"),
    ("dwt-8-fused", "nn", NN_CONFIG),
    ("dwt-8", "nn", NN_CONFIG.replace("stochastic_gradient_descent", "lbfgs")),
])
def test_midtrain_fault_recovers_via_elastic_restart(session, tmp_path, fe, clf, extra):
    """A device.step fault on the 2nd chunk: one restart from the latest
    checkpoint, statistics equal to the uninterrupted monolithic run."""
    q = _query(session, f"&fe={fe}{extra}", clf=clf)
    mono = str(PipelineBuilder(q, device="cpu").execute())
    fired, restarts = _counter("chaos.fired.device.step"), _counter("elastic.restarts")
    with chaos.faults("device.step:err@2"):
        stats = PipelineBuilder(q + f"&elastic=true&save_every=1&checkpoint_path={tmp_path}/ck",
                                device="cpu").execute()
    assert str(stats) == mono
    assert _counter("chaos.fired.device.step") - fired == 1
    assert _counter("elastic.restarts") - restarts == 1
    assert not os.listdir(tmp_path / "ck")  # cleared once training finished


@pytest.mark.parametrize("clf", ["rf", "dt-tpu"])
def test_trees_train_monolithically_under_elastic(session, tmp_path, clf):
    q = _query(session, "&fe=dwt-8-fused", clf=clf)
    with chaos.faults("device.step:err@1"):  # no chunk: the point never fires
        got = PipelineBuilder(q + f"&elastic=true&checkpoint_path={tmp_path}/ck",
                              device="cpu").execute()
    assert str(got) == str(PipelineBuilder(q, device="cpu").execute())


def test_elastic_completed_run_clears_checkpoints(session, tmp_path):
    ck = tmp_path / "ck"
    q = _query(session, f"&fe=dwt-8-fused&elastic=true&checkpoint_path={ck}")
    first = PipelineBuilder(q, device="cpu").execute()
    assert not [p for p in os.listdir(ck) if p.startswith("step_")]
    assert str(PipelineBuilder(q, device="cpu").execute()) == str(first)


@pytest.mark.parametrize("fe", ["dwt-8-fused", "dwt-8"])
def test_elastic_statistics_equal_the_jax_package(session, tmp_path, fe):
    q = _query(session, f"&fe={fe}&elastic=true&save_every=2")
    ours = PipelineBuilder(q + f"&checkpoint_path={tmp_path}/port", device="cpu").execute()
    theirs = JaxBuilder(q + f"&checkpoint_path={tmp_path}/jax").execute()
    assert str(ours) == str(theirs)


# -- checkpoints across packages -------------------------------------------------


def _data():
    rng = np.random.RandomState(5)
    x = rng.randn(120, 48).astype(np.float32)
    y = (x[:, 0] + 0.3 * rng.randn(120) > 0).astype(np.float64)
    return x, y


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_linear_checkpoints_resume_across_packages(tmp_path, writer):
    """A run of one package stopped after 3 chunks leaves its checkpoints;
    the other package's elastic run over the directory resumes from them
    and ends within float32 roundoff of an uninterrupted run."""
    x, y = _data()
    ck = str(tmp_path / "ck")
    config = dict(num_iterations=60, step_size=1.0, reg_param=0.01, loss="hinge")
    stop = "device.step:once@4"
    if writer == "jax":
        from eeg_dataanalysispackage_tpu.obs import chaos as jax_chaos

        with jax_chaos.faults(stop), pytest.raises(jax_chaos.ChaosInjectedError):
            jax_sgd.train_linear_elastic(x, y, jax_sgd.SGDConfig(**config), JaxManager(ck),
                                         max_restarts=0, probe_on_failure=False)
        resumed = sgd.train_linear_elastic(torch.from_numpy(x), torch.from_numpy(y),
                                           sgd.SGDConfig(**config), CheckpointManager(ck))
        got = resumed.numpy()
    else:
        with chaos.faults(stop), pytest.raises(chaos.ChaosInjectedError):
            sgd.train_linear_elastic(torch.from_numpy(x), torch.from_numpy(y),
                                     sgd.SGDConfig(**config), CheckpointManager(ck),
                                     max_restarts=0, probe_on_failure=False)
        meta = JaxManager(ck).read_metadata()
        assert meta["step"] == 3 and "loss" in meta["extra"]
        got = jax_sgd.train_linear_elastic(x, y, jax_sgd.SGDConfig(**config),
                                           JaxManager(ck))
    # the stored carry: the JAX package's keys and dtypes
    state = CheckpointManager(ck).restore({"w": 0, "converged": 0, "n_updates": 0})[0]
    assert (state["w"].dtype, state["converged"].dtype, state["n_updates"].dtype) == (
        np.float32, np.bool_, np.int32)
    want = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y),
                            sgd.SGDConfig(**config)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_elastic_weights_equal_the_monolithic_weights():
    x, y = _data()
    config = sgd.SGDConfig(num_iterations=45, mini_batch_fraction=0.5, seed=3)
    want = sgd.train_linear(torch.from_numpy(x), torch.from_numpy(y), config)
    import tempfile

    with tempfile.TemporaryDirectory() as d, chaos.faults("device.step:once@2"):
        got = sgd.train_linear_elastic(torch.from_numpy(x), torch.from_numpy(y), config,
                                       CheckpointManager(d), chunk_iters=7,
                                       probe_on_failure=False)
    assert torch.equal(got, want)
