"""The port's plan executor (``scheduler/executor.py``, ``journal.py``,
``runtime.py``) against the JAX package's: the twins of the JAX package's
``tests/test_scheduler.py``, on the CPU.

- **parity**: a plan run through ``PlanExecutor`` gives the statistics of
  the direct ``PipelineBuilder`` run and of the JAX package's executor on
  the same session (the host ``fe=dwt-8`` path byte-identical, the fused
  path too, as ``tests/test_torch_pipeline.py`` holds them);
- **admission**: a bounded queue that sheds with evidence and journals the
  shed, a queued deadline that fails fast, ``run()`` backpressure, close;
- **retries and chaos**: ``scheduler.plan`` absorbed by a retry (two
  attempts, as the JAX executor counts them), an exhausted budget with its
  history, ``scheduler.journal`` degrading to unjournaled (counted), a
  p=0.2 soak over 8 concurrent plans;
- **fault isolation**: a failing ``ingest.fused`` plan and a meshed plan
  run beside a clean plan whose statistics, per-plan counters and run
  report equal its solo run's (the port has no degradation ladder: the
  faulted plan fails, with its crash report);
- **crash-only**: a child process (``tests/_torch_scheduler_worker.py``)
  is SIGKILLed mid-plan; a fresh executor's ``recover()`` re-runs each
  unfinished plan exactly once to the uninterrupted statistics, and the
  completed plan's record stays byte-untouched;
- the feature cache's single flight across plans, the circuit breaker's
  evidence naming the opening plan, per-plan report directories, the
  metrics routed domain-first, and the refusals: no card, placement, the
  pod assist.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.scheduler import PlanExecutor as JaxExecutor
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import circuit, deadline as deadline_mod
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain as run_domain
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.scheduler import (
    PlanExecutor as _PlanExecutor,
    PlanFailedError,
    PlanJournal,
    PlanShedError,
)
from eeg_dataanalysispackage_tpu_torch.scheduler import executor as executor_mod
from eeg_dataanalysispackage_tpu_torch.scheduler import runtime as runtime_mod
from eeg_dataanalysispackage_tpu_torch.serve.batcher import ServiceClosedError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def PlanExecutor(**kwargs):
    return _PlanExecutor(device="cpu", **kwargs)


@pytest.fixture(autouse=True)
def _clean_ambient():
    assert chaos.active_plan() is None
    assert run_domain.current() is None
    yield
    chaos.uninstall()
    assert run_domain.current() is None


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("sched")), n_markers=60)


def _q(info, extra="", clf="logreg", fe="dwt-8"):
    return (f"info_file={info}&fe={fe}&train_clf={clf}&config_step_size=1.0"
            "&config_num_iterations=20&config_mini_batch_fraction=1.0" + extra)


def _fused(info, extra=""):
    return _q(info, extra, fe="dwt-8-fused")


@pytest.fixture(scope="module")
def jax_results(session):
    """The JAX executor's results on the session, shared by the tests."""
    with JaxExecutor(max_concurrent=2) as ex:
        handles = {
            "host": ex.submit(_q(session)),
            "fused": ex.submit(_fused(session)),
            "retry": ex.submit(_q(session, "&faults=scheduler.plan:once@1")),
        }
        return {k: h.result(timeout=300) for k, h in handles.items()}


@pytest.fixture(scope="module")
def solo(session):
    """The port's direct runs, by query."""
    cache = {}

    def run(q):
        if q not in cache:
            cache[q] = str(PipelineBuilder(q, device="cpu").execute())
        return cache[q]

    return run


def _counters(result):
    return result.builder.run_metrics.snapshot()["counters"]


def _delta(before, name):
    return obs.metrics.snapshot()["counters"].get(name, 0) - before.get(name, 0)


# -- parity


@pytest.mark.parametrize("kind", ["host", "fused"])
def test_executor_matches_direct_builder_and_jax_executor(session, solo, jax_results, kind):
    q = _q(session) if kind == "host" else _fused(session)
    with PlanExecutor(max_concurrent=2) as ex:
        result = ex.submit(q).result(timeout=300)
    assert str(result.statistics) == solo(q) == str(jax_results[kind].statistics)
    assert (result.plan_id, result.attempts, result.recovered) == ("p0001", 1, False)
    assert (jax_results[kind].attempts, jax_results[kind].recovered) == (1, False)


def test_invalid_query_rejected_before_journal(session, tmp_path):
    with PlanExecutor(journal_dir=str(tmp_path / "j")) as ex:
        with pytest.raises(ValueError, match="Missing classifier"):
            ex.submit(f"info_file={session}&fe=dwt-8")
        with pytest.raises(ValueError, match="remote locations"):
            ex.submit(_q(session, "&result_path=http://127.0.0.1:1/r.txt"))
        assert ex.journal.entries() == []


# -- admission control


def _blocked(release):
    def blocked_execute(plan, builder_, plan_id=None, fault_plan=None,
                        default_report_dir=None, gateway=None, **kw):
        assert release.wait(30), "the test never released the worker"
        return f"done-{plan_id}"
    return blocked_execute


def test_shed_with_evidence(monkeypatch, session, tmp_path):
    release = threading.Event()
    monkeypatch.setattr(runtime_mod, "execute_plan", _blocked(release))
    ex = PlanExecutor(max_concurrent=1, queue_depth=1, journal_dir=str(tmp_path / "j"))
    try:
        h1 = ex.submit(_q(session))
        deadline = time.monotonic() + 5.0
        while len(ex.queue) != 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        h2 = ex.submit(_q(session))
        with pytest.raises(PlanShedError, match="shed at admission.*depth 1") as shed:
            ex.submit(_q(session))
        assert shed.value.plan_id == "p0003"
        entry = ex.journal.entry("p0003")
        assert entry["state"] == "failed" and "shed at admission" in entry["error"]
        release.set()
        assert h1.result(timeout=30).statistics == "done-p0001"
        assert h2.result(timeout=30).statistics == "done-p0002"
    finally:
        release.set()
        ex.close()


def test_queued_deadline_fails_fast(monkeypatch, session):
    release = threading.Event()
    monkeypatch.setattr(runtime_mod, "execute_plan", _blocked(release))
    ex = PlanExecutor(max_concurrent=1, queue_depth=4)
    try:
        ex.submit(_q(session))
        h2 = ex.submit(_q(session), deadline_s=0.05)
        time.sleep(0.2)
        release.set()
        with pytest.raises(deadline_mod.DeadlineExceededError, match="never executed"):
            h2.result(timeout=30)
    finally:
        release.set()
        ex.close()


def test_close_fails_abandoned_queued_handles(monkeypatch, session):
    release = threading.Event()
    monkeypatch.setattr(runtime_mod, "execute_plan", _blocked(release))
    ex = PlanExecutor(max_concurrent=1, queue_depth=4)
    h1 = ex.submit(_q(session))
    h2 = ex.submit(_q(session))
    ex._stop.set()
    release.set()
    ex.close()
    assert h1.result(timeout=30).statistics == "done-p0001"
    with pytest.raises(ServiceClosedError, match="abandoned"):
        h2.result(timeout=30)


def test_cancel_if_queued_and_status(monkeypatch, session, tmp_path):
    release = threading.Event()
    monkeypatch.setattr(runtime_mod, "execute_plan", _blocked(release))
    ex = PlanExecutor(max_concurrent=1, queue_depth=4, journal_dir=str(tmp_path / "j"))
    try:
        h1 = ex.submit(_q(session))
        h2 = ex.submit(_q(session), idempotency_key="k2")
        deadline = time.monotonic() + 5.0
        while h1.state != "running" and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not ex.cancel(h1.plan_id)  # running: not torn down
        assert ex.cancel(h2.plan_id)
        with pytest.raises(executor_mod.PlanCancelledError):
            h2.result(timeout=5)
        assert ex.status(h2.plan_id)["state"] == "cancelled"
        # the cancel released the key: a re-submit runs fresh
        h3 = ex.submit(_q(session), idempotency_key="k2")
        assert h3.plan_id == "p0003" and not h3.replayed
        release.set()
        assert h3.result(timeout=30).statistics == "done-p0003"
        assert ex.status("p0003")["state"] == "completed"
        assert ex.status("p9999") is None
    finally:
        release.set()
        ex.close()


def test_idempotent_resubmit_replays_and_refuses_another_body(session, solo, tmp_path):
    jdir = str(tmp_path / "j")
    with PlanExecutor(journal_dir=jdir) as ex:
        first = ex.submit(_q(session), idempotency_key="k1").result(timeout=300)
    with PlanExecutor(journal_dir=jdir) as ex:
        again = ex.submit(_q(session), idempotency_key="k1")
        assert again.replayed and again.plan_id == first.plan_id
        replay = again.result(timeout=5)
        assert replay.replayed and replay.builder is None
        assert replay.statistics == solo(_q(session))
        with pytest.raises(executor_mod.IdempotencyConflictError, match="different query"):
            ex.submit(_fused(session), idempotency_key="k1")
        assert [e["plan_id"] for e in ex.journal.entries()] == ["p0001"]


# -- retries and the chaos points


def test_scheduler_plan_chaos_absorbed_by_retry(session, solo, jax_results):
    before = obs.metrics.snapshot()["counters"]
    with PlanExecutor(max_attempts=3) as ex:
        result = ex.submit(_q(session, "&faults=scheduler.plan:once@1")).result(timeout=300)
    assert str(result.statistics) == solo(_q(session)) == str(jax_results["retry"].statistics)
    assert result.attempts == jax_results["retry"].attempts == 2
    assert _delta(before, "chaos.fired.scheduler.plan") == 1
    assert _delta(before, "scheduler.retries") == 1


def test_retry_budget_exhaustion_fails_with_history(session, tmp_path):
    with PlanExecutor(max_attempts=2, journal_dir=str(tmp_path / "j")) as ex:
        h = ex.submit(_q(session, "&faults=scheduler.plan:every@1"))
        with pytest.raises(PlanFailedError, match="attempt 2"):
            h.result(timeout=300)
        entry = ex.journal.entry(h.plan_id)
    assert entry["state"] == "failed" and entry["attempts"] == 2
    assert "retry budget" in entry["error"]


def test_journal_chaos_degrades_to_unjournaled(session, solo, tmp_path):
    before = obs.metrics.snapshot()["counters"]
    with PlanExecutor(journal_dir=str(tmp_path / "j")) as ex:
        result = ex.submit(_q(session, "&faults=scheduler.journal:every@1")).result(timeout=300)
        assert ex.journal.entries() == []
    assert str(result.statistics) == solo(_q(session))
    assert _delta(before, "scheduler.journal_write_failed") >= 2
    assert _delta(before, "chaos.fired.scheduler.journal") >= 4  # each write tried twice


def test_chaos_soak_eight_concurrent_plans(session, solo):
    with PlanExecutor(max_concurrent=4, max_attempts=6) as ex:
        handles = [ex.submit(_q(session, "&faults=scheduler.plan:p=0.2;scheduler.journal:p=0.2"
                                         f"&faults_seed={i}")) for i in range(8)]
        results = [h.result(timeout=600) for h in handles]
    assert [str(r.statistics) for r in results] == [solo(_q(session))] * 8
    assert any(r.attempts > 1 for r in results)


# -- fault isolation


def _report(root, plan_id, name="run_report.json"):
    with open(os.path.join(root, plan_id, name)) as f:
        return json.load(f)


def test_concurrent_fault_domains_are_isolated(session, solo, tmp_path):
    """A failing ingest.fused plan and a meshed plan run beside a clean
    plan: the clean plan's statistics, per-plan counters and run report
    equal its solo run's."""
    clean_q = _fused(session)
    faulted_q = clean_q + "&faults=ingest.fused:once@1"
    mesh_q = _fused(session, "&devices=2")
    with PlanExecutor(max_concurrent=3, report_root=str(tmp_path / "solo")) as ex:
        alone = ex.submit(clean_q).result(timeout=300)
    with PlanExecutor(max_concurrent=3, max_attempts=1,
                      report_root=str(tmp_path / "multi")) as ex:
        h_clean, h_fault, h_mesh = (ex.submit(q) for q in (clean_q, faulted_q, mesh_q))
        clean = h_clean.result(timeout=300)
        meshed = h_mesh.result(timeout=300)
        with pytest.raises(PlanFailedError, match="ingest.fused"):
            h_fault.result(timeout=300)
    assert str(clean.statistics) == str(alone.statistics) == solo(clean_q)
    assert str(meshed.statistics) == solo(clean_q)
    assert _counters(clean) == _counters(alone)
    assert not any(k.startswith("chaos.fired") for k in _counters(clean))
    assert clean.builder.mesh_resolved is None
    assert meshed.builder.mesh_resolved["rung"] == "mesh"
    assert clean.builder.run_metrics is not meshed.builder.run_metrics
    ours, theirs = _report(tmp_path / "multi", clean.plan_id), _report(tmp_path / "solo",
                                                                        alone.plan_id)
    for key in ("statistics_sha256", "metrics", "chaos", "mesh", "backend", "degradation"):
        assert ours[key] == theirs[key], key
    assert ours["chaos"] is None and ours["plan_id"] == clean.plan_id
    crash = _report(tmp_path / "multi", h_fault.plan_id, "crash_report.json")
    assert crash["chaos"]["rules"]["ingest.fused"]["fired"] == 1
    assert crash["metrics"]["counters"]["chaos.fired.ingest.fused"] == 1
    assert crash["plan_id"] == h_fault.plan_id


def test_metrics_route_domain_first():
    child = obs.Metrics()
    with obs.metrics.scope() as everything:
        with run_domain.activate(run_domain.RunDomain(plan_id="pA", metrics=child)):
            obs.metrics.count("x", 2)
            obs.metrics.gauge("g", 3)
            child.count("own")  # a child never routes again
        obs.metrics.count("x")  # outside any domain: as before
    assert child.snapshot() == {"counters": {"x": 2.0, "own": 1.0}, "gauges": {"g": 3}}
    assert everything.snapshot()["counters"] == {"x": 3.0}


# -- crash-only recovery (SIGKILL)


def test_sigkill_recovery_resumes_unfinished_exactly_once(session, solo, tmp_path):
    jdir = str(tmp_path / "journal")
    qa, qb, qc = (_fused(session, f"&config_step_size={s}") for s in ("1.0", "0.5", "0.25"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tests", "_torch_scheduler_worker.py"),
         "--device=cpu", jdir, qa, qb, qc],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    child = json.loads(proc.stdout.strip().splitlines()[-1])
    assert child["a_statistics"] == solo(qa)
    ex = PlanExecutor(max_concurrent=2, journal_dir=jdir)
    assert {e["plan_id"]: e["state"] for e in ex.journal.entries()} == {
        "p0001": "completed", "p0002": "submitted", "p0003": "submitted"}
    completed_before = open(os.path.join(jdir, "plan-p0001.json")).read()
    runs = []
    real = runtime_mod.execute_plan

    def counted(plan, builder, **kw):
        runs.append(plan.query)
        return real(plan, builder, **kw)

    runtime_mod.execute_plan = counted
    try:
        recovery = ex.recover()
        assert [e["plan_id"] for e in recovery["completed"]] == ["p0001"]
        assert recovery["failed"] == []
        resumed = {h.query: h.result(timeout=300) for h in recovery["resumed"]}
    finally:
        runtime_mod.execute_plan = real
        ex.close()
    assert sorted(runs) == sorted([qb, qc])  # each unfinished plan once, A never
    for q, result in resumed.items():
        assert str(result.statistics) == solo(q) and result.recovered
    assert open(os.path.join(jdir, "plan-p0001.json")).read() == completed_before
    assert recovery["completed"][0]["statistics"] == solo(qa)
    assert PlanJournal(jdir).unfinished() == []


def test_recovery_never_sheds(session, solo, tmp_path):
    jdir = str(tmp_path / "j")
    journal = PlanJournal(jdir)
    queries = {f"p{i:04d}": _q(session, f"&config_step_size={1.0 / i}") for i in range(1, 5)}
    for pid, q in queries.items():
        journal.record_submitted(pid, q)
    ex = PlanExecutor(max_concurrent=1, queue_depth=1, journal_dir=jdir)
    try:
        recovery = ex.recover()
        assert len(recovery["resumed"]) == 4
        results = {h.plan_id: h.result(timeout=300) for h in recovery["resumed"]}
    finally:
        ex.close()
    for pid, r in results.items():
        assert str(r.statistics) == solo(queries[pid])
    assert ex.journal.unfinished() == []


def test_new_executor_ids_never_clobber_a_journal(session, tmp_path):
    jdir = str(tmp_path / "j")
    with PlanExecutor(journal_dir=jdir) as ex1:
        r1 = ex1.submit(_q(session)).result(timeout=300)
    before = open(os.path.join(jdir, f"plan-{r1.plan_id}.json")).read()
    with PlanExecutor(journal_dir=jdir) as ex2:
        r2 = ex2.submit(_q(session)).result(timeout=300)
    assert r2.plan_id != r1.plan_id
    assert open(os.path.join(jdir, f"plan-{r1.plan_id}.json")).read() == before


def test_closed_executor_refuses_and_strands_no_record(session, tmp_path):
    ex = PlanExecutor(max_concurrent=1, journal_dir=str(tmp_path / "j"))
    ex.start()
    ex.close()
    with pytest.raises(ServiceClosedError, match="closed"):
        ex.submit(_q(session))
    assert ex.journal.entries() == []


def test_journal_entries_numeric_order_past_9999(tmp_path):
    journal = PlanJournal(str(tmp_path / "j"))
    for pid in ("p10000", "p0002", "p9999", "p0010"):
        journal.record_submitted(pid, f"query-{pid}")
    assert [e["plan_id"] for e in journal.entries()] == ["p0002", "p0010", "p9999", "p10000"]


def test_run_backpressures_past_queue_depth(session, solo):
    ex = PlanExecutor(max_concurrent=1, queue_depth=1)
    queries = [_q(session, f"&config_step_size={1.0 / i}") for i in range(1, 6)]
    try:
        results = ex.run(queries, timeout_s=300)
    finally:
        ex.close()
    assert [str(r.statistics) for r in results] == [solo(q) for q in queries]


# -- shared caches and evidence across plans


def test_concurrent_plans_single_flight_feature_cache(session, tmp_path, monkeypatch):
    monkeypatch.delenv("EEG_TPU_NO_FEATURE_CACHE", raising=False)
    monkeypatch.setenv("EEG_TPU_FEATURE_CACHE_DIR", str(tmp_path / "fc"))
    q = _fused(session)
    before = obs.metrics.snapshot()["counters"]
    with PlanExecutor(max_concurrent=2) as ex:
        h1, h2 = ex.submit(q), ex.submit(q)
        r1, r2 = h1.result(timeout=300), h2.result(timeout=300)
    assert str(r1.statistics) == str(r2.statistics)
    assert _delta(before, "feature_cache.store") == 1
    assert _delta(before, "feature_cache.hit") >= 1


def test_circuit_evidence_names_the_opening_plan(tmp_path, monkeypatch):
    monkeypatch.setenv("EEG_TPU_CIRCUIT_THRESHOLD", "1")
    monkeypatch.setenv("EEG_TPU_CIRCUIT_COOLDOWN", "600")
    circuit.reset()
    import socket

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    q = f"info_file=http://127.0.0.1:{port}/info.txt&fe=dwt-8&train_clf=logreg"
    try:
        with PlanExecutor(max_concurrent=1, max_attempts=1,
                          report_root=str(tmp_path / "reports")) as ex:
            ha = ex.submit(q)
            with pytest.raises(PlanFailedError):
                ha.result(timeout=120)
            hb = ex.submit(q)
            with pytest.raises(PlanFailedError) as excinfo:
                hb.result(timeout=120)
        assert "circuit open" in str(excinfo.value)
        assert "[plan p0001]" in str(excinfo.value)
        entry = next(iter(circuit.snapshot().values()))
        assert entry["state"] == "open" and entry["contributing_plans"] == ["p0001"]
        for plan_id in ("p0001", "p0002"):
            crash = _report(tmp_path / "reports", plan_id, "crash_report.json")
            assert next(iter(crash["circuit"].values()))["contributing_plans"] == ["p0001"]
    finally:
        circuit.reset()


def test_env_report_dir_is_per_plan_under_executor(session, tmp_path, monkeypatch):
    from eeg_dataanalysispackage_tpu_torch.obs import report as obs_report

    env_dir = tmp_path / "reports"
    monkeypatch.setenv(obs_report.ENV_REPORT_DIR, str(env_dir))
    ex = PlanExecutor(max_concurrent=2)
    try:
        handles = [ex.submit(_q(session)) for _ in range(2)]
        for h in handles:
            h.result(timeout=300)
    finally:
        ex.close()
    for h in handles:
        assert (env_dir / h.plan_id / "run_report.json").exists()
    assert not (env_dir / "run_report.json").exists()
    PipelineBuilder(_q(session), device="cpu").execute()
    assert (env_dir / "run_report.json").exists()


def test_report_echoes_the_submission_attribution(session, tmp_path):
    with PlanExecutor(report_root=str(tmp_path / "r")) as ex:
        h = ex.submit(_q(session), gateway={"via": "http", "client": "c"},
                      fleet={"replica": "gw-a", "takeover": False}, trace_id="t-1")
        h.result(timeout=300)
    report = _report(tmp_path / "r", h.plan_id)
    assert report["plan_id"] == h.plan_id
    assert report["gateway"] == {"via": "http", "client": "c"}
    assert report["fleet"] == {"replica": "gw-a", "takeover": False}
    assert report["trace"] == {"trace_id": "t-1", "segment": None}


# -- no fallback


def test_no_card_no_placement_no_pod_assist(session, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _PlanExecutor()
    monkeypatch.setenv("EEG_TPU_DEVICE_POOL", "4")
    with pytest.raises(ValueError, match="A9.4"):
        PlanExecutor()
    monkeypatch.delenv("EEG_TPU_DEVICE_POOL")
    ex = PlanExecutor()
    with pytest.raises(ValueError, match="A9.4"):
        ex.placement = object()
    with pytest.raises(ValueError, match="A9.5"):
        ex.pod_assist = object()
    ex.placement = ex.pod_assist = None
    from eeg_dataanalysispackage_tpu_torch.pipeline.plan import ExecutionPlan

    with pytest.raises(ValueError, match="A9.4"):
        runtime_mod.execute_plan(ExecutionPlan.parse(_q(session)),
                                 PipelineBuilder(_q(session), device="cpu"), placement=(0,))


def test_jax_session_runs_match_for_reference(session, jax_results):
    """The shared JAX results are the JAX package's direct runs too."""
    assert str(jax_results["host"].statistics) == str(JaxBuilder(_q(session)).execute())
