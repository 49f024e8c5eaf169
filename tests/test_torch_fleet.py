"""The port's replica fleet (``gateway/fleet.py``: ``FleetReplica`` and
``PodAssist``) on the CPU: the twins of the replica and pod-assist part of
the JAX package's ``tests/test_fleet.py`` (its lease part is
``tests/test_torch_lease.py``).

- **takeover**: a dead replica's write-ahead record is claimed by a peer's
  scan loop and completes under its original id with the direct run's
  statistics, the takeover in its journal meta; a keyed re-submit then
  replays it; a live peer's plan is never taken, and a keyed re-submit of
  it names the owner;
- **two replicas over one journal** mint distinct ids and register one plan
  for one new idempotency key;
- **drain**: new submissions 503, queued plans handed back (record
  ``submitted``, lease gone), the plan in flight finished, a peer completes
  the released plan;
- **readiness**: ``/healthz`` is liveness, ``/readyz`` turns 503 when the
  journal directory goes away and when the device pool is exhausted while
  plans wait; ``/stats`` and ``/plans`` carry the fleet attribution;
- **real processes**: two ``python -m
  eeg_dataanalysispackage_tpu_torch.gateway --fleet --device=cpu`` replicas;
  the one running a plan is SIGKILLed, the survivor completes it under its
  id with its twin's statistics, exactly once, its ``/metrics`` counts the
  takeover, and a SIGTERM drain exits 0 with its queued plan handed back;
- **the pod assist**: a ``processes=2`` plan completes through the
  coordinator's rank-0 member and a peer's rank-1 worker with the solo
  run's statistics; a killed coordinator member ends the plan ``failed``
  (the port's inline pod cannot assemble and raises; the JAX package
  degrades to one host and completes), never wedged, with no assist record
  left; a dead coordinator's record is cleared by a peer;
- **the port's own**: the device pool ``EEG_TPU_DEVICE_POOL`` asks for
  attaches and grants, a fleet plan's crash report names the held leases
  (``lease.set_active``), the scan jitter equals the JAX package's, and a
  replica built with ``device=None`` raises without a card.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from eeg_dataanalysispackage_tpu.gateway import fleet as jax_fleet
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.gateway import FleetReplica as _FleetReplica
from eeg_dataanalysispackage_tpu_torch.gateway import fleet as fleet_mod
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain as run_domain, metrics_export
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.scheduler import lease as lease_mod
from eeg_dataanalysispackage_tpu_torch.scheduler import placement
from eeg_dataanalysispackage_tpu_torch.scheduler.journal import PlanJournal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402
from test_torch_nn import CONFIG_A  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def FleetReplica(**kwargs):
    return _FleetReplica(device="cpu", **kwargs)


@pytest.fixture(autouse=True)
def _clean_ambient(monkeypatch):
    """A 1 s break threshold, so staleness is testable."""
    assert chaos.active_plan() is None
    assert run_domain.current() is None
    monkeypatch.setenv(lease_mod.ENV_LEASE_TIMEOUT, "1")
    yield
    chaos.uninstall()
    assert run_domain.current() is None


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("fleet")), n_markers=60)


def _q(info, extra="", clf="logreg"):
    return (f"info_file={info}&fe=dwt-8&train_clf={clf}&config_step_size=1.0"
            "&config_num_iterations=20&config_mini_batch_fraction=1.0" + extra)


def _slow(info, iterations=4000):
    """An nn plan that trains for seconds on the CPU."""
    return (f"info_file={info}&fe=dwt-8-fused&train_clf=nn"
            + CONFIG_A.replace("config_num_iterations=50",
                               f"config_num_iterations={iterations}"))


def _request(url, body=None, method="GET", headers=None, timeout=60):
    req = urllib.request.Request(url, data=body.encode() if body is not None else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stale_lease(journal_dir, plan_id, holder="gw-dead", pid=999999, age_s=100.0):
    os.makedirs(journal_dir, exist_ok=True)
    path = os.path.join(journal_dir, f"plan-{plan_id}.lease")
    with open(path, "w") as f:
        f.write(f"{holder}\n{pid}\n\n")
    old = time.time() - age_s
    os.utime(path, (old, old))
    return path


def _wait_terminal(journal, plan_id, deadline_s=300):
    deadline = time.monotonic() + deadline_s
    entry = None
    while time.monotonic() < deadline:
        entry = journal.entry(plan_id)
        if entry and entry["state"] != "submitted":
            return entry
        time.sleep(0.05)
    return entry


@pytest.fixture(scope="module")
def twin(session):
    return str(PipelineBuilder(_q(session), device="cpu").execute())


def test_takeover_executes_orphan_byte_identical(session, tmp_path, twin):
    journal_dir = str(tmp_path / "journal")
    journal = PlanJournal(journal_dir)
    journal.record_submitted("p0001", _q(session), meta={"idempotency_key": "k1"})
    _stale_lease(journal_dir, "p0001")
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-b", scan_interval_s=0.05)
    replica.start()
    try:
        entry = _wait_terminal(journal, "p0001")
        assert entry["state"] == "completed" and entry["statistics"] == twin
        assert entry["meta"]["fleet"] == {"replica": "gw-b", "takeover": True}
        code, payload = replica.server.submit_query(_q(session), idempotency_key="k1")
        assert (code, payload["plan_id"], payload["idempotent_replay"]) == (200, "p0001", True)
        assert replica.fleet_view()["claimed"] == ["p0001"]
    finally:
        replica.close()
    assert not os.path.exists(os.path.join(journal_dir, "plan-p0001.lease"))


def test_two_replicas_mint_distinct_ids_and_one_plan_a_key(session, tmp_path):
    journal_dir = str(tmp_path / "journal")
    a = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=5.0)
    b = FleetReplica(journal_dir=journal_dir, replica_id="gw-b", scan_interval_s=5.0)
    a.start()
    b.start()
    journal = PlanJournal(journal_dir)
    try:
        _, pa = a.server.submit_query(_q(session, "&dedup=false"))
        _, pb = b.server.submit_query(_q(session, "&dedup=false"))
        assert pa["plan_id"] != pb["plan_id"]
        for plan_id, rid in ((pa["plan_id"], "gw-a"), (pb["plan_id"], "gw-b")):
            entry = _wait_terminal(journal, plan_id)
            assert entry["state"] == "completed"
            assert entry["meta"]["fleet"] == {"replica": rid, "takeover": False}
        results, barrier = {}, threading.Barrier(2)

        def go(name, replica):
            barrier.wait()
            results[name] = replica.server.submit_query(_q(session), idempotency_key="race")

        threads = [threading.Thread(target=go, args=(n, r)) for n, r in (("a", a), ("b", b))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ids = {payload["plan_id"] for _, payload in results.values()}
        assert len(ids) == 1
        (plan_id,) = ids
        assert _wait_terminal(journal, plan_id)["state"] == "completed"
        assert len(journal.entries()) == 3
        assert not [n for n in os.listdir(journal_dir) if n.startswith("key-")]
    finally:
        a.close()
        b.close()


def test_keyed_resubmit_of_peer_held_plan_names_owner(session, tmp_path):
    journal_dir = str(tmp_path / "journal")
    journal = PlanJournal(journal_dir)
    journal.record_submitted("p0001", _q(session), meta={"idempotency_key": "k1"})
    _stale_lease(journal_dir, "p0001", holder="gw-a", pid=os.getpid(), age_s=0.0)
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-b", scan_interval_s=0.05)
    replica.start()
    try:
        code, payload = replica.server.submit_query(_q(session), idempotency_key="k1")
        assert (code, payload["plan_id"], payload["owner"]) == (200, "p0001", "gw-a")
        assert payload["idempotent_replay"] is True
        time.sleep(0.2)  # a few scan passes: the live holder's plan stays its own
        assert journal.entry("p0001")["state"] == "submitted"
    finally:
        replica.close()
    with open(os.path.join(journal_dir, "plan-p0001.lease")) as f:
        assert f.readline().strip() == "gw-a"


def test_drain_releases_queued_finishes_inflight(session, tmp_path):
    journal_dir = str(tmp_path / "journal")
    a = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=5.0,
                     max_concurrent=1)
    a.start()
    _, inflight = a.server.submit_query(_slow(session, 1500))
    _, queued = a.server.submit_query(_q(session))
    outcome = {}
    t = threading.Thread(target=lambda: outcome.update(a.drain(timeout_s=300.0)))
    t.start()
    try:
        while not a.server.draining:
            time.sleep(0.01)
        code, payload = a.server.submit_query(_q(session))
        assert code == 503 and payload["draining"] is True
    finally:
        t.join(timeout=300)
    assert outcome == {"released": [queued["plan_id"]], "finished": [inflight["plan_id"]],
                       "abandoned": []}
    journal = PlanJournal(journal_dir)
    assert journal.entry(inflight["plan_id"])["state"] == "completed"
    assert journal.entry(queued["plan_id"])["state"] == "submitted"
    assert not os.path.exists(os.path.join(journal_dir, f"plan-{queued['plan_id']}.lease"))
    b = FleetReplica(journal_dir=journal_dir, replica_id="gw-b", scan_interval_s=0.05)
    b.start()
    try:
        entry = _wait_terminal(journal, queued["plan_id"])
        assert entry["state"] == "completed" and entry["meta"]["fleet"]["replica"] == "gw-b"
    finally:
        b.close()


def test_healthz_readyz_stats_and_list(session, tmp_path):
    """/readyz turns 503 when the journal directory goes away (still alive
    on /healthz); /stats carries the fleet block and /plans and status name
    a live peer's plans' owner."""
    journal_dir = str(tmp_path / "journal")
    PlanJournal(journal_dir).record_submitted("p0777", _q(session), meta={})
    _stale_lease(journal_dir, "p0777", holder="gw-peer", pid=os.getpid(), age_s=0.0)
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=5.0)
    host, port = replica.start()
    base = f"http://{host}:{port}"
    try:
        assert _request(f"{base}/healthz") == (200, {"ok": True, "replica": "gw-a",
                                                    "queued": 0, "journal": True})
        code, payload = _request(f"{base}/readyz")
        assert code == 200 and payload["ready"] is True and payload["replica"] == "gw-a"
        _, stats = _request(f"{base}/stats")
        fleet = stats["fleet"]
        assert fleet["replica"] == "gw-a" and fleet["draining"] is False
        assert set(fleet) >= {"claims", "takeovers", "breaks", "heartbeats",
                              "heartbeat_failures", "claim_failures", "held_leases",
                              "devices_held"}
        row = next(p for p in _request(f"{base}/plans")[1]["plans"] if p["plan_id"] == "p0777")
        assert row["owner"] == "gw-peer"
        assert _request(f"{base}/plans/p0777")[1]["owner"] == "gw-peer"
        os.rename(journal_dir, journal_dir + ".gone")
        with open(journal_dir, "w") as f:
            f.write("not a directory")
        try:
            code, payload = _request(f"{base}/readyz")
            assert code == 503 and payload["ready"] is False
            assert any("journal" in r for r in payload["reasons"])
            assert _request(f"{base}/healthz")[0] == 200
        finally:
            os.unlink(journal_dir)
            os.rename(journal_dir + ".gone", journal_dir)
        assert _request(f"{base}/readyz")[0] == 200
    finally:
        replica.close()


def test_readyz_flags_exhausted_device_pool(tmp_path, monkeypatch):
    monkeypatch.setenv(placement.ENV_DEVICE_POOL, "1")
    journal_dir = str(tmp_path / "journal")
    os.makedirs(journal_dir)
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=5.0)
    host, port = replica.start()
    base = f"http://{host}:{port}"
    peer_pool = placement.DevicePool(lease_mod.LeaseDir(journal_dir, holder="gw-peer"), size=1)
    try:
        assert replica.executor.placement is replica.pool and replica.pool.size == 1
        assert _request(f"{base}/readyz")[0] == 200
        one = {"devices": 1, "hosts": 1, "memory_class": "light"}
        blocker = peer_pool.admit("blocker", one)
        assert isinstance(blocker, placement.DeviceGrant)
        assert peer_pool.admit("waiter", one) is None
        code, payload = _request(f"{base}/readyz")
        assert code == 503 and payload["ready"] is False
        reason = " ".join(payload["reasons"])
        assert "device pool exhausted" in reason and "waiter" in reason
        assert _request(f"{base}/healthz")[0] == 200
        code, text = replica.server.metrics_payload()
        series = metrics_export.parse(text)
        assert series["eeg_tpu_fleet_devices_free"] == [({}, 0.0)]
        assert series["eeg_tpu_fleet_plans_waiting_placement"] == [({}, 1.0)]
        assert "eeg_tpu_fleet_devices_held" in series
        pool_block = _request(f"{base}/stats")[1]["fleet"]["device_pool"]
        assert (pool_block["size"], pool_block["free"], pool_block["oldest_waiting"]) \
            == (1, 0, "waiter")
        blocker.release()
        peer_pool.clear_waiting("waiter")
        assert _request(f"{base}/readyz")[0] == 200
    finally:
        replica.close()


def test_a_fleet_plan_runs_on_a_granted_ordinal(session, tmp_path, monkeypatch, twin):
    monkeypatch.setenv(placement.ENV_DEVICE_POOL, "2")
    journal_dir = str(tmp_path / "journal")
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=5.0)
    replica.start()
    try:
        _, payload = replica.server.submit_query(_q(session))
        entry = _wait_terminal(PlanJournal(journal_dir), payload["plan_id"])
        assert entry["state"] == "completed" and entry["statistics"] == twin
        assert entry["meta"]["fleet"] == {"replica": "gw-a", "takeover": False, "devices": [0]}
    finally:
        replica.close()
    assert placement.device_table(journal_dir) == []
    assert placement.pool_size_marker(journal_dir) == 2


def test_a_fleet_plans_crash_report_names_the_held_leases(session, tmp_path):
    journal_dir, reports = str(tmp_path / "journal"), str(tmp_path / "reports")
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=5.0,
                           max_attempts=1, report_root=reports)
    replica.start()
    try:
        _, payload = replica.server.submit_query(_q(session, "&faults=scheduler.plan:every@1"))
        assert _wait_terminal(PlanJournal(journal_dir), payload["plan_id"])["state"] == "failed"
    finally:
        replica.close()
    with open(os.path.join(reports, payload["plan_id"], "crash_report.json")) as f:
        context = json.load(f)["fleet_context"]
    assert context["replica"] == "gw-a" and context["takeover"] is False
    assert payload["plan_id"] in context["held_leases"]
    assert lease_mod.active_held() == []  # the replica released them on close


@pytest.mark.parametrize("replica_id", ["gw-a", "gw-b", "replica-17"])
def test_scan_jitter_equals_the_jax_package(replica_id, monkeypatch):
    assert (fleet_mod.jittered_scan_interval(replica_id, base=0.25)
            == jax_fleet.jittered_scan_interval(replica_id, base=0.25))
    monkeypatch.setenv(fleet_mod.ENV_SCAN_JITTER, "0")
    assert fleet_mod.jittered_scan_interval(replica_id, base=0.25) == 0.25


def test_a_replica_needs_a_journal_and_a_card(tmp_path):
    with pytest.raises(ValueError, match="journal_dir"):
        FleetReplica(journal_dir=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _FleetReplica(journal_dir=str(tmp_path / "journal"))


# -- the real processes


def _spawn_replica(replica_id, journal_dir, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", "eeg_dataanalysispackage_tpu_torch.gateway", "--port", "0",
         "--journal-dir", journal_dir, "--max-concurrent", "1", "--drain-timeout-s", "300",
         "--fleet", "--replica-id", replica_id, "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()
    assert "listening on " in line, line
    return proc, line.split("listening on ", 1)[1].split()[0]


def _await_state(url, plan_id, states, deadline_s=300):
    deadline = time.monotonic() + deadline_s
    while True:
        _, status = _request(f"{url}/plans/{plan_id}")
        if status.get("state") in states:
            return status["state"]
        assert time.monotonic() < deadline, status
        time.sleep(0.02)


def test_sigkilled_replica_peer_completes_then_sigterm_drains(session, tmp_path):
    """Two replica processes over one journal: the one running a plan is
    SIGKILLed, the survivor breaks its lease and completes the plan under
    its id with its twin's statistics, exactly once, and counts it in
    /metrics; a keyed re-submit replays it; a SIGTERM then drains the
    survivor: the plan in flight finishes, the queued one is handed back,
    exit 0."""
    journal_dir = str(tmp_path / "journal")
    heavy = _slow(session)
    twin = str(PipelineBuilder(heavy, device="cpu").execute())
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               EEG_TPU_LEASE_TIMEOUT_S="1", EEG_TPU_FLEET_SCAN_INTERVAL_S="0.1")
    for var in ("EEG_TPU_FAULTS", "EEG_TPU_RUN_REPORT_DIR", "EEG_TPU_DEVICE_POOL"):
        env.pop(var, None)
    procs = []
    try:
        for rid in ("gw-a", "gw-b"):
            procs.append(_spawn_replica(rid, journal_dir, env))
        (proc_a, url_a), (proc_b, url_b) = procs
        for url in (url_a, url_b):
            assert _request(f"{url}/readyz")[0] == 200
        code, payload = _request(f"{url_a}/plans", body=heavy, method="POST",
                                 headers={"X-Idempotency-Key": "fleet-pin",
                                          "X-Trace-Id": "fleet-pin-trace"})
        assert code == 201 and payload["trace_id"] == "fleet-pin-trace"
        plan_id = payload["plan_id"]
        assert _await_state(url_a, plan_id, ("running", "completed", "failed")) == "running"
        proc_a.kill()
        assert proc_a.wait(timeout=60) == -signal.SIGKILL
        assert _await_state(url_b, plan_id, ("completed", "failed")) == "completed"
        entries = PlanJournal(journal_dir).entries()
        assert [e["plan_id"] for e in entries] == [plan_id]
        assert entries[0]["statistics"] == twin
        assert entries[0]["meta"]["fleet"] == {"replica": "gw-b", "takeover": True}
        assert entries[0]["meta"]["trace_id"] == "fleet-pin-trace"
        with urllib.request.urlopen(f"{url_b}/metrics", timeout=30) as r:
            series = metrics_export.parse(r.read().decode())
        assert series["eeg_tpu_build_info"] == [({"replica": "gw-b"}, 1.0)]
        assert series["eeg_tpu_scheduler_completed_total"] == [({}, 1.0)]
        assert series["eeg_tpu_lease_takeovers_total"] == [({}, 1.0)]
        code, replay = _request(f"{url_b}/plans", body=heavy, method="POST",
                                headers={"X-Idempotency-Key": "fleet-pin"})
        assert (code, replay["plan_id"], replay["idempotent_replay"]) == (200, plan_id, True)
        # the drain: one plan in flight, one queued behind it
        _, inflight = _request(f"{url_b}/plans", body=_slow(session), method="POST")
        _, queued = _request(f"{url_b}/plans", body=_q(session), method="POST")
        assert _await_state(url_b, inflight["plan_id"], ("running",)) == "running"
        proc_b.send_signal(signal.SIGTERM)
        assert proc_b.wait(timeout=300) == 0
    finally:
        for proc, _url in procs:
            if proc.poll() is None:
                proc.kill()
    journal = PlanJournal(journal_dir)
    assert journal.entry(inflight["plan_id"])["state"] == "completed"
    assert journal.entry(queued["plan_id"])["state"] == "submitted"
    assert not [n for n in os.listdir(journal_dir) if n.endswith(".lease")]


# -- the pod assist


def test_pod_assist_enlists_peer_byte_identical(session, tmp_path):
    journal_dir = str(tmp_path / "journal")
    extra = "&cv=2&sweep=lr:1.0,0.5&cache=false"
    twin = str(PipelineBuilder(_q(session, extra), device="cpu").execute())
    before = obs.metrics.snapshot()["counters"]
    a = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=0.05)
    b = FleetReplica(journal_dir=journal_dir, replica_id="gw-b", scan_interval_s=0.05)
    a.start()
    b.start()
    journal = PlanJournal(journal_dir)
    try:
        code, payload = a.server.submit_query(_q(session, extra + "&processes=2"))
        assert code == 201, payload
        entry = _wait_terminal(journal, payload["plan_id"], deadline_s=600)
        assert entry["state"] == "completed", entry
        assert entry["statistics"] == twin
        after = obs.metrics.snapshot()["counters"]

        def delta(k):
            return after.get(k, 0) - before.get(k, 0)

        assert delta("fleet.pod_assist_requests") >= 1
        assert delta("fleet.pod_assist_completed") >= 1
        assert delta("fleet.pod_assist_workers") >= 1
        assert delta("fleet.pod_assist_degraded") == 0
        assert journal.assist_entries() == []
    finally:
        a.close()
        b.close()
    assert not [n for n in os.listdir(journal_dir)
                if n.startswith("assist-") and n.endswith(".lease")]


def test_sigkilled_pod_coordinator_fails_the_plan_not_wedges(session, tmp_path, monkeypatch):
    """The coordinator's rank-0 member dies at once: the assist returns
    None and the plan runs inline, where a pod with no peers cannot
    assemble and raises (the JAX package degrades to one host and
    completes). The plan ends failed within its attempts, the degraded
    assist counted, no assist record left."""
    from eeg_dataanalysispackage_tpu_torch.parallel import pod as pod_mod

    monkeypatch.setenv("EEG_TPU_POD_TIMEOUT_S", "5")
    real_spawn, killed = pod_mod.spawn_pod_member, []

    def spawn_then_sigkill(*args, **kwargs):
        child = real_spawn(*args, **kwargs)
        child.kill()
        killed.append(child)
        return child

    monkeypatch.setattr(pod_mod, "spawn_pod_member", spawn_then_sigkill)
    before = obs.metrics.snapshot()["counters"]
    journal_dir = str(tmp_path / "journal")
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-a", scan_interval_s=0.05,
                           max_attempts=1)
    replica.start()
    journal = PlanJournal(journal_dir)
    try:
        code, payload = replica.server.submit_query(_q(session, "&processes=2"))
        assert code == 201, payload
        entry = _wait_terminal(journal, payload["plan_id"], deadline_s=120)
        assert killed, "the coordinator member was never spawned"
        assert entry["state"] == "failed", entry
        assert "Pod" in entry["error"] or "pod" in entry["error"]
        after = obs.metrics.snapshot()["counters"]
        assert after.get("fleet.pod_assist_degraded", 0) \
            > before.get("fleet.pod_assist_degraded", 0)
        assert journal.assist_entries() == []
    finally:
        replica.close()


def test_dead_coordinators_assist_record_cleared_by_peer(tmp_path):
    journal_dir = str(tmp_path / "journal")
    replica = FleetReplica(journal_dir=journal_dir, replica_id="gw-b", scan_interval_s=5.0)
    journal = PlanJournal(journal_dir)
    try:
        journal.record_assist("p0001", "127.0.0.1:45555", 2, holder="gw-dead", pid=999999,
                              start_token="", query="info_file=/x")
        assert len(journal.assist_entries()) == 1
        assert replica.pod_assist.scan_assists() == []
        assert journal.assist_entries() == []
    finally:
        replica.close()
