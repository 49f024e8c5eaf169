"""The port's plan leases and journal hardening (``scheduler/lease.py``,
``scheduler/journal.py``) against the JAX package's: the twins of the JAX
package's ``tests/test_fleet.py`` lease and journal tests that need no
gateway, on the CPU.

- **lease races**: of many threads over two or four holders exactly one
  claims; a stale lease is broken only past the timeout and with a
  provably dead holder (a recycled pid is caught by its start token), once,
  whatever the number of racing breakers; a holder unlinks only its own
  lease; ``fleet.lease`` and ``fleet.heartbeat`` faults are counted, never
  fatal;
- **journal hardening**: a corrupt record is quarantined and counted, a
  refused directory fsync is counted;
- **executors over one journal**: an orphaned record (stale lease, dead
  holder) is taken over by ``claim_and_run`` and run exactly once under its
  own id to the uninterrupted statistics, equal to the JAX executor's
  takeover of the same record; fresh ids never collide; a new idempotency
  key registers one plan; a keyed re-submit of a plan a live peer holds
  names the owner;
- **one format**: each package reads the other's journal records and lease
  files with the same fields, and a port holder and a JAX holder racing
  one plan grant one claim.
"""

import os
import threading
import time

import pytest

from eeg_dataanalysispackage_tpu.scheduler import lease as jax_lease
from eeg_dataanalysispackage_tpu.scheduler.executor import PlanExecutor as JaxExecutor
from eeg_dataanalysispackage_tpu.scheduler.journal import PlanJournal as JaxJournal
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain as run_domain
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.scheduler import lease as lease_mod
from eeg_dataanalysispackage_tpu_torch.scheduler import executor as executor_mod
from eeg_dataanalysispackage_tpu_torch.scheduler.journal import PlanJournal

import _synthetic


def PlanExecutor(**kwargs):
    return executor_mod.PlanExecutor(device="cpu", **kwargs)


@pytest.fixture(autouse=True)
def _clean_ambient(monkeypatch):
    """No leaked chaos plan or domain; a 1 s break threshold."""
    monkeypatch.setenv(lease_mod.ENV_LEASE_TIMEOUT, "1")
    assert chaos.active_plan() is None
    assert run_domain.current() is None
    yield
    chaos.uninstall()
    assert run_domain.current() is None


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("lease")), n_markers=60)


def _q(info, extra=""):
    return (f"info_file={info}&fe=dwt-8&train_clf=logreg&config_step_size=1.0"
            "&config_num_iterations=20&config_mini_batch_fraction=1.0" + extra)


def _stale_lease(journal_dir, plan_id, holder="gw-dead", pid=999999, age_s=100.0, token=""):
    """A dead holder's lease: an unknown pid, a heartbeat long past the
    threshold (``token`` empty: liveness by pid alone)."""
    os.makedirs(journal_dir, exist_ok=True)
    path = os.path.join(journal_dir, f"plan-{plan_id}.lease")
    with open(path, "w") as f:
        f.write(f"{holder}\n{pid}\n{token}\n")
    old = time.time() - age_s
    os.utime(path, (old, old))
    return path


def _await_terminal(journal, plan_id, deadline_s=300):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        entry = journal.entry(plan_id)
        if entry and entry["state"] != "submitted":
            return entry
        time.sleep(0.02)
    raise AssertionError(f"{plan_id} never reached a terminal record")


# -- lease races


def _race(dirs, per_dir, plan_id, takeover=False):
    outcomes, lock = [], threading.Lock()
    barrier = threading.Barrier(len(dirs) * per_dir)

    def race(directory):
        barrier.wait()
        out = directory.try_claim(plan_id, takeover=takeover)
        with lock:
            outcomes.append(out)

    threads = [threading.Thread(target=race, args=(d,)) for d in dirs for _ in range(per_dir)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outcomes


def test_two_replicas_race_exactly_one_claims(tmp_path):
    dirs = [lease_mod.LeaseDir(str(tmp_path), holder=h) for h in ("gw-a", "gw-b")]
    outcomes = _race(dirs, 4, "p0001")
    wins = [o for o in outcomes if isinstance(o, lease_mod.PlanLease)]
    assert wins and len({id(w) for w in wins}) == 1
    losses = [o for o in outcomes if not isinstance(o, lease_mod.PlanLease)]
    assert all(o is lease_mod.FOREIGN_HELD for o in losses) and len(losses) >= 4
    with open(os.path.join(str(tmp_path), "plan-p0001.lease")) as f:
        assert f.readline().strip() == wins[0].holder


def test_stale_break_needs_timeout_and_dead_pid(tmp_path):
    d = lease_mod.LeaseDir(str(tmp_path), holder="gw-b")
    _stale_lease(str(tmp_path), "p0001", holder="gw-a", pid=os.getpid())
    assert d.try_claim("p0001") is lease_mod.FOREIGN_HELD
    _stale_lease(str(tmp_path), "p0002", age_s=0.0)
    assert d.try_claim("p0002") is lease_mod.FOREIGN_HELD
    before = lease_mod.stats()
    _stale_lease(str(tmp_path), "p0003")
    lease = d.try_claim("p0003", takeover=True)
    assert isinstance(lease, lease_mod.PlanLease) and lease.holder == "gw-b"
    after = lease_mod.stats()
    assert after["breaks"] == before["breaks"] + 1
    assert after["takeovers"] == before["takeovers"] + 1
    assert after["claim_losses"] == before["claim_losses"]


def test_release_unlinks_only_own_lease(tmp_path):
    a = lease_mod.LeaseDir(str(tmp_path), holder="gw-a")
    lease = a.try_claim("p0001")
    with open(lease.path, "w") as f:
        f.write(f"gw-b\n{os.getpid()}\n")
    a.release("p0001")
    with open(lease.path) as f:
        assert f.readline().strip() == "gw-b"
    lease2 = a.try_claim("p0002")
    a.release("p0002")
    assert not os.path.exists(lease2.path)


def test_own_reclaim_returns_held_object(tmp_path):
    d = lease_mod.LeaseDir(str(tmp_path), holder="gw-a")
    assert d.try_claim("p0001") is d.try_claim("p0001")


def test_racing_breakers_break_exactly_once(tmp_path):
    _stale_lease(str(tmp_path), "p0001")
    dirs = [lease_mod.LeaseDir(str(tmp_path), holder=f"gw-{i}") for i in range(4)]
    before = lease_mod.stats()
    outcomes = _race(dirs, 2, "p0001", takeover=True)
    wins = [o for o in outcomes if isinstance(o, lease_mod.PlanLease)]
    assert wins and len({id(w) for w in wins}) == 1 and len({w.holder for w in wins}) == 1
    assert lease_mod.stats()["breaks"] == before["breaks"] + 1
    with open(os.path.join(str(tmp_path), "plan-p0001.lease")) as f:
        assert f.readline().strip() == wins[0].holder
    assert [n for n in os.listdir(str(tmp_path)) if ".breaking" in n or ".broken." in n] == []


def test_pid_reuse_detected_by_start_token(tmp_path):
    token = lease_mod._pid_start_token(os.getpid())
    assert token == jax_lease._pid_start_token(os.getpid())
    if token is None:
        pytest.skip("no /proc start token on this platform")
    d = lease_mod.LeaseDir(str(tmp_path), holder="gw-b")
    _stale_lease(str(tmp_path), "p0001", holder="gw-a", pid=os.getpid(), token="1")
    assert isinstance(d.try_claim("p0001"), lease_mod.PlanLease)
    _stale_lease(str(tmp_path), "p0002", holder="gw-a", pid=os.getpid(), token=token)
    assert d.try_claim("p0002") is lease_mod.FOREIGN_HELD


def test_stale_break_guard_from_dead_breaker_is_cleared(tmp_path):
    d = lease_mod.LeaseDir(str(tmp_path), holder="gw-b")
    guard = _stale_lease(str(tmp_path), "p0001") + ".breaking"
    with open(guard, "w") as f:
        f.write("gw-dead\n999999\n\n")
    old = time.time() - 100
    os.utime(guard, (old, old))
    assert isinstance(d.try_claim("p0001"), lease_mod.PlanLease)
    assert not os.path.exists(guard)


def test_live_break_guard_defers_to_the_breaker(tmp_path):
    d = lease_mod.LeaseDir(str(tmp_path), holder="gw-b")
    path = _stale_lease(str(tmp_path), "p0001")
    with open(path + ".breaking", "w") as f:
        f.write(f"gw-a\n{os.getpid()}\n\n")
    assert d.try_claim("p0001") is lease_mod.FOREIGN_HELD
    assert os.path.exists(path) and os.path.exists(path + ".breaking")


def test_heartbeat_failure_counted_not_fatal(tmp_path):
    lease = lease_mod.LeaseDir(str(tmp_path), holder="gw-a").try_claim("p0001")
    before = lease_mod.stats()
    counters = obs.metrics.snapshot()["counters"]
    with chaos.faults("fleet.heartbeat:p=1.0"):
        assert lease.heartbeat() is False
    after = lease_mod.stats()
    assert after["heartbeat_failures"] == before["heartbeat_failures"] + 1
    now = obs.metrics.snapshot()["counters"]
    assert now["chaos.fired.fleet.heartbeat"] - counters.get("chaos.fired.fleet.heartbeat",
                                                             0) == 1
    assert lease.heartbeat() is True
    assert lease_mod.stats()["heartbeats"] == after["heartbeats"] + 1


def test_lease_claim_chaos_counted_not_fatal(tmp_path):
    d = lease_mod.LeaseDir(str(tmp_path), holder="gw-a")
    before = lease_mod.stats()
    with chaos.faults("fleet.lease:p=1.0"):
        assert d.try_claim("p0001") is None
    assert lease_mod.stats()["claim_failures"] == before["claim_failures"] + 1
    assert isinstance(d.try_claim("p0001"), lease_mod.PlanLease)


def test_claim_names_match_the_jax_package(tmp_path):
    ours = lease_mod.LeaseDir(str(tmp_path), holder="gw-a")
    theirs = jax_lease.LeaseDir(str(tmp_path), holder="gw-a")
    for name in ("p0001", lease_mod.key_claim_id("k"), "device:3", "assist:p0002:1"):
        assert ours._path(name) == theirs._path(name)
    assert lease_mod.key_claim_id("k") == jax_lease.key_claim_id("k")
    assert set(lease_mod.stats()) == set(jax_lease.stats())


# -- journal hardening


def test_corrupt_journal_record_quarantined(tmp_path):
    journal = PlanJournal(str(tmp_path))
    journal.record_submitted("p0001", "q1", meta={})
    with open(os.path.join(str(tmp_path), "plan-p0002.json"), "w") as f:
        f.write("{ not json")
    before = obs.metrics.snapshot()["counters"].get("scheduler.journal_corrupt", 0)
    assert [e["plan_id"] for e in journal.entries()] == ["p0001"]
    assert os.path.exists(os.path.join(str(tmp_path), "plan-p0002.json.corrupt"))
    assert not os.path.exists(os.path.join(str(tmp_path), "plan-p0002.json"))
    assert obs.metrics.snapshot()["counters"]["scheduler.journal_corrupt"] == before + 1
    with open(os.path.join(str(tmp_path), "plan-p0003.json"), "w") as f:
        f.write("also not json")
    assert journal.entry("p0003") is None
    assert os.path.exists(os.path.join(str(tmp_path), "plan-p0003.json.corrupt"))


def test_journal_dir_fsync_refusal_counted(tmp_path, monkeypatch):
    journal = PlanJournal(str(tmp_path))
    monkeypatch.setattr("eeg_dataanalysispackage_tpu_torch.checkpoint.manager._fsync_directory",
                        lambda directory: False)
    before = obs.metrics.snapshot()["counters"].get("scheduler.journal_dir_fsync_failed", 0)
    journal.record_submitted("p0001", "q", meta={})
    after = obs.metrics.snapshot()["counters"]["scheduler.journal_dir_fsync_failed"]
    assert after == before + 1
    assert journal.entry("p0001")["state"] == "submitted"


def test_each_package_reads_the_others_journal(tmp_path):
    ours_dir, theirs_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    for journal in (PlanJournal(ours_dir), JaxJournal(theirs_dir)):
        journal.record_submitted("p0001", "q1", meta={"idempotency_key": "k"})
        journal.record_completed("p0002", "q2", "stats\n", attempts=2, meta={"recovered": True})
        journal.record_failed("p0003", "q3", "boom", attempts=3)
        journal.record_submitted("p10000", "q4")

    def strip(entries):
        return [{k: v for k, v in e.items() if not k.endswith("_utc")} for e in entries]

    ours, theirs = PlanJournal(theirs_dir).entries(), JaxJournal(ours_dir).entries()
    assert strip(ours) == strip(JaxJournal(theirs_dir).entries())
    assert strip(theirs) == strip(PlanJournal(ours_dir).entries())
    assert strip(ours) == strip(theirs)
    assert [e["plan_id"] for e in ours] == ["p0001", "p0002", "p0003", "p10000"]
    assert [e["state"] for e in PlanJournal(theirs_dir).unfinished()] == ["submitted"] * 2


def test_each_package_reads_the_others_lease_and_they_race_to_one_claim(tmp_path):
    ours = lease_mod.LeaseDir(str(tmp_path), holder="gw-port")
    theirs = jax_lease.LeaseDir(str(tmp_path), holder="gw-jax")
    lease = ours.try_claim("p0001")
    info = theirs.holder_info("p0001")
    assert info["holder"] == "gw-port" and info["pid"] == os.getpid() and not info["stale"]
    assert theirs.try_claim("p0001") is jax_lease.FOREIGN_HELD
    lease.release()
    outcomes = []
    barrier = threading.Barrier(8)

    def race(directory):
        barrier.wait()
        outcomes.append(directory.try_claim("p0002"))

    threads = [threading.Thread(target=race, args=(d,)) for d in (ours, theirs)
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wins = [o for o in outcomes if isinstance(o, (lease_mod.PlanLease, jax_lease.PlanLease))]
    assert len({w.holder for w in wins}) == 1 and len({id(w) for w in wins}) == 1
    assert ours.holder_info("p0002")["holder"] == wins[0].holder


# -- executors over one journal


def test_takeover_executes_orphan_byte_identical(session, tmp_path):
    """A dead holder's write-ahead record is claimed by a peer executor and
    run once under its own id, to the direct run's statistics and to the
    JAX executor's takeover of the same record; a keyed re-submit
    replays it."""
    query = _q(session)
    twin = str(PipelineBuilder(query, device="cpu").execute())
    results = {}
    for name, executor, directory, journal_cls in (
            ("port", PlanExecutor, lease_mod.LeaseDir, PlanJournal),
            ("jax", JaxExecutor, jax_lease.LeaseDir, JaxJournal)):
        jdir = str(tmp_path / name)
        journal = journal_cls(jdir)
        journal.record_submitted("p0001", query, meta={"idempotency_key": "k1"})
        _stale_lease(jdir, "p0001")
        ex = executor(journal_dir=jdir)
        ex.leases = directory(jdir, holder="gw-b")
        try:
            (entry,) = journal.unfinished()
            handle = ex.claim_and_run(entry)
            assert handle is not None and handle.plan_id == "p0001"
            result = handle.result(timeout=300)
            assert ex.claim_and_run(entry) is None  # terminal now: never again
            done = _await_terminal(journal, "p0001")
            again = ex.submit(query, idempotency_key="k1")
            assert again.replayed and again.plan_id == "p0001"
        finally:
            ex.close()
        assert not os.path.exists(os.path.join(jdir, "plan-p0001.lease"))
        results[name] = (str(result.statistics), done)
    (ours, our_entry), (theirs, their_entry) = results["port"], results["jax"]
    assert ours == twin and our_entry["statistics"] == twin
    assert ours == theirs and our_entry["statistics_sha256"] == their_entry["statistics_sha256"]
    assert our_entry["meta"]["fleet"] == their_entry["meta"]["fleet"] == {
        "replica": "gw-b", "takeover": True}
    assert our_entry["meta"]["recovered"] is their_entry["meta"]["recovered"] is True


def test_two_executors_over_one_orphan_run_it_once(session, tmp_path):
    jdir = str(tmp_path / "journal")
    query = _q(session)
    PlanJournal(jdir).record_submitted("p0001", query)
    _stale_lease(jdir, "p0001")
    executors = []
    for holder in ("gw-a", "gw-b"):
        ex = PlanExecutor(journal_dir=jdir)
        ex.leases = lease_mod.LeaseDir(jdir, holder=holder)
        executors.append(ex)
    handles, barrier = [], threading.Barrier(2)

    def claim(ex):
        barrier.wait()
        handles.append(ex.claim_and_run(PlanJournal(jdir).entry("p0001")))

    try:
        threads = [threading.Thread(target=claim, args=(ex,)) for ex in executors]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        won = [h for h in handles if h is not None]
        assert len(won) == 1
        won[0].result(timeout=300)
    finally:
        for ex in executors:
            ex.close()
    assert _await_terminal(PlanJournal(jdir), "p0001")["state"] == "completed"


def test_fresh_ids_never_collide_across_replicas(session, tmp_path):
    jdir = str(tmp_path / "journal")
    a, b = PlanExecutor(journal_dir=jdir), PlanExecutor(journal_dir=jdir)
    a.leases = lease_mod.LeaseDir(jdir, holder="gw-a")
    b.leases = lease_mod.LeaseDir(jdir, holder="gw-b")
    try:
        ha, hb = a.submit(_q(session)), b.submit(_q(session))
        assert ha.plan_id != hb.plan_id
        ha.result(timeout=300)
        hb.result(timeout=300)
    finally:
        a.close()
        b.close()
    journal = PlanJournal(jdir)
    for handle, replica in ((ha, "gw-a"), (hb, "gw-b")):
        entry = journal.entry(handle.plan_id)
        assert entry["state"] == "completed"
        assert entry["meta"]["fleet"] == {"replica": replica, "takeover": False}


def test_fresh_id_skips_peer_record_when_claim_unavailable(session, tmp_path):
    jdir = str(tmp_path / "journal")
    ex = PlanExecutor(journal_dir=jdir, max_concurrent=1)
    ex.leases = lease_mod.LeaseDir(jdir, holder="gw-a")
    peer = PlanJournal(jdir)
    peer.record_completed("p0001", "peer-query", "peer-stats")
    try:
        with chaos.faults("fleet.lease:p=1.0"):
            handle = ex.submit(_q(session))
        assert handle.plan_id == "p0002"
        handle.result(timeout=300)
    finally:
        ex.close()
    assert peer.entry("p0001")["statistics"] == "peer-stats"
    assert peer.entry("p0002")["state"] == "completed"


def test_concurrent_new_key_registers_exactly_one_plan(session, tmp_path):
    jdir = str(tmp_path / "journal")
    executors = []
    for holder in ("gw-a", "gw-b"):
        ex = PlanExecutor(journal_dir=jdir)
        ex.leases = lease_mod.LeaseDir(jdir, holder=holder)
        executors.append(ex)
    handles, barrier = [], threading.Barrier(2)

    def go(ex):
        barrier.wait()
        handles.append(ex.submit(_q(session), idempotency_key="race-key"))

    try:
        threads = [threading.Thread(target=go, args=(ex,)) for ex in executors]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len({h.plan_id for h in handles}) == 1
        (plan_id,) = {h.plan_id for h in handles}
        journal = PlanJournal(jdir)
        assert [e["plan_id"] for e in journal.entries()] == [plan_id]
        assert _await_terminal(journal, plan_id)["state"] == "completed"
        assert not [n for n in os.listdir(jdir) if n.startswith("key-")]
    finally:
        for ex in executors:
            ex.close()


def test_key_claim_degrades_after_wait_budget(session, tmp_path):
    jdir = str(tmp_path / "journal")
    ex = PlanExecutor(journal_dir=jdir, max_concurrent=1)
    ex.leases = lease_mod.LeaseDir(jdir, holder="gw-a")
    ex.key_claim_wait_s = 0.2
    peer = lease_mod.LeaseDir(jdir, holder="gw-peer")
    assert isinstance(peer.try_claim(lease_mod.key_claim_id("k-stuck")), lease_mod.PlanLease)
    before = obs.metrics.snapshot()["counters"].get("scheduler.key_claim_degraded", 0)
    try:
        handle = ex.submit(_q(session), idempotency_key="k-stuck")
        handle.result(timeout=300)
    finally:
        ex.close()
    assert obs.metrics.snapshot()["counters"]["scheduler.key_claim_degraded"] == before + 1
    assert PlanJournal(jdir).entry(handle.plan_id)["state"] == "completed"


def test_keyed_resubmit_of_peer_held_plan_names_owner(session, tmp_path):
    jdir = str(tmp_path / "journal")
    query = _q(session)
    PlanJournal(jdir).record_submitted("p0001", query, meta={"idempotency_key": "k1"})
    _stale_lease(jdir, "p0001", holder="gw-a", pid=os.getpid(), age_s=0.0)
    ex = PlanExecutor(journal_dir=jdir)
    ex.leases = lease_mod.LeaseDir(jdir, holder="gw-b")
    try:
        with pytest.raises(executor_mod.PlanOwnedElsewhereError) as owned:
            ex.submit(query, idempotency_key="k1")
        assert owned.value.holder == "gw-a" and owned.value.plan_id == "p0001"
        assert ex.recover()["resumed"] == []  # recovery leaves it to its holder
    finally:
        ex.close()
    assert PlanJournal(jdir).entry("p0001")["state"] == "submitted"
    with open(os.path.join(jdir, "plan-p0001.lease")) as f:
        assert f.readline().strip() == "gw-a"


def test_drain_queued_hands_plans_back(session, tmp_path, monkeypatch):
    from eeg_dataanalysispackage_tpu_torch.scheduler import runtime as runtime_mod

    release = threading.Event()

    def blocked(plan, builder, plan_id=None, **kw):
        assert release.wait(30)
        return f"done-{plan_id}"

    monkeypatch.setattr(runtime_mod, "execute_plan", blocked)
    jdir = str(tmp_path / "journal")
    ex = PlanExecutor(journal_dir=jdir, max_concurrent=1)
    ex.leases = lease_mod.LeaseDir(jdir, holder="gw-a")
    try:
        h1 = ex.submit(_q(session))
        h2 = ex.submit(_q(session))
        deadline = time.monotonic() + 5
        while h1.state != "running" and time.monotonic() < deadline:
            time.sleep(0.005)
        assert ex.drain_queued() == [h2.plan_id]
        assert not os.path.exists(os.path.join(jdir, f"plan-{h2.plan_id}.lease"))
        assert PlanJournal(jdir).entry(h2.plan_id)["state"] == "submitted"
        release.set()
        assert h1.result(timeout=30).statistics == f"done-{h1.plan_id}"
    finally:
        release.set()
        ex.close()
