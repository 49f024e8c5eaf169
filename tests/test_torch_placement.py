"""The port's device placement (``scheduler/placement.py`` and the
executor's gang scheduling) on the CPU: the twins of the JAX package's
``tests/test_placement.py``.

- **footprints**: ``device_footprint`` equals the JAX package's for the
  JAX suite's matrix of queries;
- **the device-lease race**: two replica identities race one pool's
  ordinals, every ordinal lands with exactly one holder, losses counted;
  a gang that cannot fit holds nothing; exempt and oversize footprints run
  unplaced;
- **backfill and promotion**: a blocked gang waits (its record stays
  ``submitted``) while a smaller plan backfills past it; the freed pool
  grants the gang, its leased ordinals in its journal meta and its mesh
  record; past ``EEG_TPU_GANG_PROMOTION_S`` the oldest waiting gang gets
  every freed ordinal;
- **the port's own**: ``EEG_TPU_DEVICE_POOL=auto`` counts the visible cards
  (and raises with none), a placement attempt that raises runs the plan
  unplaced (counted), ``execute_plan(placement=)`` builds a meshed plan's
  mesh from exactly the leased ordinals, and a leased ordinal the process
  cannot see raises.
"""

import json
import os
import sys
import threading
import time

import pytest
import torch

from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan as JaxPlan
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch.scheduler import lease as lease_mod
from eeg_dataanalysispackage_tpu_torch.scheduler import placement, runtime
from eeg_dataanalysispackage_tpu_torch.scheduler.executor import PlanExecutor as _PlanExecutor
from eeg_dataanalysispackage_tpu_torch.scheduler.journal import PlanJournal

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402


def PlanExecutor(**kwargs):
    return _PlanExecutor(device="cpu", **kwargs)


@pytest.fixture(autouse=True)
def _fast_lease(monkeypatch):
    monkeypatch.setenv(lease_mod.ENV_LEASE_TIMEOUT, "1")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("placement")), n_markers=60)


def _q(info, extra=""):
    return (f"info_file={info}&fe=dwt-8&train_clf=logreg&config_step_size=1.0"
            "&config_num_iterations=20&config_mini_batch_fraction=1.0&dedup=false" + extra)


def _counters():
    return obs.metrics.snapshot()["counters"]


def _pool(directory, holder="gw-a", size=2):
    return placement.DevicePool(lease_mod.LeaseDir(str(directory), holder=holder), size=size)


ONE = {"devices": 1, "hosts": 1, "memory_class": "light"}

_BASE = "info_file=/tmp/x/info.txt&fe=dwt-8&train_clf=logreg"


@pytest.mark.parametrize("extra,expected", [
    ("", {"devices": 1, "hosts": 1, "memory_class": "light"}),
    ("&devices=4", {"devices": 4, "hosts": 1, "memory_class": "heavy"}),
    ("&mesh_axes=data:2,time:2", {"devices": 4, "hosts": 1, "memory_class": "heavy"}),
    ("&mesh_axes=data", {"devices": 0, "hosts": 1, "memory_class": "heavy"}),
    ("&processes=2", {"devices": 1, "hosts": 2, "memory_class": "heavy"}),
    ("&cv=4&seeds=2", {"devices": 1, "hosts": 1, "memory_class": "standard"}),
    ("&cv=8&seeds=4", {"devices": 1, "hosts": 1, "memory_class": "heavy"}),
    ("&serve=true", {"devices": 1, "hosts": 1, "memory_class": "serve"}),
])
def test_footprint_matrix(extra, expected):
    plan = ExecutionPlan.parse(_BASE + extra)
    assert plan.device_footprint() == expected
    assert plan.device_footprint() == JaxPlan.parse(_BASE + extra).device_footprint()
    assert plan.device_footprint() == plan.device_footprint()


def test_two_replicas_race_ordinals_exactly_one_holder(tmp_path):
    pool_a, pool_b = _pool(tmp_path, "gw-a", 4), _pool(tmp_path, "gw-b", 4)
    before = lease_mod.stats()
    footprint = {"devices": 2, "hosts": 1, "memory_class": "heavy"}
    grants, lock = [], threading.Lock()
    barrier = threading.Barrier(8)

    def race(pool, plan_id):
        barrier.wait()
        got = pool.admit(plan_id, footprint)
        if isinstance(got, placement.DeviceGrant):
            with lock:
                grants.append(got)

    threads = [threading.Thread(target=race, args=(pool_a if i % 2 == 0 else pool_b,
                                                   f"p{i:04d}")) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # a 4-ordinal pool fits exactly two 2-device gangs
    assert len(grants) == 2
    flat = [o for g in grants for o in g.ordinals]
    assert sorted(flat) == sorted(set(flat))
    table = placement.device_table(str(tmp_path))
    assert sorted(r["ordinal"] for r in table) == sorted(flat)
    assert all(r["holder"] in ("gw-a", "gw-b") for r in table)
    after = lease_mod.stats()
    assert after["device_claims"] - before["device_claims"] >= 4
    assert after["device_claim_losses"] > before["device_claim_losses"]
    for g in grants:
        g.release()
    assert placement.device_table(str(tmp_path)) == []
    assert lease_mod.stats()["device_releases"] > before["device_releases"]


def test_all_or_nothing_no_partial_gang_held(tmp_path):
    pool_a = _pool(tmp_path, "gw-a", 4)
    b = lease_mod.LeaseDir(str(tmp_path), holder="gw-b")
    assert isinstance(b.try_claim("device:2"), lease_mod.PlanLease)
    assert isinstance(b.try_claim("device:3"), lease_mod.PlanLease)
    assert pool_a.admit("gang", {"devices": 3, "hosts": 1, "memory_class": "heavy"}) is None
    table = placement.device_table(str(tmp_path))
    assert [(r["ordinal"], r["holder"]) for r in table] == [(2, "gw-b"), (3, "gw-b")]
    waiting = placement.waiting_entries(str(tmp_path))
    assert [e["plan_id"] for e in waiting] == ["gang"]
    assert waiting[0]["footprint"]["devices"] == 3


def test_exempt_and_oversize_run_unplaced(tmp_path):
    pool = _pool(tmp_path, size=2)
    for footprint in ({"devices": 1, "hosts": 1, "memory_class": "serve"},
                      {"devices": 1, "hosts": 2, "memory_class": "heavy"},
                      {"devices": 3, "hosts": 1, "memory_class": "heavy"}):
        assert pool.admit("px", footprint) is placement.UNPLACED
    assert placement.device_table(str(tmp_path)) == []
    assert placement.waiting_entries(str(tmp_path)) == []


def test_small_plan_backfills_past_blocked_gang(session, tmp_path, monkeypatch):
    """A 2-device gang blocked on a peer-held ordinal waits (record
    ``submitted``) while a 1-device plan submitted after it completes; the
    freed ordinal grants the gang, whose journal meta and mesh record name
    the leased ordinals."""
    monkeypatch.setenv(placement.ENV_GANG_PROMOTION, "600")
    journal_dir = str(tmp_path / "journal")
    os.makedirs(journal_dir)
    peer = lease_mod.LeaseDir(journal_dir, holder="gw-peer")
    assert isinstance(peer.try_claim("device:1"), lease_mod.PlanLease)
    before = _counters()
    ex = PlanExecutor(journal_dir=journal_dir, max_concurrent=1)
    ex.placement = _pool(journal_dir, "gw-a", 2)
    journal = PlanJournal(journal_dir)
    try:
        gang = ex.submit(_q(session, "&devices=2"))
        deadline = time.monotonic() + 60
        while not placement.waiting_entries(journal_dir) and time.monotonic() < deadline:
            time.sleep(0.02)
        assert [e["plan_id"] for e in placement.waiting_entries(journal_dir)] == [gang.plan_id]
        small = ex.submit(_q(session))
        small.result(timeout=300)
        assert journal.entry(small.plan_id)["state"] == "completed"
        assert journal.entry(gang.plan_id)["state"] == "submitted"
        assert _counters().get("placement.backfills", 0) > before.get("placement.backfills", 0)
        peer.release("device:1")
        result = gang.result(timeout=300)
        entry = journal.entry(gang.plan_id)
        assert entry["state"] == "completed"
        assert entry["meta"]["fleet"]["devices"] == [0, 1]
        assert result.builder.mesh_resolved["leased"] == [0, 1]
        assert result.builder.mesh_resolved["devices"] == 2
        assert placement.waiting_entries(journal_dir) == []
    finally:
        ex.close()
    assert placement.device_table(journal_dir) == []


def test_promotion_blocks_other_grants_until_gang_fits(tmp_path, monkeypatch):
    monkeypatch.setenv(placement.ENV_GANG_PROMOTION, "0.2")
    peer = lease_mod.LeaseDir(str(tmp_path), holder="gw-peer")
    assert isinstance(peer.try_claim("device:0"), lease_mod.PlanLease)
    pool = _pool(tmp_path, size=1)
    before = _counters()
    assert pool.admit("gang", ONE) is None  # waits; the clock starts
    time.sleep(0.3)
    peer.release("device:0")
    assert pool.admit("small", ONE) is None  # the promoted gang owns it
    assert _counters().get("placement.promotion_blocked", 0) \
        > before.get("placement.promotion_blocked", 0)
    granted = pool.admit("gang", ONE)
    assert isinstance(granted, placement.DeviceGrant) and granted.ordinals == (0,)
    assert _counters().get("placement.promotions", 0) > before.get("placement.promotions", 0)
    assert [e["plan_id"] for e in placement.waiting_entries(str(tmp_path))] == ["small"]
    granted.release()
    small = pool.admit("small", ONE)
    assert isinstance(small, placement.DeviceGrant)
    small.release()
    assert placement.waiting_entries(str(tmp_path)) == []


def test_dead_holders_waiting_record_cleared(tmp_path):
    path = os.path.join(str(tmp_path), "waiting-p0001.json")
    with open(path, "w") as f:
        json.dump({"schema": "eeg-tpu-placement-wait/v1", "plan_id": "p0001",
                   "footprint": {"devices": 2, "hosts": 1, "memory_class": "heavy"},
                   "since": time.time() - 100.0, "holder": "gw-dead", "pid": 999999,
                   "start_token": ""}, f)
    assert placement.waiting_entries(str(tmp_path)) == []
    assert os.path.exists(path)
    assert placement.waiting_entries(str(tmp_path), clear_dead=True) == []
    assert not os.path.exists(path)


def test_pool_from_env(tmp_path, monkeypatch):
    """Unset or 0: placement off; an integer: that many ordinals, advertised
    in the marker; auto: the visible cards, raising with none."""
    leases = lease_mod.LeaseDir(str(tmp_path), holder="gw-a")
    monkeypatch.delenv(placement.ENV_DEVICE_POOL, raising=False)
    assert placement.DevicePool.from_env(leases) is None
    monkeypatch.setenv(placement.ENV_DEVICE_POOL, "0")
    assert placement.DevicePool.from_env(leases) is None
    monkeypatch.setenv(placement.ENV_DEVICE_POOL, "3")
    pool = placement.DevicePool.from_env(leases)
    assert pool is not None and pool.size == 3
    assert placement.pool_size_marker(str(tmp_path)) == 3
    monkeypatch.setenv(placement.ENV_DEVICE_POOL, "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert placement.DevicePool.from_env(leases).size == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="sees none"):
        placement.DevicePool.from_env(leases)


def test_a_failed_placement_runs_the_plan_unplaced(session, tmp_path):
    class Broken:
        def admit(self, plan_id, footprint):
            raise OSError("the pool's directory went away")

    before = _counters()
    with PlanExecutor(max_concurrent=1) as ex:
        ex.placement = Broken()
        result = ex.submit(_q(session)).result(timeout=300)
    assert str(result.statistics) == str(PipelineBuilder(_q(session), device="cpu").execute())
    assert _counters().get("placement.errors", 0) == before.get("placement.errors", 0) + 1
    assert result.builder.placement_devices is None


def test_execute_plan_builds_the_mesh_from_the_leased_ordinals(session):
    q = _q(session, "&devices=2")
    plan = ExecutionPlan.parse(q)
    b = PipelineBuilder(q, device="cpu")
    stats = runtime.execute_plan(plan, b, placement=(3, 5))
    assert str(stats) == str(PipelineBuilder(q, device="cpu").execute())
    assert b.mesh_resolved["leased"] == [3, 5]
    assert b.mesh_resolved["rung"] == "mesh" and b.mesh_resolved["devices"] == 2
    # a single-device plan's grant is a capacity token: no mesh, same bits
    b1 = PipelineBuilder(_q(session), device="cpu")
    runtime.execute_plan(ExecutionPlan.parse(_q(session)), b1, placement=(0,))
    assert b1.placement_devices == (0,) and b1.mesh_resolved is None


def test_a_leased_ordinal_this_process_cannot_see_raises(monkeypatch):
    b = PipelineBuilder(_BASE, device="cpu")
    b.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert b._leased_devices((1, 0)) == [torch.device("cuda", 1), torch.device("cuda", 0)]
    with pytest.raises(ValueError, match=r"\[2\] are not visible"):
        b._leased_devices((0, 2))
