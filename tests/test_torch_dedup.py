"""The port's cross-tenant prefix dedup (``scheduler/dedup.py`` and its
builder hooks) against the JAX package's, on the CPU: the twins of the JAX
package's ``tests/test_dedup.py``.

- **keys**: ``prefix_key`` and ``device_footprint`` equal the JAX package's
  for a matrix of queries; the canonical key is blind to knob order, the
  prefix key to the classifier suffix, and splits on the featurize knobs;
- **the registry**: leader and follower share one value (numpy frozen, the
  torch tensor shared as it is), an abandoned leader promotes its follower,
  a follower's wait honours the deadline, READY entries are LRU-bounded;
- **end to end through the executor**: a logreg and an svm plan over one
  session compute the prefix once (the files read once), both statistics
  byte-equal to their solo ``dedup=false`` runs and to the JAX executor's,
  the dedup blocks equal the JAX package's (role, prefix key, rows, the
  leader relation, ``bytes_saved``), and the leader's feature rows keep
  one digest across the follower's fit; a doomed or faulted leader costs
  the follower time, never bits; the seizure prefix dedups the same way; a
  follower never reaches the feature cache; a bf16 follower inherits the
  leader's gate decision; ``dedup=false`` and ``EEG_TPU_NO_PREFIX_DEDUP=1``
  opt out.
"""

import hashlib
import importlib.util
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan as JaxPlan
from eeg_dataanalysispackage_tpu.scheduler import PlanExecutor as JaxExecutor
from eeg_dataanalysispackage_tpu.scheduler import dedup as jax_dedup
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import deadline as deadline_mod
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain as run_domain
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch.scheduler import PlanExecutor as _PlanExecutor
from eeg_dataanalysispackage_tpu_torch.scheduler import PrefixRegistry
from eeg_dataanalysispackage_tpu_torch.scheduler import dedup as dedup_mod

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def PlanExecutor(**kwargs):
    return _PlanExecutor(device="cpu", **kwargs)


@pytest.fixture(autouse=True)
def _fresh_registry():
    dedup_mod.reset()
    assert chaos.active_plan() is None
    assert run_domain.current() is None
    yield
    dedup_mod.reset()
    chaos.uninstall()


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("dedup")), n_markers=60)


@pytest.fixture(scope="module")
def seizure_info(tmp_path_factory):
    return _synthetic.write_seizure_session(str(tmp_path_factory.mktemp("dedup_seiz")))


def _q(info, extra="", clf="logreg", fe="dwt-8-fused"):
    return (f"info_file={info}&fe={fe}&train_clf={clf}&config_step_size=1.0"
            "&config_num_iterations=20&config_mini_batch_fraction=1.0" + extra)


def _svm(info, extra=""):
    return _q(info, "&config_reg_param=0.1" + extra, clf="svm")


def _seizure_q(info):
    return (f"info_file={info}&task=seizure&fe=dwt-4:level=3:stats=energy&window=512"
            "&stride=256&train_clf=logreg&config_num_iterations=20&config_step_size=1.0"
            "&config_mini_batch_fraction=1.0&cost_fp=1")


def _sha(statistics):
    return hashlib.sha256(str(statistics).encode()).hexdigest()


def _pair(make_executor, qa, qb, **kwargs):
    with make_executor(max_concurrent=2, **kwargs) as ex:
        ha, hb = ex.submit(qa), ex.submit(qb)
        return ha.result(timeout=300), hb.result(timeout=300)


def _blocks(results):
    """The pair's dedup blocks by role, the timings left out."""
    out = {}
    for r in results:
        block = dict(r.builder.dedup_resolved)
        block.pop("build_seconds", None)
        block.pop("seconds_saved", None)
        if block["role"] == "follower":
            leader = next(x for x in results if x is not r)
            assert block.pop("leader_plan") == leader.plan_id
        out[block["role"]] = block
    return out


@pytest.fixture(scope="module")
def jax_pairs(session, seizure_info):
    """The JAX executor's fused and seizure pairs, its registry's stats
    after each."""
    out = {}
    for name, (qa, qb) in {
        "fused": (_q(session), _svm(session)),
        "seizure": (_seizure_q(seizure_info) + "&cost_fn=1",
                    _seizure_q(seizure_info) + "&cost_fn=8"),
    }.items():
        jax_dedup.reset()
        out[name] = (_pair(JaxExecutor, qa, qb), jax_dedup.stats())
    jax_dedup.reset()
    return out


# -- keys


@pytest.mark.parametrize("extra", [
    "", "&cache=false", "&precision=bf16", "&devices=2", "&mesh_axes=data",
    "&cv=4&seeds=2", "&cv=8&seeds=4", "&processes=2", "&dedup=false", "&overlap=true",
])
@pytest.mark.parametrize("fe", ["dwt-8-fused", "dwt-8-fused-block", "dwt-8"])
def test_prefix_key_and_footprint_match_the_jax_package(session, fe, extra):
    q = _q(session, extra, fe=fe)
    if "precision" in extra and fe != "dwt-8-fused":
        # precision= rides the bare fused spelling: both parsers refuse alike
        with pytest.raises(ValueError) as jax_error:
            JaxPlan.parse(q)
        with pytest.raises(ValueError, match=str(jax_error.value)[:40]):
            ExecutionPlan.parse(q)
        return
    port, jax = ExecutionPlan.parse(q), JaxPlan.parse(q)
    assert port.prefix_key() == jax.prefix_key()
    assert port.canonical_key() == jax.canonical_key()
    assert port.device_footprint() == jax.device_footprint()
    assert dedup_mod.eligible(port) == jax_dedup.eligible(jax)


def test_canonical_key_is_order_insensitive(session):
    a = ExecutionPlan.parse(_q(session))
    b = ExecutionPlan.parse(f"train_clf=logreg&fe=dwt-8-fused&info_file={session}"
                            "&config_num_iterations=20&config_step_size=1.0"
                            "&config_mini_batch_fraction=1.0")
    assert a.canonical_key() == b.canonical_key()
    assert a.prefix_key() == b.prefix_key()


def test_prefix_key_shared_across_classifier_suffixes(session):
    a, b = ExecutionPlan.parse(_q(session)), ExecutionPlan.parse(_svm(session))
    assert a.canonical_key() != b.canonical_key()
    assert a.prefix_key() == b.prefix_key()


def test_prefix_key_splits_on_featurize_knobs(session, tmp_path):
    base = ExecutionPlan.parse(_q(session))
    for extra, fe in (("", "dwt-8-fused-block"), ("&precision=bf16", "dwt-8-fused")):
        assert ExecutionPlan.parse(_q(session, extra, fe=fe)).prefix_key() != base.prefix_key()
    other = _synthetic.write_session(str(tmp_path), n_markers=60)
    assert ExecutionPlan.parse(_q(other)).prefix_key() != base.prefix_key()


def test_serve_and_host_plans_are_not_deduped(session):
    serve = ExecutionPlan.parse(f"info_file={session}&fe=dwt-8&serve=true&load_clf=logreg"
                                "&result_path=/tmp/x")
    assert serve.prefix_key() is None and not dedup_mod.eligible(serve)
    assert not dedup_mod.eligible(ExecutionPlan.parse(_q(session, fe="dwt-8")))
    assert dedup_mod.eligible(ExecutionPlan.parse(_q(session)))


def test_opt_outs(session, monkeypatch):
    plan = ExecutionPlan.parse(_q(session, "&dedup=false"))
    assert not plan.dedup and not dedup_mod.eligible(plan)
    monkeypatch.setenv(dedup_mod.ENV_DISABLE, "1")
    assert not dedup_mod.eligible(ExecutionPlan.parse(_q(session)))


def test_a_solo_run_claims_nothing(session):
    b = PipelineBuilder(_q(session), device="cpu")
    b.execute()
    assert b.dedup_resolved is None and dedup_mod.stats()["leads"] == 0


# -- the registry protocol


def test_leader_follower_value_sharing():
    registry = PrefixRegistry()
    value = (torch.ones(4, 2), np.zeros(4))
    leader = registry.acquire("k1", "pA")
    assert leader.role == "leader"
    got = {}
    t = threading.Thread(target=lambda: got.update(claim=registry.acquire("k1", "pB")))
    t.start()
    time.sleep(0.05)  # the follower parks on the building entry
    leader.publish(value, meta={"precision_used": "f32"})
    t.join(timeout=10)
    claim = got["claim"]
    assert claim.role == "follower" and claim.leader_plan == "pA"
    assert claim.meta == {"precision_used": "f32"}
    # the tensor and the array are counted; the tensor is shared, the
    # array frozen
    assert claim.bytes_saved == 4 * 2 * 4 + 4 * 8
    assert claim.value[0] is value[0]
    with pytest.raises(ValueError):
        claim.value[1][0] = 5.0
    stats = registry.stats()
    assert stats["leads"] == 1 and stats["hits"] == 1 and stats["hit_ratio"] == 0.5


def test_abandoned_leader_promotes_follower():
    registry = PrefixRegistry()
    leader = registry.acquire("k1", "pA")
    got = {}
    t = threading.Thread(target=lambda: got.update(claim=registry.acquire("k1", "pB")))
    t.start()
    time.sleep(0.05)
    leader.settle()  # an unpublished leader in its finally
    t.join(timeout=10)
    assert got["claim"].role == "leader" and got["claim"].leader_failed
    assert registry.stats()["leader_failures"] == 1


def test_follower_wait_honours_deadline():
    registry = PrefixRegistry()
    registry.acquire("k1", "pA")  # building, never published
    with deadline_mod.deadline_scope(deadline_mod.Deadline(0.15)):
        with pytest.raises(deadline_mod.DeadlineExceededError):
            registry.acquire("k1", "pB")


def test_ready_entries_are_lru_bounded(monkeypatch):
    registry = PrefixRegistry(capacity=2)
    for i in range(3):
        registry.acquire(f"k{i}", f"p{i}").publish((np.zeros(1),))
    stats = registry.stats()
    assert stats["entries"] == 2 and stats["evictions"] == 1
    assert registry.acquire("k0", "pX").role == "leader"
    assert registry.acquire("k1", "pY").role == "follower"
    monkeypatch.setenv(dedup_mod.ENV_CAPACITY, "1")
    assert PrefixRegistry()._cap() == 1


# -- end to end through the executor


def test_shared_prefix_pair_computes_once(session, tmp_path, jax_pairs):
    """One read and featurize pass for the pair; both statistics byte-equal
    to their solo dedup=false runs and to the JAX executor's pair; the
    blocks equal the JAX package's; the leader's rows keep their digest
    across the follower's fit."""
    before = obs.metrics.snapshot()["counters"]
    solo_builder = PipelineBuilder(_q(session, "&dedup=false"), device="cpu")
    solo_a = solo_builder.execute()
    reads_per_build = int(obs.metrics.snapshot()["counters"].get("ingest.file_reads", 0)
                          - before.get("ingest.file_reads", 0))
    solo_b = PipelineBuilder(_svm(session, "&dedup=false"), device="cpu").execute()

    before = obs.metrics.snapshot()["counters"]
    reports = tmp_path / "reports"
    results = _pair(PlanExecutor, _q(session), _svm(session), report_root=str(reports))
    after = obs.metrics.snapshot()["counters"]
    assert [_sha(r.statistics) for r in results] == [_sha(solo_a), _sha(solo_b)]
    jax_results, jax_stats = jax_pairs["fused"]
    assert [str(r.statistics) for r in results] == [str(r.statistics) for r in jax_results]
    assert dedup_mod.stats() == jax_stats
    assert reads_per_build > 0
    assert after.get("ingest.file_reads", 0) - before.get("ingest.file_reads", 0) \
        == reads_per_build
    # role, prefix key, rows, the leader relation and bytes_saved
    blocks = _blocks(results)
    assert blocks == _blocks(jax_results)
    assert blocks["follower"]["bytes_saved"] > 0
    for r in results:
        report = json.load(open(reports / r.plan_id / "run_report.json"))
        assert report["dedup"] == r.builder.dedup_resolved
    # the follower fit on the leader's tensor itself, and left it as a solo
    # build makes it
    leader = next(r for r in results if r.builder.dedup_resolved["role"] == "leader")
    follower = next(r for r in results if r is not leader)
    assert follower.builder.features is leader.builder.features
    assert torch.equal(leader.builder.features, solo_builder.features)


def test_dedup_false_builds_independently(session):
    r1, r2 = _pair(PlanExecutor, _q(session, "&dedup=false"), _q(session, "&dedup=false"))
    assert str(r1.statistics) == str(r2.statistics)
    stats = dedup_mod.stats()
    assert stats["leads"] == 0 and stats["hits"] == 0
    assert r1.builder.dedup_resolved is None


def test_leader_failure_promotes_follower_end_to_end(session):
    """The test plays the doomed leader through the real registry: the
    clean plan parks, is promoted when the leader abandons, computes its own
    prefix and lands its solo statistics."""
    solo = PipelineBuilder(_q(session, "&dedup=false"), device="cpu").execute()
    key = ExecutionPlan.parse(_q(session)).prefix_key()
    waits_before = obs.metrics.snapshot()["counters"].get("dedup.wait", 0)
    doomed = dedup_mod.registry().acquire(key, "pDOOMED")
    with PlanExecutor(max_concurrent=1) as ex:
        h = ex.submit(_q(session))
        deadline = time.monotonic() + 30
        while (obs.metrics.snapshot()["counters"].get("dedup.wait", 0) <= waits_before
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert not h.done
        doomed.settle()
        r = h.result(timeout=300)
    assert _sha(r.statistics) == _sha(solo)
    stats = dedup_mod.stats()
    assert stats["leads"] == 2 and stats["leader_failures"] == 1
    assert r.builder.dedup_resolved["role"] == "leader"
    assert r.builder.dedup_resolved["promoted_after_leader_failure"] is True


def test_leader_chaos_failure_never_corrupts_follower(session):
    """An ingest.fused-faulted leader (it fails: the port has no ladder) and
    a clean plan race for one prefix: the clean plan's statistics are its
    solo run's, and nothing was shared from the failed build."""
    solo = PipelineBuilder(_q(session, "&dedup=false"), device="cpu").execute()
    with PlanExecutor(max_concurrent=2, max_attempts=1) as ex:
        h_leader = ex.submit(_q(session, "&faults=ingest.fused:every@1&degrade=false"))
        deadline = time.monotonic() + 30
        while dedup_mod.stats()["leads"] == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        h_follower = ex.submit(_q(session))
        with pytest.raises(Exception):
            h_leader.result(timeout=300)
        r = h_follower.result(timeout=300)
    assert _sha(r.statistics) == _sha(solo)
    assert dedup_mod.stats()["hits"] == 0


def test_seizure_prefix_dedup(seizure_info, jax_pairs):
    q = _seizure_q(seizure_info)
    solo = [PipelineBuilder(q + f"&cost_fn={c}&dedup=false", device="cpu").execute()
            for c in (1, 8)]
    results = _pair(PlanExecutor, q + "&cost_fn=1", q + "&cost_fn=8")
    assert [_sha(r.statistics) for r in results] == [_sha(s) for s in solo]
    jax_results, jax_stats = jax_pairs["seizure"]
    assert [str(r.statistics) for r in results] == [str(r.statistics) for r in jax_results]
    assert dedup_mod.stats() == jax_stats
    port, jax = _blocks(results), _blocks(jax_results)
    assert port["follower"]["rows"] == jax["follower"]["rows"]
    assert port["follower"]["bytes_saved"] == jax["follower"]["bytes_saved"]


def test_dedup_sits_above_the_feature_cache(session, tmp_path, monkeypatch):
    """A follower never reaches the feature cache: the pair stores once and
    the follower counts neither a hit nor a miss."""
    monkeypatch.delenv("EEG_TPU_NO_FEATURE_CACHE", raising=False)
    monkeypatch.setenv("EEG_TPU_FEATURE_CACHE_DIR", str(tmp_path / "fc"))
    before = obs.metrics.snapshot()["counters"]
    results = _pair(PlanExecutor, _q(session), _svm(session))
    after = obs.metrics.snapshot()["counters"]
    assert after.get("feature_cache.store", 0) - before.get("feature_cache.store", 0) == 1
    follower = next(r for r in results if r.builder.dedup_resolved["role"] == "follower")
    counters = follower.builder.run_metrics.snapshot()["counters"]
    assert counters.get("feature_cache.hit", 0) == 0
    assert counters.get("feature_cache.miss", 0) == 0
    assert counters.get("dedup.hit") == 1
    assert follower.builder.backend_resolved["landed"] == "dedup"


def test_a_bf16_follower_inherits_the_leaders_gate(session):
    solo = PipelineBuilder(_svm(session, "&precision=bf16&dedup=false"), device="cpu").execute()
    results = _pair(PlanExecutor, _q(session, "&precision=bf16"),
                    _svm(session, "&precision=bf16"))
    assert str(results[1].statistics) == str(solo)
    leader = next(r for r in results if r.builder.dedup_resolved["role"] == "leader")
    follower = next(r for r in results if r is not leader)
    assert follower.builder.precision_resolved == {
        "requested": "bf16", "used": leader.builder.precision_resolved["used"],
        "gate": {"source": "dedup", "leader_plan": leader.plan_id}}


def test_obs_report_shows_a_port_reports_dedup_block(session, tmp_path, capsys):
    spec = importlib.util.spec_from_file_location(
        "obs_report_tool", os.path.join(REPO, "tools", "obs_report.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    results = _pair(PlanExecutor, _q(session), _svm(session),
                    report_root=str(tmp_path / "reports"))
    paths = {r.builder.dedup_resolved["role"]:
             str(tmp_path / "reports" / r.plan_id / "run_report.json") for r in results}
    tool.show(paths["follower"])
    out = capsys.readouterr().out
    assert "role=follower" in out and "bytes_saved=" in out
    tool.show(paths["leader"])
    assert "role=leader" in capsys.readouterr().out
