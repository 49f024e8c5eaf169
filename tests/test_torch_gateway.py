"""The port's plan service (``gateway/server.py``) against the JAX package's,
on the CPU: the twins of the JAX package's ``tests/test_gateway.py``, of its
``/predict`` pins (``tests/test_multitenant.py``) and of its trace-id and
``/metrics`` pins (``tests/test_obs_plane.py``).

- **the wire contract** over real loopback HTTP: submit, status, report
  (statistics byte-equal to the direct run), list, stats, health; 400 for an
  invalid query (never journaled) and an empty body; percent-encoded values
  decoded at the door; 429 shed with evidence (the key not bound); an
  idempotent rejoin, replay and conflict (409); cancel-if-queued;
- **one scripted request sequence** gives the same status codes and payload
  keys from the port's gateway and the JAX package's;
- **crash-only**: recovery over completed, failed and unfinished records
  re-runs only the unfinished one; a SIGKILLed gateway child's keyed
  re-submits return the original ids, the completed record stays
  byte-untouched, the resumed plan's statistics are its twin's; a keyed
  re-submit racing ``recover()`` runs once; finished tickets are evicted;
- **/predict** over a ``MultiplexedService`` (the tenant stack, K6's plain
  version here): the service's own answer, idempotent replay and conflict,
  400s, the tenant's shed evidence, 503 without a service, the per-tenant
  ``serve`` block in ``/stats``;
- **trace ids and /metrics**: an inbound ``X-Trace-Id`` is echoed and
  journaled, a hostile one re-minted; ``/metrics`` is the Prometheus text
  both packages' ``parse`` read, naming the replica;
- a gateway built with ``device=None`` raises without a card.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.gateway import GatewayServer as JaxGatewayServer
from eeg_dataanalysispackage_tpu.obs import metrics_export as jax_export
from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
from eeg_dataanalysispackage_tpu_torch.gateway import GatewayServer as _GatewayServer
from eeg_dataanalysispackage_tpu_torch.gateway.server import mint_trace_id
from eeg_dataanalysispackage_tpu_torch.io.provider import OfflineDataProvider
from eeg_dataanalysispackage_tpu_torch.models import registry
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain as run_domain, metrics_export
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.scheduler import PlanCancelledError
from eeg_dataanalysispackage_tpu_torch.scheduler import PlanExecutor as _PlanExecutor
from eeg_dataanalysispackage_tpu_torch.scheduler import dedup as dedup_mod
from eeg_dataanalysispackage_tpu_torch.scheduler import runtime as runtime_mod
from eeg_dataanalysispackage_tpu_torch.scheduler.journal import PlanJournal
from eeg_dataanalysispackage_tpu_torch.serve import MultiplexedService, ServeConfig, engine

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def GatewayServer(**kwargs):
    return _GatewayServer(device="cpu", **kwargs)


@pytest.fixture(autouse=True)
def _clean_ambient():
    assert chaos.active_plan() is None
    assert run_domain.current() is None
    dedup_mod.reset()
    yield
    dedup_mod.reset()
    chaos.uninstall()
    assert run_domain.current() is None


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("gateway")), n_markers=60)


def _q(info, extra="", clf="logreg", fe="dwt-8"):
    return (f"info_file={info}&fe={fe}&train_clf={clf}&config_step_size=1.0"
            "&config_num_iterations=20&config_mini_batch_fraction=1.0" + extra)


def _request(url, body=None, method="GET", headers=None, timeout=60):
    req = urllib.request.Request(url, data=body.encode() if body is not None else None,
                                 method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get_text(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read().decode()


def _await(base, plan_id, deadline_s=300):
    start = time.monotonic()
    while True:
        _, status = _request(f"{base}/plans/{plan_id}")
        if status.get("state") in ("completed", "failed", "cancelled"):
            return status
        assert time.monotonic() - start < deadline_s, status
        time.sleep(0.05)


def _sha(text):
    return hashlib.sha256(str(text).encode()).hexdigest()


@pytest.fixture(scope="module")
def direct(session):
    return str(PipelineBuilder(_q(session), device="cpu").execute())


# -- the wire contract


def test_http_lifecycle_end_to_end(session, tmp_path, direct):
    with GatewayServer(journal_dir=str(tmp_path / "journal"),
                       report_root=str(tmp_path / "reports")) as gw:
        code, health = _request(f"{gw.url}/healthz")
        assert code == 200 and health["ok"] and health["journal"]
        code, payload = _request(f"{gw.url}/plans", body=_q(session), method="POST")
        assert code == 201 and payload["idempotent_replay"] is False
        plan_id = payload["plan_id"]
        final = _await(gw.url, plan_id)
        assert (final["state"], final["attempts"], final["query"]) == ("completed", 1,
                                                                       _q(session))
        code, report = _request(f"{gw.url}/plans/{plan_id}/report")
        assert code == 200
        assert report["statistics"] == direct
        assert report["statistics_sha256"] == _sha(direct)
        assert report["run_report"]["plan_id"] == plan_id
        assert report["run_report"]["gateway"] == {"via": "http", "replica": gw.replica_id,
                                                   "client": "127.0.0.1"}
        code, listing = _request(f"{gw.url}/plans")
        assert code == 200 and [p["plan_id"] for p in listing["plans"]] == [plan_id]
        code, stats = _request(f"{gw.url}/stats")
        assert code == 200 and {"dedup", "scheduler", "queue_depth"} <= set(stats)
        assert "serve" not in stats and "fleet" not in stats
        assert _request(f"{gw.url}/plans/nope")[0] == 404
        assert _request(f"{gw.url}/nothing")[0] == 404
        assert _request(f"{gw.url}/plans/{plan_id}/x", method="DELETE")[0] == 404


def test_invalid_query_is_400_and_never_journaled(tmp_path):
    with GatewayServer(journal_dir=str(tmp_path / "journal")) as gw:
        code, payload = _request(f"{gw.url}/plans", body="fe=dwt-8&train_clf=logreg",
                                 method="POST")
        assert code == 400 and "error" in payload
        assert _request(f"{gw.url}/plans")[1]["plans"] == []
        assert _request(f"{gw.url}/plans", body="", method="POST")[0] == 400
        code, payload = _request(f"{gw.url}/plans", body="a=b%26c", method="POST")
        assert code == 400 and "reserved" in payload["error"]
        code, payload = _request(f"{gw.url}/plans", body="x", method="POST",
                                 headers={"X-Plan-Deadline-S": "soon"})
        assert code == 400 and "X-Plan-Deadline-S" in payload["error"]


def test_percent_encoded_query_roundtrips_over_http(tmp_path):
    os.makedirs(str(tmp_path / "seiz"))
    info = _synthetic.write_seizure_session(str(tmp_path / "seiz"))
    decoded, encoded = "dwt-4:level=3:stats=energy,std", "dwt-4%3Alevel%3D3%3Astats%3Denergy%2Cstd"
    suffix = ("&window=512&stride=256&train_clf=logreg&config_num_iterations=20"
              "&config_step_size=1.0&config_mini_batch_fraction=1.0")
    direct = PipelineBuilder(f"info_file={info}&task=seizure&fe={decoded}" + suffix,
                             device="cpu").execute()
    with GatewayServer(journal_dir=str(tmp_path / "journal")) as gw:
        code, payload = _request(f"{gw.url}/plans", method="POST",
                                 body=f"info_file={info}&task=seizure&fe={encoded}" + suffix)
        assert code == 201
        final = _await(gw.url, payload["plan_id"])
        assert final["state"] == "completed" and f"fe={decoded}" in final["query"]
        assert _request(f"{gw.url}/plans/{payload['plan_id']}/report")[1]["statistics"] \
            == str(direct)


@pytest.fixture()
def blocked_runtime(monkeypatch):
    """Plan execution replaced by an event-gated stub, so queue and state
    interleavings are deterministic."""
    release, started = threading.Event(), threading.Event()

    def blocked_execute(plan, builder_, plan_id=None, **kw):
        started.set()
        assert release.wait(60), "the test never released the worker"
        return f"done-{plan_id}"

    monkeypatch.setattr(runtime_mod, "execute_plan", blocked_execute)
    yield started, release
    release.set()


def test_shed_is_429_with_evidence(session, tmp_path, blocked_runtime):
    started, release = blocked_runtime
    with GatewayServer(journal_dir=str(tmp_path / "journal"), max_concurrent=1,
                       queue_depth=1) as gw:
        _request(f"{gw.url}/plans", body=_q(session), method="POST")
        assert started.wait(30)
        _, queued = _request(f"{gw.url}/plans", body=_q(session), method="POST")
        code, payload = _request(f"{gw.url}/plans", body=_q(session), method="POST",
                                 headers={"X-Idempotency-Key": "shed-key"})
        assert code == 429 and payload["shed"] and "depth" in payload["error"]
        shed_id = payload["plan_id"]
        assert _request(f"{gw.url}/plans/{shed_id}")[1]["state"] == "failed"
        release.set()
        _await(gw.url, queued["plan_id"])
        # the shed did not bind the key: a retry runs fresh
        code, retry = _request(f"{gw.url}/plans", body=_q(session), method="POST",
                               headers={"X-Idempotency-Key": "shed-key"})
        assert code == 201 and retry["plan_id"] != shed_id
        _await(gw.url, retry["plan_id"])


def test_idempotent_rejoin_replay_and_conflict(session, tmp_path, blocked_runtime):
    started, release = blocked_runtime
    key = {"X-Idempotency-Key": "k-live"}
    with GatewayServer(journal_dir=str(tmp_path / "journal"), max_concurrent=1) as gw:
        code1, p1 = _request(f"{gw.url}/plans", body=_q(session), method="POST", headers=key)
        assert code1 == 201
        assert started.wait(30)
        code2, p2 = _request(f"{gw.url}/plans", body=_q(session), method="POST", headers=key)
        assert (code2, p2["plan_id"], p2["idempotent_replay"]) == (200, p1["plan_id"], True)
        assert p2["trace_id"] == p1["trace_id"]  # the original submission's trace
        code, err = _request(f"{gw.url}/plans", body=_q(session, clf="svm"), method="POST",
                             headers=key)
        assert code == 409 and err["idempotency_conflict"]
        release.set()
        assert _await(gw.url, p1["plan_id"])["state"] == "completed"
        code3, p3 = _request(f"{gw.url}/plans", body=_q(session), method="POST", headers=key)
        assert (code3, p3["plan_id"]) == (200, p1["plan_id"])
        code, err = _request(f"{gw.url}/plans", body=_q(session, clf="svm"), method="POST",
                             headers=key)
        assert code == 409 and err["idempotency_conflict"]
        journal = PlanJournal(str(tmp_path / "journal"))
        assert journal.entry(p1["plan_id"])["state"] == "completed"
        assert len(journal.entries()) == 1


def test_cancel_if_queued(session, tmp_path, blocked_runtime):
    started, release = blocked_runtime
    with GatewayServer(journal_dir=str(tmp_path / "journal"), max_concurrent=1,
                       queue_depth=4) as gw:
        _, running = _request(f"{gw.url}/plans", body=_q(session), method="POST")
        assert started.wait(30)
        _, queued = _request(f"{gw.url}/plans", body=_q(session), method="POST",
                             headers={"X-Idempotency-Key": "k-cancel"})
        handle = gw.executor.handle(queued["plan_id"])
        code, payload = _request(f"{gw.url}/plans/{queued['plan_id']}", method="DELETE")
        assert code == 200 and payload["cancelled"]
        assert _request(f"{gw.url}/plans/{queued['plan_id']}")[1]["state"] == "cancelled"
        code, payload = _request(f"{gw.url}/plans/{running['plan_id']}", method="DELETE")
        assert code == 409 and not payload["cancelled"]
        assert _request(f"{gw.url}/plans/p9999", method="DELETE")[0] == 404
        code, fresh = _request(f"{gw.url}/plans", body=_q(session), method="POST",
                               headers={"X-Idempotency-Key": "k-cancel"})
        assert code == 201 and fresh["plan_id"] != queued["plan_id"]
        code, early = _request(f"{gw.url}/plans/{fresh['plan_id']}/report")
        assert code == 409 and early["state"] == "queued"
        release.set()
        assert _await(gw.url, running["plan_id"])["state"] == "completed"
        assert _await(gw.url, fresh["plan_id"])["state"] == "completed"
        with pytest.raises(PlanCancelledError):
            handle.result(timeout=1)


def test_a_journal_less_gateway_keeps_its_handles(session, direct):
    with GatewayServer(journal_dir=None) as gw:
        code, payload = _request(f"{gw.url}/plans", body=_q(session), method="POST")
        assert code == 201
        _await(gw.url, payload["plan_id"])
        code, report = _request(f"{gw.url}/plans/{payload['plan_id']}/report")
        assert code == 200 and report["statistics"] == direct
        assert [p["plan_id"] for p in _request(f"{gw.url}/plans")[1]["plans"]] \
            == [payload["plan_id"]]


# -- one scripted sequence, both packages


def _script(gw, session, journal_dir):
    """The same requests to a gateway; their status codes and payload keys."""
    out = []

    def note(label, code, payload):
        out.append((label, code, sorted(payload) if isinstance(payload, dict) else None))

    q = _q(session, "&dedup=false")
    code, first = _request(f"{gw.url}/plans", body=q, method="POST",
                           headers={"X-Idempotency-Key": "script", "X-Trace-Id": "t-script"})
    note("submit", code, first)
    note("invalid", *_request(f"{gw.url}/plans", body="fe=dwt-8&train_clf=logreg",
                              method="POST"))
    _await(gw.url, first["plan_id"])
    note("replay", *_request(f"{gw.url}/plans", body=q, method="POST",
                             headers={"X-Idempotency-Key": "script"}))
    note("conflict", *_request(f"{gw.url}/plans", body=q + "&x=1", method="POST",
                               headers={"X-Idempotency-Key": "script"}))
    code, status = _request(f"{gw.url}/plans/{first['plan_id']}")
    note("status", code, status)
    code, report = _request(f"{gw.url}/plans/{first['plan_id']}/report")
    note("report", code, report)
    out.append(("report.statistics", report["statistics"]))
    out.append(("report.run_report", report["run_report"]))
    for label, path in (("list", "/plans"), ("unknown", "/plans/p0999"),
                        ("nothing", "/nothing"), ("healthz", "/healthz"),
                        ("readyz", "/readyz")):
        note(label, *_request(gw.url + path))
    code, stats = _request(f"{gw.url}/stats")
    note("stats", code, stats)
    note("stats.dedup", code, stats["dedup"])
    note("cancel-done", *_request(f"{gw.url}/plans/{first['plan_id']}", method="DELETE"))
    note("predict-no-service", *_request(f"{gw.url}/predict", body="{}", method="POST"))
    code, ctype, text = _get_text(f"{gw.url}/metrics")
    out.append(("metrics", code, ctype, "eeg_tpu_build_info" in jax_export.parse(text)))
    out.append(("journal", sorted((e["plan_id"], e["state"], e["meta"]["trace_id"])
                                  for e in PlanJournal(journal_dir).entries())))
    return out


def test_one_request_sequence_matches_the_jax_gateway(session, tmp_path):
    runs = {}
    for name, make in (("port", GatewayServer), ("jax", JaxGatewayServer)):
        journal_dir = str(tmp_path / name)
        with make(journal_dir=journal_dir) as gw:
            runs[name] = _script(gw, session, journal_dir)
    assert runs["port"] == runs["jax"]


# -- recovery


def test_restart_with_mixed_journal_states(session, tmp_path):
    journal_dir = str(tmp_path / "journal")
    q_ok, q_fail = _q(session), _q(session, "&faults=scheduler.plan:every@1")
    q_unfinished = _q(session, clf="svm")
    with GatewayServer(journal_dir=journal_dir, max_concurrent=1, max_attempts=1) as gw:
        _, ok = _request(f"{gw.url}/plans", body=q_ok, method="POST",
                         headers={"X-Idempotency-Key": "k-ok"})
        assert _await(gw.url, ok["plan_id"])["state"] == "completed"
        _, failed = _request(f"{gw.url}/plans", body=q_fail, method="POST",
                             headers={"X-Idempotency-Key": "k-fail"})
        assert _await(gw.url, failed["plan_id"])["state"] == "failed"
    PlanJournal(journal_dir).record_submitted("p0099", q_unfinished,
                                              meta={"idempotency_key": "k-unfinished"})
    records = {p: open(os.path.join(journal_dir, f"plan-{p}.json")).read()
               for p in (ok["plan_id"], failed["plan_id"])}
    twin = PipelineBuilder(q_unfinished, device="cpu").execute()
    with GatewayServer(journal_dir=journal_dir, max_concurrent=1) as gw:
        assert [h.plan_id for h in gw.recovery["resumed"]] == ["p0099"]
        assert [e["plan_id"] for e in gw.recovery["completed"]] == [ok["plan_id"]]
        for q, key, plan_id, state in ((q_ok, "k-ok", ok["plan_id"], "completed"),
                                       (q_fail, "k-fail", failed["plan_id"], "failed")):
            code, r = _request(f"{gw.url}/plans", body=q, method="POST",
                               headers={"X-Idempotency-Key": key})
            assert (code, r["plan_id"], r["state"]) == (200, plan_id, state)
        assert "chaos" in (_request(f"{gw.url}/plans/{failed['plan_id']}/report")[1]["error"]
                           or "")
        code, r = _request(f"{gw.url}/plans", body=q_unfinished, method="POST",
                           headers={"X-Idempotency-Key": "k-unfinished"})
        assert (code, r["plan_id"]) == (200, "p0099")
        assert _await(gw.url, "p0099")["state"] == "completed"
        assert _request(f"{gw.url}/plans/p0099/report")[1]["statistics"] == str(twin)
    for plan_id, text in records.items():
        assert open(os.path.join(journal_dir, f"plan-{plan_id}.json")).read() == text


_KILL_CHILD = """
import json, os, signal, sys, time, urllib.request

sys.path.insert(0, {repo!r})
from eeg_dataanalysispackage_tpu_torch.gateway import GatewayServer

journal_dir, qa, qb = sys.argv[1:4]
gw = GatewayServer(journal_dir=journal_dir, max_concurrent=1, device="cpu")
gw.start()


def post(body, key):
    req = urllib.request.Request(gw.url + "/plans", data=body.encode(), method="POST",
                                 headers={{"X-Idempotency-Key": key}})
    return json.loads(urllib.request.urlopen(req).read())


pa = post(qa, "key-a")["plan_id"]
while True:
    with urllib.request.urlopen(gw.url + "/plans/" + pa) as r:
        if json.loads(r.read())["state"] == "completed":
            break
    time.sleep(0.05)
post(qb, "key-b")
os.kill(os.getpid(), signal.SIGKILL)
"""


def test_sigkilled_gateway_honors_idempotency_keys(session, tmp_path):
    """A gateway child is SIGKILLed right after journaling its second plan; a
    restarted gateway over the same journal returns the original ids to
    keyed re-submits, runs the unfinished plan to its twin's statistics and
    leaves the completed record byte-untouched."""
    journal_dir = str(tmp_path / "journal")
    qa = _q(session)
    qb = _q(session, clf="svm").replace("config_num_iterations=20",
                                        "config_num_iterations=500")
    child = tmp_path / "kill_child.py"
    child.write_text(_KILL_CHILD.format(repo=REPO))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, str(child), journal_dir, qa, qb], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    journal = PlanJournal(journal_dir)
    assert {e["plan_id"]: e["state"] for e in journal.entries()} == {
        "p0001": "completed", "p0002": "submitted"}
    completed_before = open(os.path.join(journal_dir, "plan-p0001.json")).read()
    twins = {q: str(PipelineBuilder(q, device="cpu").execute()) for q in (qa, qb)}
    with GatewayServer(journal_dir=journal_dir, max_concurrent=1) as gw:
        assert [h.plan_id for h in gw.recovery["resumed"]] == ["p0002"]
        for q, key, plan_id in ((qa, "key-a", "p0001"), (qb, "key-b", "p0002")):
            code, r = _request(f"{gw.url}/plans", body=q, method="POST",
                               headers={"X-Idempotency-Key": key})
            assert (code, r["plan_id"], r["idempotent_replay"]) == (200, plan_id, True)
        assert _await(gw.url, "p0002")["state"] == "completed"
        reports = {p: _request(f"{gw.url}/plans/{p}/report")[1]["statistics"]
                   for p in ("p0001", "p0002")}
    assert reports == {"p0001": twins[qa], "p0002": twins[qb]}
    assert open(os.path.join(journal_dir, "plan-p0001.json")).read() == completed_before


def test_keyed_resubmit_racing_recover_runs_once(session, tmp_path, monkeypatch):
    jdir = str(tmp_path / "journal")
    PlanJournal(jdir).record_submitted("p0001", _q(session), meta={"idempotency_key": "k-race"})
    runs, release = [], threading.Event()

    def counting_execute(plan, builder_, plan_id=None, **kw):
        runs.append(plan_id)
        assert release.wait(60)
        return f"done-{plan_id}"

    monkeypatch.setattr(runtime_mod, "execute_plan", counting_execute)
    with _PlanExecutor(max_concurrent=1, journal_dir=jdir, device="cpu") as ex:
        h1 = ex.submit(_q(session), idempotency_key="k-race")
        assert h1.plan_id == "p0001"
        recovery = ex.recover()
        assert [h.plan_id for h in recovery["resumed"]] == ["p0001"]
        assert recovery["resumed"][0].replayed
        release.set()
        assert h1.result(60).plan_id == "p0001"
        recovery["resumed"][0].result(60)
    assert runs == ["p0001"]


def test_completed_tickets_evicted_once_journaled(session, tmp_path):
    with _PlanExecutor(max_concurrent=1, journal_dir=str(tmp_path / "journal"),
                       device="cpu") as ex:
        h = ex.submit(_q(session), idempotency_key="k-evict")
        stats = str(h.result(300).statistics)
        deadline = time.monotonic() + 10
        while h.plan_id in ex.live_ids():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        assert ex.handle(h.plan_id) is None
        assert ex.status(h.plan_id)["state"] == "completed"
        h2 = ex.submit(_q(session), idempotency_key="k-evict")
        assert h2.replayed and h2.plan_id == h.plan_id
        assert str(h2.result(10).statistics) == stats


# -- /predict


@pytest.fixture(scope="module")
def serving(session, tmp_path_factory):
    """Two tenants (a logreg model the port trained on the session, and the
    same model perturbed) and the kept windows of the session."""
    model = str(tmp_path_factory.mktemp("gateway_model") / "model")
    PipelineBuilder(_q(session, f"&save_clf=true&save_name={model}", fe="dwt-8-fused"),
                    device="cpu").execute()
    tenants = {}
    for name, seed in (("alice", 0), ("bob", 1)):
        clf = registry.create("logreg")
        clf.load(model)
        if seed:
            state = clf.to_numpy_state()
            noise = np.random.default_rng(seed).standard_normal(state["weights"].shape)
            state["weights"] = (state["weights"] + noise * 0.05).astype(state["weights"].dtype)
            clf.from_numpy_state(state)
        tenants[name] = clf
    odp = OfflineDataProvider([session], device="cpu")
    balance, windows, resolutions = BalanceState(), [], None
    for _rel, guessed, rec in odp.iter_recordings():
        ws, _ts, resolutions = engine.windows_from_recording(
            rec, odp.channel_indices_for(rec), guessed, pre=odp.pre, post=odp.post,
            balance=balance)
        windows.extend(ws)
    return {"tenants": tenants, "windows": windows, "resolutions": resolutions}


def _predict_body(serving, tenant="alice", i=0):
    return json.dumps({"tenant": tenant,
                       "window": np.asarray(serving["windows"][i]).tolist(),
                       "resolutions": np.asarray(serving["resolutions"]).tolist()})


@pytest.fixture()
def predict_gateway(serving):
    svc = MultiplexedService(dict(serving["tenants"]),
                             config=ServeConfig(max_batch=16, tenant_quota=2), device="cpu")
    svc.engine.warmup()
    svc.start()
    try:
        yield GatewayServer(journal_dir=None, predict_service=svc), svc
    finally:
        svc.stop()


def test_gateway_predict_is_the_services_answer(serving, predict_gateway):
    gateway, svc = predict_gateway
    windows, res = serving["windows"], serving["resolutions"]
    for i, tenant in enumerate(("alice", "bob", "alice", "bob")):
        code, payload = gateway.predict_payload(_predict_body(serving, tenant, i),
                                                trace_id="t-predict")
        assert code == 200 and payload["tenant"] == tenant
        direct_p, direct_m = svc.engine.execute([windows[i]], res, [tenant])
        assert payload["prediction"] == float(direct_p[0])
        assert payload["margin"] == float(direct_m[0])
        assert payload["batch_size"] >= 1 and payload["trace_id"] == "t-predict"
    code, stats = gateway.stats_payload()
    alice = stats["serve"]["tenants"]["alice"]
    assert set(stats["serve"]["tenants"]) == {"alice", "bob"}
    assert alice["requests"]["completed"] >= 2
    assert {"lane", "generation", "requests", "latency_ms", "lifecycle"} <= set(alice)
    code, text = gateway.metrics_payload()
    series = metrics_export.parse(text)
    assert {labels.get("tenant") for labels, _ in
            series["eeg_tpu_serve_request_latency_ms_count"]} == {None, "alice", "bob"}


def test_gateway_predict_idempotent_replay_and_conflict(serving, predict_gateway):
    gateway, _svc = predict_gateway
    body = _predict_body(serving)
    code1, first = gateway.predict_payload(body, idempotency_key="k1")
    assert code1 == 200 and first["idempotent_replay"] is False
    code2, replay = gateway.predict_payload(body, idempotency_key="k1")
    assert code2 == 200 and replay["idempotent_replay"] is True
    assert (replay["prediction"], replay["margin"], replay["trace_id"]) == (
        first["prediction"], first["margin"], first["trace_id"])
    code3, conflict = gateway.predict_payload(_predict_body(serving, "bob"),
                                              idempotency_key="k1")
    assert code3 == 409 and conflict["idempotency_conflict"] is True


def test_gateway_predict_rejects_bad_requests(serving, predict_gateway):
    gateway, _svc = predict_gateway
    code, payload = gateway.predict_payload("not json")
    assert code == 400 and "not JSON" in payload["error"]
    assert gateway.predict_payload("[1]")[0] == 400
    code, payload = gateway.predict_payload(_predict_body(serving, tenant="ghost"))
    assert code == 400 and "unknown tenant" in payload["error"]
    code, payload = gateway.predict_payload('{"tenant": "alice"}')
    assert code == 400 and "window" in payload["error"]
    assert gateway.predict_payload('{"tenant": "alice", "deadline_s": "x"}')[0] == 400
    assert GatewayServer(journal_dir=None).predict_payload(_predict_body(serving))[0] == 503


def test_gateway_predict_shed_carries_tenant_evidence(serving):
    svc = MultiplexedService({"alice": serving["tenants"]["alice"]},
                             config=ServeConfig(max_batch=16, queue_depth=64, tenant_quota=1),
                             device="cpu")
    svc._accepting = True  # the queue admits, nothing drains
    gateway = GatewayServer(journal_dir=None, predict_service=svc)
    svc.submit(serving["windows"][0], serving["resolutions"], tenant="alice")
    code, payload = gateway.predict_payload(_predict_body(serving))
    assert code == 429 and payload["shed"] is True and payload["tenant"] == "alice"
    evidence = payload["evidence"]
    assert evidence["reason"] == "tenant_quota"
    assert evidence["tenant_depth"] == 1 and evidence["tenant_quota"] == 1
    assert "oldest_age_s" in evidence


def test_predict_over_http(serving, predict_gateway):
    gateway, _svc = predict_gateway
    gateway.start()
    try:
        code, payload = _request(f"{gateway.url}/predict", body=_predict_body(serving),
                                 method="POST", headers={"X-Idempotency-Key": "h1",
                                                         "X-Trace-Id": "t-http"})
        assert code == 200 and payload["trace_id"] == "t-http"
        code, again = _request(f"{gateway.url}/predict", body=_predict_body(serving),
                               method="POST", headers={"X-Idempotency-Key": "h1"})
        assert code == 200 and again["idempotent_replay"] and again["trace_id"] == "t-http"
    finally:
        gateway.close()


# -- trace ids and /metrics


def test_mint_trace_id_honors_wellformed_inbound():
    assert mint_trace_id("req-2026.08_07-a") == "req-2026.08_07-a"


@pytest.mark.parametrize("bad", [None, "", "has space", "semi;colon", "x" * 129, 'quo"te'])
def test_mint_trace_id_remints_hostile_inbound(bad):
    minted = mint_trace_id(bad)
    assert minted != bad and len(minted) == 32
    int(minted, 16)
    assert mint_trace_id(None) != mint_trace_id(None)


def test_gateway_journals_echoes_and_exposes(session, tmp_path):
    """An inbound X-Trace-Id rides the response, the submit record and the
    terminal record; /metrics is Prometheus text that both packages' parse
    read, naming the replica, with the completed plan counted."""
    journal_dir = str(tmp_path / "journal")
    with GatewayServer(journal_dir=journal_dir, replica_id="gw-metrics") as gw:
        code, payload = _request(f"{gw.url}/plans", body=_q(session), method="POST",
                                 headers={"X-Trace-Id": "trace-pin-1"})
        assert code == 201 and payload["trace_id"] == "trace-pin-1"
        gw.executor.handle(payload["plan_id"]).result(120)
        code, ctype, text = _get_text(f"{gw.url}/metrics")
    assert code == 200 and ctype == metrics_export.CONTENT_TYPE
    entry = PlanJournal(journal_dir).entry(payload["plan_id"])
    assert entry["state"] == "completed" and entry["meta"]["trace_id"] == "trace-pin-1"
    for parse in (metrics_export.parse, jax_export.parse):
        series = parse(text)
        assert series["eeg_tpu_build_info"][0][0]["replica"] == "gw-metrics"
        assert series["eeg_tpu_scheduler_completed_total"][0][1] >= 1
        assert "eeg_tpu_gateway_queue_depth" in series


def test_no_card_no_gateway():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _GatewayServer()
