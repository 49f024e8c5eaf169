"""The port's operator tools (``eeg_dataanalysispackage_tpu_torch/tools``)
against the JAX package's ``tools/`` scripts on the same inputs.

One journal directory holds a plan the port's gateway ran (completed,
keyed, traced, its run report beside it), a failed record, a submitted
record under a dead holder's stale lease, an unleased one, a record the
JAX package's journal wrote, and a device pool (a held ordinal, a waiting
gang): the two packages' journal, lease and pool files interchange, so
both tools read it.

- ``plan_admin list/show/tail/fleet/stats`` print the JAX tool's text and
  exit codes (heartbeat ages masked), over the journal and over the live
  gateway;
- ``obs_report show/diff`` render the port's run and crash reports as the
  JAX tool does;
- ``fleet_top``: the snapshot over the live gateway and a dead URL (DOWN)
  equals the JAX tool's (ages masked), the table and the strict JSON are
  the JAX tool's on one snapshot, exit 1 with a replica down;
- ``chaos_run`` gives the JAX tool's exit codes and text: 0 on a spec the
  run absorbs (``device.step`` under ``elastic=true``), 2 when the chaos
  run dies, 1 when the statistics diverge;
- a fresh interpreter running ``plan_admin list/fleet/trace`` and
  ``fleet_top --snapshot`` holds neither JAX nor the JAX package.
"""

import contextlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys

import pytest

from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.scheduler.journal import PlanJournal as JaxJournal
from eeg_dataanalysispackage_tpu_torch.gateway import GatewayServer
from eeg_dataanalysispackage_tpu_torch.obs import events
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch.scheduler import lease as lease_mod
from eeg_dataanalysispackage_tpu_torch.scheduler import placement
from eeg_dataanalysispackage_tpu_torch.scheduler.journal import PlanJournal
from eeg_dataanalysispackage_tpu_torch.tools import chaos_run, fleet_top, obs_report, plan_admin

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINEAR = "config_num_iterations=30&config_step_size=1.0&config_mini_batch_fraction=1.0"
DEAD = "http://127.0.0.1:9"


def jax_tool(name):
    """A JAX package tool module (``tools/<name>.py``)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _both(name, argv, mask=False):
    """(JAX tool's (rc, stdout), the port's), ages masked when ``mask``."""
    port = {"plan_admin": plan_admin, "obs_report": obs_report}[name]
    out = [_stdout(jax_tool(name).main, argv), _stdout(port.main, argv)]
    if mask:
        out = [(rc, re.sub(r" *\d+\.\d+s\b", " Ns", text)) for rc, text in out]
    return out


@pytest.fixture(scope="module")
def ops(tmp_path_factory):
    d = tmp_path_factory.mktemp("operator_tools")
    info = _synthetic.write_session(str(d), n_markers=40)
    query = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}&dedup=false"
    journal_dir, trace_dir = str(d / "journal"), str(d / "traces")
    gw = GatewayServer(journal_dir=journal_dir, report_root=str(d / "reports"),
                       replica_id="gw-t", device="cpu")
    gw.start()
    old = os.environ.get(events.ENV_TRACE_DIR)
    os.environ[events.ENV_TRACE_DIR] = trace_dir
    try:
        code, payload = gw.submit_query(query, idempotency_key="k-admin", trace_id="t-admin")
        assert code == 201, payload
        gw.executor.handle(payload["plan_id"]).result(120)
    finally:
        if old is None:
            os.environ.pop(events.ENV_TRACE_DIR)
        else:
            os.environ[events.ENV_TRACE_DIR] = old
    journal = PlanJournal(journal_dir)
    journal.record_failed("p0900", query + "&faults=ingest.fused:p=1.0",
                          "RuntimeError: injected", attempts=3)
    journal.record_submitted("p0901", query, meta={"idempotency_key": "k-stale"})
    path = os.path.join(journal_dir, "plan-p0901.lease")
    with open(path, "w") as f:
        f.write("gw-dead\n999999\n\n")
    os.utime(path, (1e9, 1e9))
    journal.record_submitted("p0902", query + "&tenant=t7", meta={})
    JaxJournal(journal_dir).record_submitted("p0903", query, meta={"idempotency_key": "k-jax"})
    pool = placement.DevicePool(lease_mod.LeaseDir(journal_dir, holder="gw-pool"), 2)
    footprint = ExecutionPlan.parse(query).device_footprint()
    assert pool.admit("p0904", footprint) is not None
    assert pool.admit("p0905", {**footprint, "devices": 2}) is None  # waits
    # the run and crash reports obs_report renders
    reports = {}
    for name, extra in (("run", f"&report={d / 'rep_a'}"),
                        ("run_b", f"&report={d / 'rep_b'}&config_step_size=0.5"),
                        ("crash", f"&report={d / 'rep_c'}&faults=ingest.fused:once@1")):
        with contextlib.suppress(Exception):
            PipelineBuilder(query + extra, device="cpu").execute()
        directory = extra.split("&")[1].split("=", 1)[1]
        reports[name] = os.path.join(
            directory, "crash_report.json" if name == "crash" else "run_report.json")
    yield {"dir": d, "info": info, "query": query, "journal": journal_dir,
           "traces": trace_dir, "url": gw.url, "plan_id": payload["plan_id"],
           "reports": reports}
    gw.close()


# -- plan_admin


@pytest.mark.parametrize("argv", [
    ["list"], ["list", "--tenant", "t7"], ["list", "--tenant", "nobody"],
    ["tail", "--count", "4", "--interval", "0.01"],
])
def test_plan_admin_over_the_journal_equals_the_jax_tool(ops, argv):
    argv = argv[:1] + ["--journal", ops["journal"]] + argv[1:]
    want, got = _both("plan_admin", argv)
    assert got == want and got[0] == 0
    if argv[0] == "list" and len(argv) == 3:
        assert ops["plan_id"] in got[1] and "k-admin" in got[1] and "k-jax" in got[1]
        assert "completed=1" in got[1] and "failed=1" in got[1]


@pytest.mark.parametrize("plan", ["served", "p0900", "p0903", "p9999"])
def test_plan_admin_show_equals_the_jax_tool(ops, plan):
    plan = ops["plan_id"] if plan == "served" else plan
    want, got = _both("plan_admin", ["show", plan, "--journal", ops["journal"]])
    assert got == want
    if plan == ops["plan_id"]:
        assert got[0] == 0 and "state    completed" in got[1]
        assert "idempotency_key k-admin" in got[1] and "--- run report (" in got[1]
        assert "trace    id=t-admin segment=gw-t" in got[1]
    elif plan == "p9999":
        assert got[0] == 1


def test_plan_admin_fleet_equals_the_jax_tool(ops):
    want, got = _both("plan_admin", ["fleet", "--journal", ops["journal"]], mask=True)
    assert got == want and got[0] == 0
    out = got[1]
    assert "p0901" in out and "STALE" in out and "gw-dead" in out and "999999 (dead)" in out
    assert "unleased" in out and "p0902" in out
    assert "device pool: 2 ordinals, 1 held, 1 claimable" in out
    assert "WAITING p0905" in out and "blocked on devices=2" in out


@pytest.mark.parametrize("argv", [["list", "--gateway", "URL"],
                                  ["show", "served", "--gateway", "URL"],
                                  ["stats", "--gateway", "URL", "--tenant", "t0"]])
def test_plan_admin_over_the_gateway_equals_the_jax_tool(ops, argv):
    argv = [{"served": ops["plan_id"], "URL": ops["url"]}.get(a, a) for a in argv]
    # a report fetched over the gateway renders from a temporary file
    want, got = [(rc, re.sub(r"RUN report  \S+", "RUN report  <tmp>", out))
                 for rc, out in _both("plan_admin", argv)]
    assert got == want
    if argv[0] == "stats":
        assert got[0] == 1 and "no serve block" in got[1]
    else:
        assert got[0] == 0 and ops["plan_id"] in got[1]


# -- obs_report


@pytest.mark.parametrize("argv", [["show", "run"], ["show", "crash"], ["diff", "run", "run_b"]])
def test_obs_report_equals_the_jax_tool(ops, argv):
    argv = [argv[0]] + [ops["reports"][a] for a in argv[1:]]
    want, got = _both("obs_report", argv)
    assert got == want and got[0] == 0
    if argv[0] == "show" and "crash" in argv[1]:
        assert got[1].startswith("CRASH report") and "ingest.fused: calls=1 fired=1" in got[1]


# -- fleet_top


def _unaged(snap):
    snap = json.loads(json.dumps(snap))
    for key in ("leases",):
        for row in snap.get(key, []):
            row["age_s"] = None
    pool = snap.get("device_pool") or {}
    for row in pool.get("devices", []) + pool.get("waiting", []):
        row["age_s"] = None
    return snap


def test_fleet_top_snapshot_equals_the_jax_tool(ops):
    jax_top = jax_tool("fleet_top")
    urls = [ops["url"], DEAD]
    want = jax_top.snapshot(urls, journal_dir=ops["journal"], timeout_s=5.0)
    got = fleet_top.snapshot(urls, journal_dir=ops["journal"], timeout_s=5.0)
    assert _unaged(got) == _unaged(want)
    up, down = got["replicas"]
    # the counters are the serving process's, whichever plans it ran
    assert up["replica"] == "gw-t" and up["plans_completed"] >= 1
    assert "error" in down and got["fleet"]["replicas_up"] == 1
    assert [row["plan_id"] for row in got["leases"]] == ["p0901"]
    assert got["device_pool"]["free"] == 1
    # the table, on one snapshot
    assert _stdout(fleet_top.render, got) == _stdout(jax_top.render, got)
    rc, table = _stdout(fleet_top.main, urls + ["--journal", ops["journal"]])
    assert rc == 1 and "gw-t" in table and "DOWN" in table and "fleet: 1/2 up" in table


def test_fleet_top_strict_json_equals_the_jax_packages():
    from eeg_dataanalysispackage_tpu.utils import strict_json

    snap = {"fleet": {"latency_p99_ms": math.nan, "x": [math.inf, 1.5, (2, -math.inf)]}}
    assert fleet_top._strict_dumps(snap, sort_keys=True) == strict_json.dumps(snap, sort_keys=True)
    assert json.loads(fleet_top._strict_dumps(snap)) == {
        "fleet": {"latency_p99_ms": None, "x": [None, 1.5, [2, None]]}}


_PROBE = """
import json, sys
from eeg_dataanalysispackage_tpu_torch.tools import fleet_top, plan_admin
journal, traces, plan, url, dead = sys.argv[1:6]
rcs = [plan_admin.main(["list", "--journal", journal]),
       plan_admin.main(["fleet", "--journal", journal]),
       plan_admin.main(["trace", plan, "--journal", journal, "--trace-dir", traces]),
       fleet_top.main(["--snapshot", url, dead, "--journal", journal])]
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "flax", "optax", "eeg_dataanalysispackage_tpu"))
print("RESULT", json.dumps({"rcs": rcs, "leaked": leaked}))
"""


def test_a_fresh_interpreter_runs_the_tools_without_jax(ops):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, ops["journal"], ops["traces"], ops["plan_id"],
         ops["url"], DEAD], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.splitlines()
    result = json.loads(lines[-1].split("RESULT ", 1)[1])
    assert result == {"rcs": [0, 0, 0, 1], "leaked": []}
    snap = json.loads(lines[-2])
    assert snap["replicas"][1]["error"] and snap["fleet"]["replicas_up"] == 1
    assert "trace t-admin" in proc.stdout and "segment gw-t" in proc.stdout


# -- chaos_run


def _chaos_both(argv, monkeypatch):
    monkeypatch.delenv("EEG_TPU_FAULTS", raising=False)
    monkeypatch.setenv("EEG_TPU_NO_FEATURE_CACHE", "1")
    return (_stdout(jax_tool("chaos_run").main, argv),
            _stdout(chaos_run.main, argv + ["--device", "cpu"]))


def test_chaos_run_parity_exits_0_as_the_jax_tool(ops, monkeypatch, tmp_path):
    query = f"{ops['query']}&elastic=true&checkpoint_path={tmp_path / 'ck'}"
    want, got = _chaos_both([query, "--faults", "device.step:once@2"], monkeypatch)
    assert got == want and got[0] == 0
    assert '"chaos.fired.device.step": 1.0' in got[1] and "PARITY" in got[1]


def test_chaos_run_died_exits_2_as_the_jax_tool(ops, monkeypatch):
    want, got = _chaos_both([ops["query"], "--faults", "scheduler.plan:once@1"], monkeypatch)
    assert got == want and got[0] == 2 and "CHAOS RUN DIED: ChaosInjectedError" in got[1]


def test_chaos_run_divergence_exits_1_as_the_jax_tool(ops, monkeypatch):
    """Statistics that differ under the spec (a tampered chaos run: no
    fault the pipeline absorbs changes them) exit 1 with the diff."""
    for cls in (JaxBuilder, PipelineBuilder):
        real = cls.execute

        def execute(self, real=real):
            statistics = real(self)
            if "faults=" in self.query:
                statistics.true_positives += 1
            return statistics

        monkeypatch.setattr(cls, "execute", execute)
    want, got = _chaos_both([ops["query"], "--faults", "scheduler.plan:once@9"], monkeypatch)
    assert got == want and got[0] == 1
    assert "DIVERGED" in got[1] and "\n+True positives: " in got[1]


def test_chaos_run_refuses_a_spec_in_the_query(ops):
    with pytest.raises(SystemExit) as e:
        chaos_run.main([ops["query"] + "&faults=x:once@1", "--faults", "y", "--device", "cpu"])
    assert e.value.code == 2
