"""The port's run bracket (``scheduler/runtime.py``), run reports
(``obs/report.py``), ``faults=`` and ``trace_path=`` against the JAX
package's.

- ``run_report.json`` has the JAX package's keys for the same query (a
  fused run, a seizure run, a served run with the lifecycle), and the
  same ``statistics_sha256`` where the statistics are byte-identical;
  ``tools/obs_report.py show`` renders the port's run and crash reports.
- ``serve=true&faults=serve.request:once@4;serve.batch:once@2`` (and the
  same spec from ``EEG_TPU_FAULTS``) gives the fault-free run's
  statistics, the report counting each rule's calls and firings as the
  JAX package's does.
- an ``ingest.fused`` fault fails the run (the port has no degradation
  ladder) and writes ``crash_report.json`` with ``fired: 1``; so does a
  ``scheduler.plan`` fault.
- ``report=false`` beats ``EEG_TPU_RUN_REPORT_DIR``; ``report=true``
  writes beside ``result_path``; an unwritable report directory never
  fails the run.
- ``trace_path=<dir>`` writes a trace where the JAX package writes one:
  a Chrome trace holding the run's stages.
"""

import glob
import json
import os
import subprocess
import sys

import pytest

from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.obs import chaos
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINEAR = "config_num_iterations=30&config_step_size=1.0&config_mini_batch_fraction=1.0"
SERVE_FAULTS = "serve.request:once@4;serve.batch:once@2"


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("report_session")
    info = _synthetic.write_session(str(d), n_markers=60)
    model = str(d / "model")
    PipelineBuilder(f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}"
                    f"&save_clf=true&save_name={model}", device="cpu").execute()
    seizure = _synthetic.write_seizure_session(str(tmp_path_factory.mktemp("report_seizure")),
                                               n_files=1, n_samples=20000)
    return {"info": info, "model": model, "seizure": seizure}


def _report(directory, name="run_report.json"):
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


def _queries(session):
    fused = f"info_file={session['info']}&fe=dwt-8-fused"
    return {
        "fused": f"{fused}&train_clf=logreg&{LINEAR}&precision=int8",
        "seizure": (f"info_file={session['seizure']}&task=seizure"
                    f"&fe=dwt-4:level=4:stats=energy&train_clf=logreg&{LINEAR}&cost_fn=4"),
        "serve": (f"{fused}&serve=true&load_clf=logreg&load_name={session['model']}"
                  "&adapt=true&swap_gate=off&drift_window=16&adapt_batch=8"),
    }


@pytest.mark.parametrize("kind", ["fused", "seizure", "serve"])
def test_report_keys_and_statistics_digest_equal_jax(session, tmp_path, kind):
    q = _queries(session)[kind] + "&cache=false"
    ours = PipelineBuilder(q + f"&report={tmp_path / 'port'}", device="cpu")
    ours.execute()
    theirs = JaxBuilder(q + f"&report={tmp_path / 'jax'}").execute()
    got, want = _report(tmp_path / "port"), _report(tmp_path / "jax")
    assert sorted(got) == sorted(want)
    assert sorted(got["caches"]) == sorted(want["caches"])
    assert sorted(got["spans"]) == sorted(want["spans"])
    assert got["schema"] == "eeg-tpu-run-report/v1" and got["outcome"] == "ok"
    assert got["device"]["platform"] == "cpu" and got["device"]["device_count"] == 1
    if str(ours.statistics) == str(theirs):
        assert got["statistics_sha256"] == want["statistics_sha256"]
    assert got["accuracy"] == want["accuracy"]
    assert got["classification"] == want["classification"]
    assert got["workload"] == want["workload"]
    assert got["backend"] == want["backend"]
    if kind == "fused":
        assert got["precision"]["used"] == want["precision"]["used"] == "int8"
        assert got["stages"]["train"]["count"] == 1
    if kind == "serve":
        assert got["lifecycle"]["feedback"] == want["lifecycle"]["feedback"]
        assert got["serve"]["requests"] == want["serve"]["requests"]
        assert "lifecycle" not in got["serve"]
    assert got["chaos"] is None and got["mesh"] is None and got["degradation"] == []
    assert {"stage.train" if kind != "serve" else "stage.serve"} <= set(got["spans"]["by_name"])
    assert os.path.getsize(tmp_path / "port" / "spans.jsonl") > 0
    shown = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_report.py"),
                            "show", str(tmp_path / "port" / "run_report.json")],
                           capture_output=True, text=True, timeout=120)
    assert shown.returncode == 0, shown.stderr
    assert "RUN report" in shown.stdout and "stages:" in shown.stdout


@pytest.mark.parametrize("how", ["query", "env"])
def test_serve_faults_keep_the_statistics(session, tmp_path, monkeypatch, how):
    """Serve faults are absorbed by the batcher's retries: the fault-free
    run's statistics, and the JAX package's per-rule accounting."""
    q = (f"info_file={session['info']}&fe=dwt-8-fused&serve=true&load_clf=logreg"
         f"&load_name={session['model']}&serve_max_batch=8")
    clean = str(PipelineBuilder(q, device="cpu").execute())
    if how == "query":
        faulted = q + f"&faults={SERVE_FAULTS}"
    else:
        monkeypatch.setenv("EEG_TPU_FAULTS", SERVE_FAULTS)
        faulted = q
    ours = PipelineBuilder(faulted + f"&report={tmp_path / 'port'}", device="cpu")
    assert str(ours.execute()) == clean
    assert str(JaxBuilder(faulted + f"&report={tmp_path / 'jax'}&cache=false").execute()) == clean
    got, want = _report(tmp_path / "port"), _report(tmp_path / "jax")
    assert got["chaos"] == want["chaos"]
    assert got["chaos"]["rules"]["serve.request"]["fired"] == 1
    assert got["chaos"]["rules"]["serve.batch"]["fired"] == 1
    assert got["serve"]["requests"]["retries"] > 0 and got["serve"]["batch_failures"] == 1
    assert got["serve"]["requests"]["failed"] == want["serve"]["requests"]["failed"] == 0
    assert got["metrics"]["counters"]["chaos.fired.serve.batch"] == 1


@pytest.mark.parametrize("point", ["ingest.fused", "scheduler.plan"])
def test_a_fault_that_fails_the_run_writes_a_crash_report(session, tmp_path, point):
    """No degradation ladder: the fault raises out of the run and the
    crash report, written inside the run's domain, records the rule."""
    report = tmp_path / "rep"
    os.makedirs(report)
    (report / "run_report.json").write_text("{}")  # a stale success report
    q = (f"info_file={session['info']}&fe=dwt-8-fused&train_clf=logreg&cache=false"
         f"&faults={point}:once@1&report={report}")
    with pytest.raises(chaos.ChaosInjectedError, match=f"injected fault at {point}"):
        PipelineBuilder(q, device="cpu").execute()
    crash = _report(report, "crash_report.json")
    assert not os.path.exists(report / "run_report.json")
    assert crash["schema"] == "eeg-tpu-crash-report/v1" and crash["outcome"] == "error"
    assert crash["error"]["type"] == "ChaosInjectedError"
    assert crash["chaos"]["rules"] == {point: {"calls": 1, "fired": 1}}
    assert "chaos.fired" in [e["name"] for e in crash["events"]]
    shown = subprocess.run([sys.executable, os.path.join(REPO, "tools", "obs_report.py"),
                            "show", str(report / "crash_report.json")],
                           capture_output=True, text=True, timeout=120)
    assert shown.returncode == 0 and "CRASH report" in shown.stdout, shown.stderr
    # the JAX package steps down its ladder instead: its run ends ok
    jax_report = tmp_path / "jax"
    if point == "ingest.fused":
        JaxBuilder(q.replace(str(report), str(jax_report))).execute()
        assert _report(jax_report)["chaos"]["rules"][point]["fired"] == 1


def test_report_dir_resolution(session, tmp_path, monkeypatch):
    q = f"info_file={session['info']}&fe=dwt-8-fused&train_clf=logreg&cache=false"
    env_dir = tmp_path / "env"
    monkeypatch.setenv("EEG_TPU_RUN_REPORT_DIR", str(env_dir))
    PipelineBuilder(q + "&report=false", device="cpu").execute()
    assert not env_dir.exists()
    PipelineBuilder(q, device="cpu").execute()
    assert _report(env_dir)["query_map"].get("report") is None
    result = tmp_path / "beside" / "result.txt"
    PipelineBuilder(q + f"&report=true&result_path={result}", device="cpu").execute()
    assert os.path.exists(tmp_path / "beside" / "run_report.json")
    # an unwritable report directory (a file stands there): the run ends
    # ok, unreported
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    b = PipelineBuilder(q + f"&report={blocker}", device="cpu")
    b.execute()
    assert b.telemetry is None and b.statistics is not None


def test_trace_path_writes_a_trace_like_jax(session, tmp_path):
    """``trace_path=`` runs the run under a profiler trace: the port's is a
    Chrome trace under the directory (the JAX package writes its own
    there), holding the run's stages by name when spans are recorded."""
    q = f"info_file={session['info']}&fe=dwt-8-fused&train_clf=logreg&cache=false"
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    PipelineBuilder(q + f"&trace_path={ours}&report={tmp_path / 'rep'}",
                    device="cpu").execute()
    JaxBuilder(q + f"&trace_path={theirs}").execute()
    assert glob.glob(str(theirs / "**" / "*"), recursive=True)
    (trace,) = glob.glob(str(ours / "torch-trace-*.json"))
    with open(trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stage.ingest", "stage.train", "stage.test"} <= names
    # without a trace_path no trace is written
    PipelineBuilder(q, device="cpu").execute()
    assert len(glob.glob(str(ours / "*"))) == 1
