"""The port's cross-replica trace plane and the rest of ``obs/`` against the
JAX package's.

- **span lines**: one span/event sequence through the JAX package's and
  the port's ``SpanRecorder`` joined to a trace gives the same
  ``trace-<segment>.jsonl`` lines once wall times are masked (segment
  defaulting to ``pid<pid>``, a sanitized segment name, a takeover
  header, a span that raised, a span on another thread); a sink that
  cannot open is counted and never raises; ``install``/``uninstall``;
- **the run bracket**: ``execute_plan`` with a trace id and
  ``EEG_TPU_TRACE_DIR`` appends the plan's segment (a standalone recorder
  for an unreported plan, the report's recorder otherwise; the fleet
  replica, else the gateway's, names it; ``takeover`` on its header), and
  the report's ``trace.segment`` names it; without the directory nothing
  is written and ``trace.segment`` is None;
- **stitching**: the port's ``plan_admin trace`` prints what the JAX
  package's ``tools/plan_admin.py trace`` prints, on a synthesized
  two-segment directory (a torn last line, a dead holder's open root)
  and on segments the port wrote (a killed holder's and a survivor's);
- **obs**: ``StageTimer.stage``/``total``/``report`` give the JAX
  package's table on one clock; ``configure_logging`` writes the
  ``LOGFILE_NAME`` file the port's CLI logs to; ``save_memory_profile``
  returns False without a card.
"""

import contextlib
import importlib
import io
import json
import logging
import os
import re
import sys
import threading

import pytest

from eeg_dataanalysispackage_tpu import obs as jax_obs
from eeg_dataanalysispackage_tpu.obs import events as jax_events
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.obs import events
from eeg_dataanalysispackage_tpu_torch.pipeline import cli
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder
from eeg_dataanalysispackage_tpu_torch.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch.scheduler import runtime
from eeg_dataanalysispackage_tpu_torch.scheduler.journal import PlanJournal
from eeg_dataanalysispackage_tpu_torch.tools import plan_admin

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINEAR = "config_num_iterations=20&config_step_size=1.0&config_mini_batch_fraction=1.0"


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


def _lines(path):
    with open(path) as f:
        return [json.loads(line) for line in f.read().splitlines()]


def _masked(lines):
    """Wall times replaced by whether they were set."""
    return [{k: (v is not None if k in ("wall_start", "wall_end") else v)
             for k, v in line.items()} for line in lines]


# -- span lines


def _drive(recorder_cls, trace_dir, segment, takeover):
    rec = recorder_cls(name="plan")
    rec.set_trace("trace-x", trace_dir=trace_dir, segment=segment, plan_id="p0001",
                  takeover=takeover)
    with rec.span("stage.ingest", backend="decode"):
        rec.event("chaos.fired", point="ingest.read")
        with rec.span("ingest.parse", file="a.eeg"):
            rec.set_attr("bytes", 7200)
    with pytest.raises(ValueError):
        with rec.span("stage.train"):
            raise ValueError("boom")

    def on_worker():
        with rec.span("parse.worker", shard=1):
            pass

    worker = threading.Thread(target=on_worker, name="parse-0")
    worker.start()
    worker.join()
    rec.finish()
    return rec


@pytest.mark.parametrize("segment,takeover", [(None, False), ("gw-a", False),
                                              ("gw b/7", True)])
def test_segment_lines_equal_the_jax_recorders(tmp_path, segment, takeover):
    jax_rec = _drive(jax_events.SpanRecorder, str(tmp_path / "jax"), segment, takeover)
    port_rec = _drive(events.SpanRecorder, str(tmp_path / "port"), segment, takeover)
    assert port_rec.trace_segment == jax_rec.trace_segment
    name = f"trace-{port_rec.trace_segment}.jsonl"
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "jax") == [name]
    got, want = _lines(tmp_path / "port" / name), _lines(tmp_path / "jax" / name)
    assert _masked(got) == _masked(want)
    assert [line["kind"] for line in got] == ["segment"] + ["span"] * 5
    assert got[0]["attrs"] == {"plan_id": "p0001", "takeover": takeover}
    assert got[-1]["span_id"] == got[0]["root_span_id"] and got[-1]["parent_id"] is None
    # one clock: every span's wall times lie inside the root's
    assert all(got[-1]["wall_start"] <= s["wall_start"] <= s["wall_end"] <= got[-1]["wall_end"]
               for s in got[1:-1])


def test_without_a_directory_spans_carry_the_trace_and_nothing_is_written():
    rec = events.SpanRecorder()
    rec.set_trace("t-1", segment="gw-a")
    with rec.span("s"):
        pass
    rec.finish()
    assert (rec.trace_id, rec.trace_segment) == ("t-1", "gw-a")
    assert rec._trace_line(rec.spans()[0])["span_id"] == "gw-a:2"
    assert rec._trace_path is None and rec._trace_file is None


def test_a_sink_that_cannot_open_is_counted_and_never_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    before = obs.metrics.snapshot()["counters"].get("trace.sink_failures", 0)
    rec = events.SpanRecorder()
    rec.set_trace("t-1", trace_dir=str(blocker / "traces"), segment="gw-a")
    with rec.span("s"):
        pass
    rec.finish()
    after = obs.metrics.snapshot()["counters"].get("trace.sink_failures", 0)
    assert after - before == 1
    assert [s["name"] for s in rec.spans()] == ["s"]


def test_install_and_uninstall():
    rec = events.SpanRecorder()
    try:
        assert events.install(rec) is rec
        assert events.active_recorder() is rec
        with events.span("installed"):
            pass
        assert [s["name"] for s in rec.spans()] == ["installed"]
    finally:
        events.uninstall()
    assert events.active_recorder() is None


# -- the run bracket


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    """One trace over two replicas: gw-a runs the plan unreported, gw-b
    takes it over with a report (the survivor of a takeover writes
    ``trace-gw-b.jsonl`` beside the holder's)."""
    d = tmp_path_factory.mktemp("trace_plane")
    info = _synthetic.write_session(str(d), n_markers=40)
    query = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}&dedup=false"
    trace_dir, report_dir = str(d / "traces"), str(d / "reports" / "p0001")
    journal_dir = str(d / "journal")
    PlanJournal(journal_dir).record_submitted("p0001", query, meta={"trace_id": "trace-p1"})
    old = os.environ.get(events.ENV_TRACE_DIR)
    os.environ[events.ENV_TRACE_DIR] = trace_dir
    try:
        runs = {}
        for replica, takeover, extra in (("gw-a", False, ""),
                                         ("gw-b", True, f"&report={report_dir}")):
            builder = PipelineBuilder(query + extra, device="cpu")
            stats = runtime.execute_plan(
                ExecutionPlan.parse(query + extra), builder, plan_id="p0001",
                gateway={"via": "http", "replica": "gw-x"},
                fleet={"replica": replica, "takeover": takeover}, trace_id="trace-p1")
            runs[replica] = (builder, str(stats))
    finally:
        if old is None:
            os.environ.pop(events.ENV_TRACE_DIR)
        else:
            os.environ[events.ENV_TRACE_DIR] = old
    return {"info": info, "query": query, "trace_dir": trace_dir, "report_dir": report_dir,
            "journal_dir": journal_dir, "runs": runs}


def test_an_unreported_plan_writes_its_segment_through_a_standalone_recorder(plane):
    builder, _stats = plane["runs"]["gw-a"]
    assert builder.telemetry is None
    lines = _lines(os.path.join(plane["trace_dir"], "trace-gw-a.jsonl"))
    assert lines[0] == {**lines[0], "kind": "segment", "trace_id": "trace-p1",
                        "segment": "gw-a", "attrs": {"plan_id": "p0001", "takeover": False}}
    root = lines[-1]
    assert (root["name"], root["span_id"], root["wall_end"] is not None) == \
        ("plan", "gw-a:1", True)
    names = {line["name"] for line in lines[1:]}
    assert {"stage.ingest", "stage.train", "stage.test"} <= names


def test_a_reported_takeover_names_its_segment_in_the_report(plane):
    builder, stats = plane["runs"]["gw-b"]
    assert stats == plane["runs"]["gw-a"][1]
    with open(os.path.join(plane["report_dir"], "run_report.json")) as f:
        report = json.load(f)
    assert report["trace"] == {"trace_id": "trace-p1", "segment": "gw-b"}
    lines = _lines(os.path.join(plane["trace_dir"], "trace-gw-b.jsonl"))
    assert lines[0]["attrs"] == {"plan_id": "p0001", "takeover": True}
    root = lines[-1]
    assert (root["name"], root["parent_id"], root["attrs"]["takeover"]) == ("run", None, True)
    # the report's span summary counts what the segment holds
    assert report["spans"]["span_count"] == len(lines) - 1


@pytest.mark.parametrize("fleet,segment", [(None, "gw-x"), ({"replica": "gw-c"}, "gw-c")])
def test_the_segment_is_the_fleet_replica_else_the_gateways(tmp_path, monkeypatch, plane,
                                                             fleet, segment):
    monkeypatch.setenv(events.ENV_TRACE_DIR, str(tmp_path))
    query = plane["query"] + f"&report={tmp_path / 'rep'}"
    runtime.execute_plan(ExecutionPlan.parse(query), PipelineBuilder(query, device="cpu"),
                         plan_id="p0002", gateway={"replica": "gw-x"}, fleet=fleet,
                         trace_id="t-2")
    with open(tmp_path / "rep" / "run_report.json") as f:
        assert json.load(f)["trace"]["segment"] == segment
    assert f"trace-{segment}.jsonl" in os.listdir(tmp_path)


def test_without_the_directory_nothing_is_written(tmp_path, monkeypatch, plane):
    monkeypatch.delenv(events.ENV_TRACE_DIR, raising=False)
    query = plane["query"] + f"&report={tmp_path / 'rep'}"
    runtime.execute_plan(ExecutionPlan.parse(query), PipelineBuilder(query, device="cpu"),
                         plan_id="p0003", fleet={"replica": "gw-a"}, trace_id="t-3")
    with open(tmp_path / "rep" / "run_report.json") as f:
        assert json.load(f)["trace"] == {"trace_id": "t-3", "segment": None}
    assert sorted(os.listdir(tmp_path)) == ["rep"]


# -- stitching


def _segment_line(**kw):
    return json.dumps(kw, sort_keys=True)


def _both_traces(journal_dir, trace_dir, plan_id="p0001"):
    argv = ["trace", plan_id, "--journal", journal_dir, "--trace-dir", trace_dir]
    return _stdout(jax_tool("plan_admin").main, argv), _stdout(plan_admin.main, argv)


def test_stitching_a_synthesized_takeover_equals_the_jax_tool(tmp_path):
    journal_dir = str(tmp_path / "journal")
    PlanJournal(journal_dir).record_submitted("p0001", "q", meta={"trace_id": "trace-x"})
    trace_dir = tmp_path / "traces"
    trace_dir.mkdir()
    (trace_dir / "trace-gw-a.jsonl").write_text("\n".join([
        _segment_line(kind="segment", trace_id="trace-x", segment="gw-a",
                      root_span_id="gw-a:1", wall_start=100.0, attrs={"plan_id": "p0001"}),
        _segment_line(kind="span", trace_id="trace-x", segment="gw-a", span_id="gw-a:2",
                      parent_id="gw-a:1", name="stage.ingest", wall_start=100.1,
                      wall_end=100.4, thread="w0", attrs={}),
        '{"kind": "span", "trace_id": "trace-x", "seg',
    ]) + "\n")
    (trace_dir / "trace-gw-b.jsonl").write_text("\n".join([
        _segment_line(kind="segment", trace_id="trace-x", segment="gw-b",
                      root_span_id="gw-b:1", wall_start=103.0,
                      attrs={"plan_id": "p0001", "takeover": True}),
        _segment_line(kind="span", trace_id="trace-x", segment="gw-b", span_id="gw-b:2",
                      parent_id="gw-b:1", name="stage.train", wall_start=103.1,
                      wall_end=104.0, thread="w0", attrs={"classifier": "logreg"}),
        _segment_line(kind="span", trace_id="trace-other", segment="gw-b", span_id="gw-b:9",
                      parent_id=None, name="plan", wall_start=90.0, wall_end=91.0,
                      thread="w0", attrs={}),
        _segment_line(kind="span", trace_id="trace-x", segment="gw-b", span_id="gw-b:1",
                      parent_id=None, name="plan", wall_start=103.0, wall_end=104.2,
                      thread="w0", attrs={"plan_id": "p0001", "takeover": True}),
    ]) + "\n")
    want, got = _both_traces(journal_dir, str(trace_dir))
    assert got == want
    rc, out = got
    assert rc == 0 and "2 segment(s), 4 span(s)" in out
    assert out.index("segment gw-a") < out.index("segment gw-b")
    assert "TAKEOVER boundary: continued after gw-a died" in out
    assert "UNFINISHED (holder died mid-span)" in out and "classifier=logreg" in out


def test_stitching_the_ports_own_segments_equals_the_jax_tool(plane):
    want, got = _both_traces(plane["journal_dir"], plane["trace_dir"])
    assert got == want
    rc, out = got
    assert rc == 0 and "trace trace-p1  plan p0001" in out and "2 segment(s)" in out
    assert "segment gw-b  <-- TAKEOVER boundary: continued after gw-a died" in out


def test_stitching_a_killed_holders_port_segment_equals_the_jax_tool(tmp_path):
    """A holder that died mid-plan never closed its root: its header and
    its finished spans are all its file holds, with a torn last line."""
    journal_dir = str(tmp_path / "journal")
    PlanJournal(journal_dir).record_submitted("p0004", "q", meta={"trace_id": "t-4"})
    trace_dir = str(tmp_path / "traces")
    holder = events.SpanRecorder(name="plan")
    holder.set_trace("t-4", trace_dir=trace_dir, segment="gw-a", plan_id="p0004",
                     takeover=False)
    with holder.span("stage.ingest"):
        pass
    holder._trace_file.write('{"kind": "span", "trace_id": "t-4", "na')
    holder._trace_file.flush()  # SIGKILL here: no finish(), a torn line
    survivor = events.SpanRecorder(name="plan")
    survivor.set_trace("t-4", trace_dir=trace_dir, segment="gw-b", plan_id="p0004",
                       takeover=True)
    with survivor.span("stage.train"):
        pass
    survivor.finish()
    want, got = _both_traces(journal_dir, trace_dir, "p0004")
    assert got == want
    assert "(segment root)  UNFINISHED" in got[1] and "TAKEOVER boundary" in got[1]


@pytest.mark.parametrize("meta,needle", [({}, "no journaled trace id"),
                                         ({"trace_id": "t-9"}, "no segments under")])
def test_a_trace_that_cannot_be_stitched_exits_1_as_the_jax_tool(tmp_path, meta, needle):
    journal_dir = str(tmp_path / "journal")
    PlanJournal(journal_dir).record_submitted("p0009", "q", meta=meta)
    (tmp_path / "traces").mkdir()
    want, got = _both_traces(journal_dir, str(tmp_path / "traces"), "p0009")
    assert got == want and got[0] == 1 and needle in got[1]


# -- obs


class _Clock:
    """A fake ``time`` module whose ``perf_counter`` steps through ``ticks``."""

    def __init__(self, ticks):
        self._ticks = iter(ticks)

    def perf_counter(self):
        return next(self._ticks)


def _timed(timer, module, monkeypatch):
    monkeypatch.setattr(module, "time", _Clock([0.0, 0.25, 1.0, 1.0, 2.0, 2.125, 3.0, 3.5]))
    for name in ("featurize", "featurize", "train", "ingest"):
        with timer.stage(name):
            pass
    return timer


def test_stage_timer_equals_the_jax_packages(monkeypatch):
    port = _timed(obs.StageTimer(), obs, monkeypatch)
    want = _timed(jax_obs.StageTimer(), jax_obs, monkeypatch)
    assert port.report() == want.report()
    assert port.as_dict() == want.as_dict()
    assert (port.total("featurize"), port.total("never")) == (0.25, 0.0)
    assert re.match(r"ingest +0\.5000s  x1  mean", port.report().splitlines()[0])
    assert "never" not in port.as_dict()


def test_stage_timer_accumulates():
    t = obs.StageTimer()
    with t.stage("a"):
        pass
    with t.stage("a"):
        pass
    with pytest.raises(RuntimeError):
        with t.stage("b"):
            raise RuntimeError("recorded anyway")
    d = t.as_dict()
    assert (d["a"]["count"], d["b"]["count"]) == (2, 1)
    assert "x2" in t.report()


@pytest.fixture
def root_logging():
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    for h in handlers:
        if h not in root.handlers:
            root.addHandler(h)
    root.setLevel(level)


def test_configure_logging_file_handler(tmp_path, root_logging):
    logfile = str(tmp_path / "logs" / "run.log")
    obs.configure_logging(logfile=logfile)
    logging.getLogger("obs-test").info("hello obs")
    for h in logging.getLogger().handlers:
        h.flush()
    with open(logfile) as f:
        line = f.read().strip()
    assert line.endswith("INFO obs-test - hello obs")
    assert isinstance(logging.getLogger().handlers[-1], logging.handlers.TimedRotatingFileHandler)


def test_the_cli_logs_to_logfile_name_with_the_stage_table(tmp_path, monkeypatch, plane,
                                                           root_logging):
    logfile = tmp_path / "cli.log"
    monkeypatch.setenv("LOGFILE_NAME", str(logfile))
    monkeypatch.setattr(cli.builder, "PipelineBuilder",
                        lambda q: PipelineBuilder(q, device="cpu"))
    rc, out = _stdout(cli.main, [plane["query"]])
    assert rc == 0 and out == plane["runs"]["gw-a"][1]
    for h in logging.getLogger().handlers:
        h.flush()
    text = logfile.read_text()
    assert "Application started with arguments" in text and "stage timings:\n" in text
    for stage in ("ingest", "train", "test"):
        assert re.search(rf"^{stage} +\d+\.\d{{4}}s  x1  mean ", text, re.M), stage


def test_save_memory_profile_without_a_card(tmp_path):
    """No CUDA allocator: False, as the JAX package's function returns where
    its backend has no memory profiling (the card's case is in
    tests/test_torch_cuda.py)."""
    assert obs.save_memory_profile(str(tmp_path / "mem.pkl")) is False
    assert not os.path.exists(tmp_path / "mem.pkl")
