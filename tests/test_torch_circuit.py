"""The port's circuit breaker (``io/circuit.py``) and fault injection
(``obs/chaos.py``) against the JAX package's.

Twin of ``tests/test_circuit.py``: the state machine under an injected
clock (nothing sleeps), the half-open probe under concurrent callers,
plan-tagged evidence and ``snapshot()``, and the breaker wrapped around
``HttpFileSystem`` against a failing loopback server. Parity cases drive
both packages' breakers with the same clock and failures and compare
every state and snapshot, and feed both packages' ``parse_fault_spec``
the same spec and seed and compare the calls that fire.
"""

import os
import sys
import threading

import pytest

from eeg_dataanalysispackage_tpu import obs as jax_obs
from eeg_dataanalysispackage_tpu.io import circuit as jax_circuit
from eeg_dataanalysispackage_tpu.obs import chaos as jax_chaos
from eeg_dataanalysispackage_tpu.obs import domain as jax_domain
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import circuit, remote
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain, events

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _breaker(threshold=3, cooldown=10.0, module=circuit):
    clock = _Clock()
    return module.CircuitBreaker("http://ep", threshold=threshold, cooldown_s=cooldown,
                                 clock=clock), clock


def test_opens_after_consecutive_failures_only():
    cb, _ = _breaker(threshold=3)
    for _ in range(2):
        cb.allow()
        cb.record_failure(IOError("x"))
    cb.allow()
    cb.record_success()  # resets the consecutive count
    for _ in range(2):
        cb.allow()
        cb.record_failure(IOError("x"))
    assert cb.state == circuit.CLOSED
    cb.record_failure(IOError("third consecutive"))
    assert cb.state == circuit.OPEN


def test_open_fails_fast_with_evidence():
    cb, _ = _breaker(threshold=2)
    cb.record_failure(IOError("first budget"))
    cb.record_failure(IOError("second budget"))
    with pytest.raises(circuit.CircuitOpenError) as ei:
        cb.allow()
    msg = str(ei.value)
    assert "2 exhausted retry budgets" in msg
    assert "first budget" in msg and "second budget" in msg
    assert isinstance(ei.value, IOError)


def test_half_open_probe_closes_on_success():
    cb, clock = _breaker(threshold=1, cooldown=5.0)
    cb.record_failure(IOError("x"))
    with pytest.raises(circuit.CircuitOpenError):
        cb.allow()
    clock.now = 5.1
    cb.allow()  # the probe goes through
    assert cb.state == circuit.HALF_OPEN
    with pytest.raises(circuit.CircuitOpenError):
        cb.allow()  # concurrent callers keep failing fast mid-probe
    cb.record_success()
    assert cb.state == circuit.CLOSED
    cb.allow()


def test_half_open_probe_failure_reopens():
    cb, clock = _breaker(threshold=1, cooldown=5.0)
    cb.record_failure(IOError("x"))
    clock.now = 5.1
    cb.allow()
    cb.record_failure(IOError("still down"))
    assert cb.state == circuit.OPEN
    with pytest.raises(circuit.CircuitOpenError):
        cb.allow()  # the cooldown clock restarted
    clock.now = 10.3
    cb.allow()  # the next probe window


def test_threshold_zero_disables():
    cb = circuit.CircuitBreaker("http://ep", threshold=0)
    for _ in range(10):
        cb.record_failure(IOError("x"))
        cb.allow()  # never opens


def test_registry_shares_per_endpoint_and_reads_the_env(monkeypatch):
    circuit.reset()
    try:
        a = circuit.breaker_for("http://one:80")
        assert a is circuit.breaker_for("http://one:80")
        assert a is not circuit.breaker_for("http://two:80")
        assert (a.threshold, a.cooldown_s) == (circuit.DEFAULT_THRESHOLD,
                                               circuit.DEFAULT_COOLDOWN_S)
        monkeypatch.setenv("EEG_TPU_CIRCUIT_THRESHOLD", "7")
        monkeypatch.setenv("EEG_TPU_CIRCUIT_COOLDOWN", "2.5")
        c = circuit.breaker_for("http://three:80")
        assert (c.threshold, c.cooldown_s) == (7, 2.5)
        monkeypatch.setenv("EEG_TPU_CIRCUIT_THRESHOLD", "many")
        d = circuit.breaker_for("http://four:80")
        assert d.threshold == circuit.DEFAULT_THRESHOLD
    finally:
        circuit.reset()


def _race_allow(cb, n_threads=8):
    """``allow()`` from n threads behind a barrier; returns (admitted,
    fast-failed) counts."""
    barrier = threading.Barrier(n_threads)
    admitted, failed = [], []
    lock = threading.Lock()

    def caller():
        barrier.wait(timeout=10)
        try:
            cb.allow()
        except circuit.CircuitOpenError:
            with lock:
                failed.append(1)
        else:
            with lock:
                admitted.append(1)

    threads = [threading.Thread(target=caller) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return len(admitted), len(failed)


def test_half_open_admits_exactly_one_probe_under_concurrency():
    cb, clock = _breaker(threshold=1, cooldown=5.0)
    cb.record_failure(IOError("down"))
    clock.now = 5.1
    assert _race_allow(cb) == (1, 7)
    assert cb.state == circuit.HALF_OPEN


def test_concurrent_probe_success_closes_exactly_once():
    cb, clock = _breaker(threshold=1, cooldown=5.0)
    cb.record_failure(IOError("down"))
    clock.now = 5.1
    assert _race_allow(cb)[0] == 1
    before = obs.metrics.snapshot()["counters"].get("circuit.closed", 0.0)
    cb.record_success()
    assert obs.metrics.snapshot()["counters"]["circuit.closed"] - before == 1
    assert cb.state == circuit.CLOSED
    assert _race_allow(cb) == (8, 0)


def test_concurrent_probe_failure_reopens_exactly_once():
    cb, clock = _breaker(threshold=1, cooldown=5.0)
    cb.record_failure(IOError("down"))
    clock.now = 5.1
    assert _race_allow(cb)[0] == 1
    before = obs.metrics.snapshot()["counters"].get("circuit.opened", 0.0)
    cb.record_failure(IOError("probe failed"))
    assert obs.metrics.snapshot()["counters"]["circuit.opened"] - before == 1
    assert cb.state == circuit.OPEN
    assert _race_allow(cb) == (0, 8)
    clock.now = 10.3
    assert _race_allow(cb) == (1, 7)


# -- through HttpFileSystem ---------------------------------------------------


class _Down(_loopback.Handler):
    """Answers 503 to every GET while ``store.down`` is set."""

    def do_GET(self):
        self._log("GET")
        if getattr(self.store, "down", True):
            self._send(503)
        else:
            self._send(200, b"alive")


def test_breaker_wraps_http_filesystem():
    """Two exhausted budgets open the circuit; the next call fails fast
    with no request; a recovered endpoint closes it through the
    half-open probe (the breaker's clock is injected, nothing sleeps)."""
    with _loopback.Server(_Down) as srv:
        circuit.reset()
        try:
            clock = _Clock()
            cb = circuit.breaker_for(srv.base)
            cb.threshold, cb.cooldown_s, cb._clock = 2, 5.0, clock
            fs = remote.HttpFileSystem(
                retry=remote.RetryPolicy(max_attempts=2, timeout_s=5.0, backoff_s=0.01))
            before = obs.metrics.snapshot()["counters"]
            for _ in range(2):
                with pytest.raises(remote.RemoteIOError, match="after 2 attempts"):
                    fs.read_bytes(f"{srv.base}/x.bin")
            assert len(srv.store.requests) == 4
            with pytest.raises(circuit.CircuitOpenError, match="circuit open"):
                fs.read_bytes(f"{srv.base}/x.bin")
            assert len(srv.store.requests) == 4  # no request left the process
            after = obs.metrics.snapshot()["counters"]
            assert after.get("circuit.opened", 0) - before.get("circuit.opened", 0) == 1
            assert after.get("circuit.fast_fail", 0) > before.get("circuit.fast_fail", 0)
            srv.store.down = False
            clock.now = 5.1
            assert fs.read_bytes(f"{srv.base}/x.bin") == b"alive"
            assert fs.read_bytes(f"{srv.base}/x.bin") == b"alive"
            assert cb.state == circuit.CLOSED
        finally:
            circuit.reset()


def test_evidence_is_plan_tagged_inside_a_domain():
    b = circuit.CircuitBreaker("http://snap.example:1", threshold=2)
    with domain.activate(domain.RunDomain(plan_id="pA")):
        assert domain.current_plan_id() == "pA"
        b.record_failure(IOError("boom 1"))
    assert domain.current_plan_id() is None
    b.record_failure(IOError("boom 2"))  # outside any domain: untagged
    snap = b.snapshot()
    assert snap["state"] == "open"
    assert snap["consecutive_failures"] == 2
    assert snap["evidence"] == ["[plan pA] OSError: boom 1", "OSError: boom 2"]
    assert snap["contributing_plans"] == ["pA"]
    with pytest.raises(circuit.CircuitOpenError, match=r"\[plan pA\]"):
        b.allow()


def test_registry_snapshot_is_schema_stable():
    circuit.reset()
    assert circuit.snapshot() == {}
    circuit.breaker_for("http://reg.example:9870").record_failure(IOError("x"))
    snap = circuit.snapshot()
    assert set(snap) == {"http://reg.example:9870"}
    assert snap["http://reg.example:9870"]["total_failures"] == 1
    circuit.reset()


def test_breaker_sequence_and_snapshots_equal_jax_package():
    """The same clock, calls and failures through both packages'
    breakers: every state, outcome and snapshot equal."""
    ours, our_clock = _breaker(threshold=2, cooldown=5.0)
    theirs, their_clock = _breaker(threshold=2, cooldown=5.0, module=jax_circuit)
    script = ["allow", "fail", "allow", "success", "fail", "fail", "allow", "t=3", "allow",
              "t=5.5", "allow", "allow", "fail", "allow", "t=11", "allow", "success", "allow",
              "fail", "plan", "fail", "allow"]

    def step(cb, clock, dom, op):
        if op.startswith("t="):
            clock.now = float(op[2:])
        elif op == "allow":
            try:
                cb.allow()
            except IOError as e:
                return type(e).__name__
            return "allowed"
        elif op == "fail":
            cb.record_failure(IOError(f"down at {clock.now}"))
        elif op == "plan":
            with dom.activate(dom.RunDomain(plan_id="p7")):
                cb.record_failure(IOError("tagged"))
        else:
            cb.record_success()
        return None

    for op in script:
        a = step(ours, our_clock, domain, op)
        b = step(theirs, their_clock, jax_domain, op)
        assert a == b, op
        assert ours.state == theirs.state, op
        assert ours.snapshot() == theirs.snapshot(), op
    assert ours.snapshot()["contributing_plans"] == ["p7"]


# -- fault injection ------------------------------------------------------------


@pytest.mark.parametrize("spec,seed", [
    ("remote.request:p=0.3", 0),
    ("remote.request:p=0.5;seed=7", 0),
    ("remote.request:p=0.25", 11),
    ("remote.request:once@4", 0),
    ("remote.request:err@2", 0),
    ("remote.request:every@3", 5),
])
def test_fault_spec_fires_at_the_jax_package_calls(spec, seed):
    ours = chaos.parse_fault_spec(spec, seed=seed)
    theirs = jax_chaos.parse_fault_spec(spec, seed=seed)
    assert ours.seed == theirs.seed
    fired = [ours.should_fire("remote.request") for _ in range(200)]
    assert fired == [theirs.should_fire("remote.request") for _ in range(200)]
    assert any(fired)
    assert not ours.should_fire("remote.other")
    assert repr(ours) == repr(theirs)


@pytest.mark.parametrize("spec,match", [
    # serve.request, serve.batch, ingest.fused and scheduler.plan fire in
    # the port since the run bracket came (tests/test_torch_report.py)
    ("fleet.lease:once@4", "not yet ported"),
    ("remote.request:once@1;scheduler.journal:p=0.5", "not yet ported"),
    # device.step fires in the port since its elastic trainer came
    ("staging.producer:err@7", "not yet ported"),
    ("remote.request", "point:directive"),
    ("remote.request:sometimes", "bad directive"),
    ("remote.request:p=1.5", "out of"),
    ("remote.request:once@0", ">= 1"),
    ("seed=x;remote.request:once@1", "bad seed"),
])
def test_fault_spec_refuses_what_the_port_cannot_fire(spec, match):
    with pytest.raises(chaos.FaultSpecError, match=match):
        chaos.parse_fault_spec(spec)


def test_remote_request_chaos_is_absorbed_by_the_retries():
    """remote.request faults land in the retry ladder: the read
    succeeds, the firings are counted, and a domain's own plan shadows
    the process-wide one."""
    with _loopback.Server() as srv:
        srv.store.files["/c.bin"] = b"c" * 1000
        fs = remote.HttpFileSystem(
            retry=remote.RetryPolicy(max_attempts=4, timeout_s=5.0, backoff_s=0.01))
        before = obs.metrics.snapshot()["counters"].get("chaos.fired.remote.request", 0)
        recorder = events.SpanRecorder("chaos")
        with events.recording(recorder), chaos.faults("remote.request:every@2") as plan:
            assert chaos.active_plan() is plan
            assert fs.exists(f"{srv.base}/c.bin")  # call 1
            assert fs.read_bytes(f"{srv.base}/c.bin") == b"c" * 1000  # call 2 fires
            with domain.activate(domain.RunDomain(chaos=chaos.parse_fault_spec(
                    "remote.request:once@99"))):
                assert chaos.active_plan() is not plan
        assert chaos.active_plan() is None
        assert obs.metrics.snapshot()["counters"]["chaos.fired.remote.request"] - before == 1
        names = [e["name"] for e in recorder.recent_events()]
        assert names == ["chaos.fired", "remote.retry"]


def test_metrics_scope_and_snapshot_match_jax_package():
    m = obs.Metrics()
    m.count("a")
    with m.scope() as child:
        m.count("a", 2)
        m.gauge("g", 5)
    m.count("a")
    assert child.snapshot() == {"counters": {"a": 2.0}, "gauges": {"g": 5}}
    assert m.snapshot()["counters"] == {"a": 4.0}
    assert m.to_json() == '{"counters": {"a": 4.0}, "gauges": {"g": 5}}'
    m.reset()
    assert m.snapshot() == {"counters": {}, "gauges": {}}
    ours, jax_m = obs.Metrics(), jax_obs.Metrics()
    for sink in (ours, jax_m):
        sink.count("x", 3)
        sink.gauge("y", 1.5)
        with sink.scope() as scoped:
            sink.count("x")
        assert scoped.snapshot()["counters"] == {"x": 1.0}
    assert ours.to_json() == jax_m.to_json()


def test_span_recorder_nests_and_records_errors():
    assert events.active_recorder() is None
    with events.span("off") as rec:
        assert rec is None  # no recorder: a no-op
    events.event("dropped")
    recorder = events.SpanRecorder("run", max_spans=3)
    with events.recording(recorder):
        with events.span("outer", k=1) as outer:
            events.set_attr("a", 2)
            with events.span("inner"):
                events.event("mark", n=3)
        with pytest.raises(ValueError):
            with events.span("boom"):
                raise ValueError("bad")
        with events.span("dropped"):
            pass
        other = events.SpanRecorder("plan")
        with domain.activate(domain.RunDomain(recorder=other)):
            events.event("in_the_plan")  # the domain's recorder wins
    assert events.active_recorder() is None
    assert recorder.root["end"] is not None
    spans = {s["name"]: s for s in recorder.spans()}
    assert set(spans) == {"outer", "inner", "boom"} and recorder.dropped_spans == 1
    assert spans["inner"]["parent"] == outer["id"]
    assert spans["outer"]["attrs"] == {"k": 1, "a": 2}
    assert spans["boom"]["attrs"]["error"] == "ValueError: bad"
    assert [e["name"] for e in recorder.recent_events()] == ["mark"]
    assert [e["name"] for e in other.recent_events()] == ["in_the_plan"]


@pytest.mark.parametrize("how", ["query", "env"])
def test_a_run_refuses_a_fault_spec(how, monkeypatch):
    """A run's faults= spec (the query key or EEG_TPU_FAULTS) that names
    a point the port has no site for raises before anything is read,
    rather than parse and never fire. (A spec of ported points runs:
    tests/test_torch_report.py.)"""
    from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

    q = "info_file=/nonexistent/info.txt&fe=dwt-8-fused&train_clf=logreg"
    if how == "query":
        q += "&faults=remote.request:p=0.5;staging.producer:once@1"
    else:
        monkeypatch.setenv("EEG_TPU_FAULTS", "remote.request:p=0.5;staging.producer:once@1")
    with pytest.raises(chaos.FaultSpecError,
                       match="fault point 'staging.producer' is not yet ported"):
        PipelineBuilder(q, device="cpu").execute()
