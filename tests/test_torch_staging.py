"""The port's host-to-device staging (``io/staging.py``) on the CPU, as
the JAX package's ``tests/test_staging.py`` and the ``stage_fn`` cases of
``tests/test_overlap_ingest.py`` hold its own.

``prefetch`` keeps the source's order at every buffer depth; source and
stage errors surface at the consumer in order; an early close releases the
producer; a slow producer does not trip the watchdog, a dead one fails the
consumer fast; an error nobody received is logged; ``staging.producer``
fires once under a fault plan. The built-in stage, the shared
``EEG_TPU_PREFETCH_DEPTH`` knob and ``minibatches`` equal the JAX
package's. (The card's pinned copies and event handoff are held in
``tests/test_torch_cuda.py``.)
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import staging as jax_staging
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import staging
from eeg_dataanalysispackage_tpu_torch.obs import chaos, domain, events


def _prefetch(source, **kw):
    return staging.prefetch(source, device="cpu", **kw)


@pytest.mark.parametrize("drop", [False, True])
def test_minibatches_equal_jax(drop):
    x = np.arange(20).reshape(10, 2)
    y = np.arange(10)
    ours = list(staging.minibatches(x, y, batch_size=4, drop_remainder=drop))
    theirs = list(jax_staging.minibatches(x, y, batch_size=4, drop_remainder=drop))
    assert [b[0].shape[0] for b in ours] == ([4, 4] if drop else [4, 4, 2])
    for a, b in zip(ours, theirs, strict=True):
        for u, v in zip(a, b, strict=True):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError, match="misaligned"):
        list(staging.minibatches(np.ones(4), np.ones(5), batch_size=2))
    with pytest.raises(ValueError, match="positive"):
        list(staging.minibatches(np.ones(4), batch_size=0))


def test_builtin_stage_equals_direct_staging():
    rng = np.random.RandomState(0)
    x = rng.randn(9, 3).astype(np.float32)
    y = rng.randn(9).astype(np.float32)
    got = list(staging.prefetch_epochs(x, y, batch_size=4, device="cpu"))
    assert len(got) == 3
    for (gx, gy), start in zip(got, range(0, 9, 4)):
        assert isinstance(gx, torch.Tensor) and gx.device.type == "cpu"
        np.testing.assert_array_equal(gx.numpy(), x[start:start + 4])
        np.testing.assert_array_equal(gy.numpy(), y[start:start + 4])


@pytest.mark.parametrize("depth", [1, 2, 5])
def test_stage_fn_keeps_the_order_at_every_depth(depth):
    items = list(range(40))
    got = list(_prefetch(iter(items), stage_fn=lambda i: i * 10, buffer_size=depth))
    assert got == [i * 10 for i in items]
    # the JAX package's producer, at the same depth, gives the same sequence
    assert got == list(jax_staging.prefetch(iter(items), stage_fn=lambda i: i * 10,
                                            buffer_size=depth))


def _failing_source():
    yield 0
    yield 1
    raise RuntimeError("boom in source")


def _failing_stage(i):
    if i == 2:
        raise RuntimeError("boom in stage")
    return i


@pytest.mark.parametrize("where", ["source", "stage"])
def test_errors_surface_at_the_consumer_in_order(where):
    if where == "source":
        it = _prefetch(_failing_source(), stage_fn=lambda i: i)
    else:
        it = _prefetch(iter(range(10)), stage_fn=_failing_stage)
    got = []
    with pytest.raises(RuntimeError, match=f"boom in {where}"):
        for v in it:
            got.append(v)
    assert got == [0, 1]


@pytest.mark.parametrize("with_stage_fn", [False, True])
def test_early_close_releases_the_producer(with_stage_fn):
    pulled = []

    def source():
        for i in range(10_000):
            pulled.append(i)
            yield (np.full(2, i, np.float32),)

    kw = {"stage_fn": lambda b: b[0][0]} if with_stage_fn else {}
    it = _prefetch(source(), buffer_size=2, **kw)
    next(it)
    it.close()
    time.sleep(0.2)
    # the producer stopped near the consumer, not 10,000 items later
    assert len(pulled) <= 8


def test_a_slow_producer_does_not_trip_the_watchdog():
    def slow(i):
        time.sleep(0.12)  # several watchdog polls
        return i

    got = list(_prefetch(iter(range(4)), stage_fn=slow, buffer_size=1, watchdog_poll_s=0.05))
    assert got == [0, 1, 2, 3]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_dead_producer_fails_the_consumer_fast(monkeypatch):
    """The producer's own failure path fails (its error cannot even be
    wrapped): only the watchdog stands between the consumer and a block
    on an empty queue forever."""
    recorder = events.SpanRecorder("dead")
    monkeypatch.setattr(staging, "_Poison", staging._END.__class__)  # raises TypeError

    def boom(i):
        raise RuntimeError("undeliverable")

    t0 = time.perf_counter()
    with events.recording(recorder):
        with pytest.raises(staging.ProducerDiedError, match="died without"):
            list(_prefetch(iter(range(3)), stage_fn=boom, watchdog_poll_s=0.05))
    assert time.perf_counter() - t0 < 5.0
    names = [e["name"] for e in recorder.recent_events()]
    assert "staging.producer_error" in names and "staging.producer_dead" in names


def test_an_undelivered_error_is_logged(caplog):
    stop_seen = threading.Event()

    def source():
        yield 1
        # fail only once the consumer has closed: the error cannot be delivered
        stop_seen.wait(5.0)
        raise RuntimeError("boom after close")

    it = _prefetch(source(), stage_fn=lambda i: i, buffer_size=1)
    next(it)
    with caplog.at_level(logging.WARNING, logger="eeg_dataanalysispackage_tpu_torch.io.staging"):
        stop_seen.set()
        time.sleep(0.2)
        it.close()
    assert "never delivered" in caplog.text and "boom after close" in caplog.text


@pytest.mark.parametrize("how", ["process", "run_domain"])
def test_staging_producer_fires_once_under_a_fault_plan(how):
    """The producer adopts the starting thread's run domain: a plan
    installed there (a run's faults=) or process-wide fires on the
    producer's first item, and the injected error reaches the consumer
    before any item does."""
    before = obs.metrics.snapshot()["counters"].get("chaos.fired.staging.producer", 0.0)
    if how == "process":
        scope = chaos.faults("staging.producer:once@1")
    else:
        scope = domain.activate(domain.RunDomain(
            chaos=chaos.parse_fault_spec("staging.producer:once@1")))
    got = []
    with scope:
        with pytest.raises(chaos.ChaosInjectedError, match="staging.producer"):
            for v in _prefetch(iter(range(5)), stage_fn=lambda i: i):
                got.append(v)
    after = obs.metrics.snapshot()["counters"]["chaos.fired.staging.producer"]
    assert got == [] and after - before == 1


def test_the_buffer_depth_is_the_shared_knob(monkeypatch):
    monkeypatch.setenv(staging.ENV_PREFETCH_DEPTH, "3")
    assert staging.default_buffer_size() == jax_staging.default_buffer_size() == 3
    got = list(_prefetch(staging.minibatches(np.ones((6, 2), np.float32), batch_size=2)))
    assert len(got) == 3
    monkeypatch.setenv(staging.ENV_PREFETCH_DEPTH, "bad")
    assert staging.default_buffer_size() == jax_staging.default_buffer_size() == 2
    with pytest.raises(ValueError, match="buffer_size"):
        list(_prefetch(iter([]), buffer_size=0))


def test_the_stage_runs_on_the_producer_thread():
    seen = []
    got = list(_prefetch(iter(range(3)), stage_fn=lambda i: seen.append(
        threading.current_thread().name) or i))
    assert got == [0, 1, 2]
    assert seen == ["eeg-tpu-prefetch"] * 3


def test_no_silent_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None stages on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        list(staging.prefetch(iter([])))
