"""The port's HTTP(S) and ``gs://`` filesystems against the JAX package's.

Twin of ``tests/test_remote_fs.py`` for ``eeg_dataanalysispackage_tpu_torch``:
a real ``http.server`` on 127.0.0.1 (``tests/_loopback.py``) with failure
injection (transient 500s, mid-body truncation, a Range-ignoring mode,
``Content-Range: …/*``, no HEAD) drives the client machinery — bounded
retries with backoff, chunked ranged reads, resume after a drop, 404 as
``FileNotFoundError``, keep-alive reuse, deadline-aware retries. The end
to end cases serve a two-recording synthetic session (the reference
fixture's layout; the fixture itself is not in the repo) and run the port's provider and pipeline
with ``info_file=http://...``; epochs, fused features and
``str(statistics)`` equal the port's local run and the JAX package's run
over the same server, byte for byte. Retries use
``RetryPolicy(max_attempts=4, backoff_s=0.01)``, so nothing sleeps long.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.io import remote as jax_remote
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import circuit, deadline, provider, remote, sources
from eeg_dataanalysispackage_tpu_torch.obs import events
from eeg_dataanalysispackage_tpu_torch.models.linear import (
    LogisticRegressionClassifier, SVMClassifier,
)
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402


@pytest.fixture(scope="module")
def loopback():
    with _loopback.Server() as srv:
        yield srv


@pytest.fixture()
def server(loopback):
    """A fresh store and fresh circuit breakers (both packages') per test."""
    store = loopback.reset()
    circuit.reset()
    jax_remote.circuit.reset()
    yield loopback.base, store
    circuit.reset()
    jax_remote.circuit.reset()


@pytest.fixture(autouse=True)
def jax_parse_pool_of_one(monkeypatch):
    """The JAX package's parse pool shares one HttpFileSystem between its
    workers, and an instance is not thread-safe (its keep-alive
    connections are per instance): its runs over the server parse one
    file at a time."""
    monkeypatch.setenv("EEG_TPU_INGEST_WORKERS", "1")


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("remote_session"))
    return _loopback.write_remote_session(d)


def _fast_retry():
    return remote.RetryPolicy(max_attempts=4, timeout_s=5.0, backoff_s=0.01)


def _fs(base, **kw):
    return remote.HttpFileSystem(base_url=base, retry=_fast_retry(), **kw)


def _serve_session(store, session):
    store.add_tree(os.path.dirname(session), "/data")


def test_basic_read_write_exists(server):
    base, _ = server
    fs = _fs(base)
    assert not fs.exists(f"{base}/a.txt")
    fs.write_bytes(f"{base}/a.txt", b"hello remote")
    assert fs.exists(f"{base}/a.txt")
    assert fs.read_bytes(f"{base}/a.txt") == b"hello remote"
    assert fs.read_text(f"{base}/a.txt") == "hello remote"


def test_missing_object_raises_filenotfound(server):
    base, _ = server
    with pytest.raises(FileNotFoundError):
        _fs(base).read_bytes(f"{base}/nope.bin")


def test_chunked_ranged_read_reassembles(server):
    base, store = server
    payload = bytes(range(256)) * 1000  # 256000 B
    store.files["/blob.bin"] = payload
    assert _fs(base, chunk_size=10_000).read_bytes(f"{base}/blob.bin") == payload
    assert len([p for m, p in store.requests if m == "GET"]) == 26  # ceil(256000 / 10000)


def test_transient_500s_are_retried(server):
    base, store = server
    store.files["/flaky.bin"] = b"x" * 100
    store.fail_next = 2
    assert _fs(base).read_bytes(f"{base}/flaky.bin") == b"x" * 100


def test_retry_budget_exhausts_loudly(server):
    base, store = server
    store.files["/dead.bin"] = b"x"
    store.fail_next = 99
    with pytest.raises(remote.RemoteIOError, match="after 4 attempts"):
        _fs(base).read_bytes(f"{base}/dead.bin")


def test_mid_body_truncation_resumes(server):
    base, store = server
    payload = np.random.RandomState(0).bytes(50_000)
    store.files["/drop.bin"] = payload
    store.truncate_next = 2  # the first two chunk bodies die halfway
    assert _fs(base, chunk_size=20_000).read_bytes(f"{base}/drop.bin") == payload


def test_server_without_range_support(server):
    base, store = server
    store.files["/whole.bin"] = b"y" * 30_000
    store.ignore_range = True
    assert _fs(base, chunk_size=1_000).read_bytes(f"{base}/whole.bin") == b"y" * 30_000


def test_read_range_block_read(server):
    base, store = server
    store.files["/blk.bin"] = bytes(range(200))
    assert _fs(base).read_range(f"{base}/blk.bin", 10, 5) == bytes(range(10, 15))


def test_empty_object(server):
    base, store = server
    store.files["/empty.bin"] = b""
    fs = _fs(base)
    assert fs.exists(f"{base}/empty.bin")
    assert fs.read_bytes(f"{base}/empty.bin") == b""


@pytest.mark.parametrize("size", [25_000, 30_000])  # a short final chunk, an exact multiple
def test_unknown_total_content_range(server, size):
    base, store = server
    store.files["/u.bin"] = np.random.RandomState(size).bytes(size)
    store.unknown_total = True
    assert _fs(base, chunk_size=10_000).read_bytes(f"{base}/u.bin") == store.files["/u.bin"]


def test_headless_endpoint_exists_including_empty(server):
    base, store = server
    store.no_head = True
    store.files["/some.bin"] = b"data"
    store.files["/empty.bin"] = b""
    fs = _fs(base)
    assert fs.exists(f"{base}/some.bin")
    assert fs.exists(f"{base}/empty.bin")  # 416 on the 1-byte probe = exists
    assert not fs.exists(f"{base}/nope.bin")


def test_connection_reuse_across_chunks(server):
    base, store = server
    store.files["/r.bin"] = b"q" * 50_000
    fs = _fs(base, chunk_size=10_000)
    fs.read_bytes(f"{base}/r.bin")
    assert len(fs._conns) == 1  # one keep-alive connection, reused 5x
    conn = next(iter(fs._conns.values()))
    fs.read_bytes(f"{base}/r.bin")
    assert next(iter(fs._conns.values())) is conn


def test_head_then_get_reuses_the_connection_without_a_retry(server):
    """exists() (a HEAD) then read_bytes() on one instance: both go over
    one kept-alive connection and no attempt fails. (The JAX package's
    client leaves the HEAD response unread, so its next request on the
    connection fails once and retries after a backoff.)"""
    base, store = server
    store.files["/h.bin"] = b"h" * 5000
    fs = _fs(base)
    recorder = events.SpanRecorder("head")
    with events.recording(recorder):
        for _ in range(3):
            assert fs.exists(f"{base}/h.bin")
            assert fs.read_bytes(f"{base}/h.bin") == b"h" * 5000
    assert [e["name"] for e in recorder.recent_events()] == []
    assert [m for m, _ in store.requests] == ["HEAD", "GET"] * 3


def test_gcs_uri_maps_to_endpoint(server):
    base, store = server
    store.files["/bucket/obj.txt"] = b"in the bucket"
    fs = remote.GcsFileSystem(endpoint=base, retry=_fast_retry())
    assert fs.read_bytes("gs://bucket/obj.txt") == b"in the bucket"
    assert fs.exists("gs://bucket/obj.txt")


def test_gcs_token_sets_bearer_header(server):
    base, store = server
    store.files["/b/o"] = b"z"
    fs = remote.GcsFileSystem(endpoint=base, token="tok123", retry=_fast_retry())
    assert fs.headers["Authorization"] == "Bearer tok123"
    assert fs.read_bytes("gs://b/o") == b"z"


@pytest.mark.parametrize("location,kind", [
    ("http://x/info.txt", "HttpFileSystem"),
    ("https://x/info.txt", "HttpFileSystem"),
    ("gs://b/info.txt", "GcsFileSystem"),
    ("hdfs://nn:8020/info.txt", "WebHdfsFileSystem"),
    ("/local/info.txt", "LocalFileSystem"),
    ("file:///local/info.txt", "LocalFileSystem"),
])
def test_filesystem_for_routing_matches_jax_package(location, kind, monkeypatch):
    monkeypatch.delenv("HDFS_DRIVER", raising=False)
    assert type(remote.filesystem_for(location)).__name__ == kind
    assert type(jax_remote.filesystem_for(location)).__name__ == kind


def test_local_file_uri_tolerated(tmp_path):
    p = tmp_path / "x.txt"
    p.write_bytes(b"local")
    fs = sources.LocalFileSystem()
    assert fs.exists(f"file://{p}")
    assert fs.read_bytes(f"file://{p}") == b"local"
    assert fs.size(f"file://{p}") == 5


def test_in_memory_filesystem_and_info_txt_match_jax_package():
    from eeg_dataanalysispackage_tpu.io import sources as jax_sources

    text = "# comment\n\na.eeg 2\nb.eeg 3 extra\nsingle\ntrailing \na.eeg 5\n"
    assert sources.parse_info_txt(text) == jax_sources.parse_info_txt(text)
    assert list(sources.parse_info_txt(text).items()) == [("a.eeg", 5), ("b.eeg", 3)]
    assert provider.parse_info_txt is sources.parse_info_txt
    with pytest.raises(ValueError, match="improper number format"):
        sources.parse_info_txt("a.eeg x\n")
    fs = sources.InMemoryFileSystem({"/i.txt": b"a.eeg 2\n"})
    assert fs.exists("/i.txt") and not fs.exists("/j.txt")
    assert fs.read_text("/i.txt") == "a.eeg 2\n" and fs.size("/i.txt") == 8
    fs.write_bytes("/j.txt", b"x")
    assert fs.read_bytes("/j.txt") == b"x"


# -- end to end over a served session --------------------------------------


def test_provider_over_http_matches_local_and_jax_package(server, session):
    base, store = server
    _serve_session(store, session)
    url = f"{base}/data/infoTrain.txt"
    before = obs.metrics.snapshot()["counters"].get("ingest.file_reads", 0)
    got = provider.OfflineDataProvider([url], filesystem=_fs(base, chunk_size=1 << 18),
                                       device="cpu").load()
    assert obs.metrics.snapshot()["counters"]["ingest.file_reads"] - before == 6
    local = provider.OfflineDataProvider([session], device="cpu").load()
    jax_batch = jax_provider.OfflineDataProvider([url]).load()
    assert got.epochs.shape[0] > 0
    np.testing.assert_array_equal(got.epochs, local.epochs)
    np.testing.assert_array_equal(got.targets, local.targets)
    np.testing.assert_array_equal(got.epochs, np.asarray(jax_batch.epochs))
    np.testing.assert_array_equal(got.targets, np.asarray(jax_batch.targets))


def test_fused_features_over_http_equal_local(server, session):
    """No explicit filesystem: the URI scheme routes, and the fused
    features are bit-equal to the local run's."""
    base, store = server
    _serve_session(store, session)
    feats, targets = provider.OfflineDataProvider(
        [f"{base}/data/infoTrain.txt"], device="cpu").load_features_device()
    want, want_t = provider.OfflineDataProvider([session], device="cpu").load_features_device()
    assert feats.shape[0] > 0
    assert feats.numpy().tobytes() == want.numpy().tobytes()
    np.testing.assert_array_equal(targets, want_t)


def test_provider_over_http_skips_missing_files(server, session, caplog):
    base, store = server
    _serve_session(store, session)
    store.files["/data/infoTrain.txt"] += b"missing/gone.eeg 3 1\n"
    with caplog.at_level("WARNING"):
        got = provider.OfflineDataProvider([f"{base}/data/infoTrain.txt"], filesystem=_fs(base),
                                           device="cpu").load()
    local = provider.OfflineDataProvider([session], device="cpu").load()
    assert got.epochs.shape == local.epochs.shape  # the missing file skipped
    assert f"Did not load missing/gone.eeg: No related file found: {base}/data/missing/gone.vhdr" \
        in caplog.text


@pytest.mark.parametrize("fe", ["dwt-8", "dwt-8-fused"])
def test_pipeline_over_http_equals_local_and_jax_package(server, session, fe, tmp_path):
    """info_file=http://... through the query DSL: str(statistics) is
    byte-identical to the port's local run and to the JAX package's run
    over the same server; result_path is written locally."""
    base, store = server
    _serve_session(store, session)
    result_path = str(tmp_path / "result.txt")
    q = f"fe={fe}&train_clf=logreg"
    stats = PipelineBuilder(f"info_file={base}/data/infoTrain.txt&{q}&result_path={result_path}",
                            device="cpu").execute()
    local = PipelineBuilder(f"info_file={session}&{q}", device="cpu").execute()
    jax = JaxBuilder(f"info_file={base}/data/infoTrain.txt&{q}").execute()
    assert str(stats) == str(local) == str(jax)
    assert open(result_path).read() == str(stats) + "\n"


def test_eeg_file_over_http(server, session):
    base, store = server
    _serve_session(store, session)
    q = "guessed_num=2&fe=dwt-8-fused&train_clf=logreg"
    got = PipelineBuilder(f"eeg_file={base}/data/DoD/synth_01.eeg&{q}", device="cpu").execute()
    local = os.path.join(os.path.dirname(session), "DoD", "synth_01.eeg")
    assert str(got) == str(PipelineBuilder(f"eeg_file={local}&{q}", device="cpu").execute())


def _trained(cls):
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(40, 48).astype(np.float32))
    clf = cls()
    clf.set_config({})
    clf.fit(feats, (feats[:, 0] > 0).float())
    return clf


@pytest.mark.parametrize("cls", [LogisticRegressionClassifier, SVMClassifier])
def test_model_save_load_over_http(server, cls):
    """Classifier save/load routes through the remote filesystem for URI
    paths (the reference persists models on HDFS —
    LogisticRegressionClassifier.java:144-152); the bytes are the JAX
    package's format."""
    from eeg_dataanalysispackage_tpu.models import linear as jax_linear

    base, store = server
    clf = _trained(cls)
    clf.save(f"{base}/models/m")
    assert "/models/m.npz" in store.files
    clf2 = cls()
    clf2.load(f"{base}/models/m")
    want = clf.model.weight.numpy()
    np.testing.assert_array_equal(clf2.model.weight.numpy(), want)
    jax_clf = getattr(jax_linear, cls.__name__)()
    jax_clf.load(f"{base}/models/m")
    np.testing.assert_array_equal(np.asarray(jax_clf.weights), want)


def test_model_load_missing_remote_raises(server):
    base, _ = server
    with pytest.raises(FileNotFoundError):
        LogisticRegressionClassifier().load(f"{base}/models/nope")


def test_pipeline_save_load_model_over_http(server, session, tmp_path):
    """save_clf/load_clf with an http:// save_name through the query DSL:
    the model the port trains persists to the object store, and the JAX
    package and the port both load it back to the same statistics."""
    base, store = server
    _serve_session(store, session)
    model_uri = f"{base}/models/pipeline-logreg"
    info = f"info_file={base}/data/infoTrain.txt&fe=dwt-8-fused"
    PipelineBuilder(f"{info}&train_clf=logreg&save_clf=true&save_name={model_uri}",
                    device="cpu").execute()
    assert "/models/pipeline-logreg.npz" in store.files
    load = f"{info}&load_clf=logreg&load_name={model_uri}"
    stats = PipelineBuilder(load, device="cpu").execute()
    assert stats.num_patterns > 0
    assert str(stats) == str(JaxBuilder(load).execute())


def test_retry_policy_full_jitter_opt_in():
    """Full jitter is opt-in; with it off the schedule equals the JAX
    package's."""
    deterministic = remote.RetryPolicy(backoff_s=0.5, max_backoff_s=4.0)
    twin = jax_remote.RetryPolicy(backoff_s=0.5, max_backoff_s=4.0)
    assert [deterministic.sleep_for(a) for a in range(6)] == [0.5, 1.0, 2.0, 4.0, 4.0, 4.0]
    assert [deterministic.sleep_for(a) for a in range(6)] == [twin.sleep_for(a) for a in range(6)]
    jittered = remote.RetryPolicy(backoff_s=0.5, max_backoff_s=4.0, jitter="full")
    waits = [jittered.sleep_for(2) for _ in range(50)]
    assert all(0.0 <= w <= 2.0 for w in waits)
    assert len(set(waits)) > 1
    with pytest.raises(ValueError, match="jitter"):
        remote.RetryPolicy(jitter="half")


# -- deadline-aware retries ---------------------------------------------------


def test_retry_stops_when_deadline_cannot_cover_backoff(server):
    """With an ambient deadline that cannot cover the next backoff, the
    ladder aborts now with the attempt history instead of sleeping."""
    base, store = server
    store.files["/dead.bin"] = b"x"
    store.fail_next = 99
    fs = remote.HttpFileSystem(
        base_url=base, retry=remote.RetryPolicy(max_attempts=4, timeout_s=5.0, backoff_s=30.0))
    n_before = len(store.requests)
    t0 = time.monotonic()
    with deadline.deadline_scope(deadline.Deadline(0.2)):
        with pytest.raises(remote.RemoteIOError,
                           match=r"aborted after 1/4 attempts.*deadline budget") as ei:
            fs.read_bytes(f"{base}/dead.bin")
    assert time.monotonic() - t0 < 5.0
    assert "attempt 1: RemoteIOError" in str(ei.value)
    assert len(store.requests) - n_before == 1


def test_spent_deadline_refuses_the_first_attempt(server):
    base, store = server
    store.files["/a.bin"] = b"x"
    n_before = len(store.requests)
    with deadline.deadline_scope(deadline.Deadline(0.0)):
        with pytest.raises(remote.RemoteIOError, match="not attempted"):
            _fs(base).read_bytes(f"{base}/a.bin")
    assert len(store.requests) == n_before  # nothing hit the wire


def test_no_deadline_scope_keeps_classic_retry_behavior(server):
    base, store = server
    store.files["/flaky.bin"] = b"x" * 10
    store.fail_next = 2
    assert _fs(base).read_bytes(f"{base}/flaky.bin") == b"x" * 10


def test_deadline_nesting_tightest_wins():
    class Clock:
        now = 0.0

        def __call__(self):
            return self.now

    clock = Clock()
    outer = deadline.Deadline(10.0, clock=clock)
    inner = deadline.Deadline(1.0, clock=clock)
    assert deadline.active_deadline() is None
    with deadline.deadline_scope(outer):
        assert deadline.active_deadline() is outer
        with deadline.deadline_scope(inner):
            assert deadline.active_deadline() is inner
            assert deadline.active_deadline().can_cover(0.5)
            assert not deadline.active_deadline().can_cover(2.0)
        assert deadline.active_deadline() is outer
    with deadline.deadline_scope(None):
        assert deadline.active_deadline() is None
    assert deadline.active_deadline() is None
    clock.now = 1.5
    assert inner.expired and not outer.expired
    with pytest.raises(deadline.DeadlineExceededError):
        inner.raise_if_expired("probe")


def test_cond_wait_honours_the_ambient_deadline():
    import threading

    class Clock:
        now = 0.0

        def __call__(self):
            return self.now

    clock = Clock()
    cond = threading.Condition()
    calls = []

    def predicate():
        calls.append(1)
        clock.now += 1.0  # each check spends a second of the budget
        return False

    with cond, deadline.deadline_scope(deadline.Deadline(2.5, clock=clock)):
        with pytest.raises(deadline.DeadlineExceededError, match="waiting"):
            deadline.cond_wait(cond, predicate, "waiting", slice_s=0.001)
    assert len(calls) == 3
    with cond:
        deadline.cond_wait(cond, lambda: True, "ready")  # no scope, already true


def test_spent_deadline_does_not_leak_the_half_open_probe_slot(server):
    """The spent-budget fast-fail runs before breaker.allow(): a hurried
    caller must not claim the half-open probe slot and leave the breaker
    unable to probe again."""
    base, store = server
    store.files["/x.bin"] = b"alive"
    cb = circuit.breaker_for(base)
    cb.threshold, cb.cooldown_s = 1, 0.05
    cb.record_failure(IOError("down"))
    assert cb.state == circuit.OPEN
    time.sleep(0.06)  # the cooldown elapsed: the probe window is open
    with deadline.deadline_scope(deadline.Deadline(0.0)):
        with pytest.raises(remote.RemoteIOError, match="not attempted"):
            _fs(base).read_bytes(f"{base}/x.bin")
    assert _fs(base).read_bytes(f"{base}/x.bin") == b"alive"
    assert cb.state == circuit.CLOSED
