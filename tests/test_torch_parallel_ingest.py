"""The port's ordered parse pool (``io/provider.py``) against the JAX
package's, as its ``tests/test_parallel_ingest.py`` holds its own.

Pool sizes 1, 2 and 4 give the same host batches and the same fused
features, bit for bit; the batches equal the JAX package's bit for bit
and the fused features within the fused rung's tolerance (1e-6, as
``tests/test_torch_pipeline.py``). Missing siblings are skipped, a parse
error surfaces at its file's place, the env and query knobs reach the
provider, a fault plan clamps the pool to 1. The remote filesystems keep
one keep-alive connection per thread, so one instance serves the pool:
three recordings on the loopback store at ``ingest_workers=4`` give the
sequential run's statistics byte for byte. The JAX package's runs here
read local files only (its shared connections are ROADMAP.md C12).
"""

import logging
import os
import sys
import threading
import time

import numpy as np
import pytest

from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import circuit, provider, remote, sources
from eeg_dataanalysispackage_tpu_torch.obs import chaos, events
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _loopback  # noqa: E402
import _synthetic  # noqa: E402

POOLS = (1, 2, 4)


def _session(directory, n_files=3, n_markers=40, missing=0):
    lines = []
    for i in range(n_files):
        name = f"synth_{i:02d}"
        guessed = 2 + (i % 7)
        _synthetic.write_recording(str(directory), name=name, n_markers=n_markers,
                                   guessed=guessed, seed=i)
        lines.append(f"{name}.eeg {guessed}")
    for i in range(missing):
        lines.insert(1, f"ghost_{i}.eeg 4")  # listed, absent: skipped
    info = os.path.join(str(directory), "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    return _session(tmp_path_factory.mktemp("pool_session"))


@pytest.fixture(scope="module")
def jax_batch(session):
    return jax_provider.OfflineDataProvider([session], workers=1).load()


@pytest.mark.parametrize("workers", POOLS)
def test_pool_sizes_give_the_jax_packages_batch(session, jax_batch, workers):
    b = provider.OfflineDataProvider([session], device="cpu", workers=workers).load()
    np.testing.assert_array_equal(b.epochs, jax_batch.epochs)
    np.testing.assert_array_equal(b.targets, jax_batch.targets)
    np.testing.assert_array_equal(b.stimulus_indices, jax_batch.stimulus_indices)


@pytest.fixture(scope="module")
def serial_features(session):
    feats, targets = provider.OfflineDataProvider([session], device="cpu",
                                                  workers=1).load_features_device()
    want, want_targets = jax_provider.OfflineDataProvider([session]).load_features_device(
        backend="decode")
    np.testing.assert_array_equal(targets, want_targets)
    np.testing.assert_allclose(feats.numpy(), want, rtol=0, atol=1e-6)
    return feats, targets


@pytest.mark.parametrize("workers", POOLS[1:])
def test_pool_sizes_give_identical_fused_features(session, serial_features, workers):
    feats, targets = provider.OfflineDataProvider([session], device="cpu",
                                                  workers=workers).load_features_device()
    assert np.array_equal(feats.numpy(), serial_features[0].numpy())
    np.testing.assert_array_equal(targets, serial_features[1])


def test_missing_siblings_are_skipped_in_the_pool(tmp_path, caplog):
    info = _session(tmp_path, n_files=3, missing=2)
    with caplog.at_level(logging.WARNING, logger="eeg_dataanalysispackage_tpu_torch.io.provider"):
        b4 = provider.OfflineDataProvider([info], device="cpu", workers=4).load()
    assert caplog.text.count("Did not load") == 2
    b1 = jax_provider.OfflineDataProvider([info], workers=1).load()
    np.testing.assert_array_equal(b1.epochs, b4.epochs)
    np.testing.assert_array_equal(b1.targets, b4.targets)


def test_a_parse_error_surfaces_in_order(tmp_path):
    info = _session(tmp_path, n_files=3, n_markers=10)
    with open(str(tmp_path / "synth_01.vhdr"), "w") as f:
        f.write("[Binary Infos]\nBinaryFormat=NO_SUCH_FORMAT\n")
    seen = []
    odp = provider.OfflineDataProvider([info], device="cpu", workers=4)
    with pytest.raises(ValueError, match="Unsupported BinaryFormat"):
        for rel_path, _guessed, _rec in odp.iter_recordings():
            seen.append(rel_path)
    assert seen == ["synth_00.eeg"]


class _SlowTail(sources.LocalFileSystem):
    """Reads of the files after the broken one take a while, so they are
    still running when the broken parse fails."""

    def read_bytes(self, path):
        if "synth_00" not in path and "synth_01" not in path:
            time.sleep(0.3)
        return super().read_bytes(path)


def _ingest_threads():
    return [t for t in threading.enumerate() if t.name.startswith("eeg-tpu-ingest")]


def test_a_failed_pooled_run_leaves_no_parse_running(tmp_path, session):
    """A parse error waits for the pool's running parses before it
    propagates: no ``eeg-tpu-ingest`` thread outlives the failed run, and
    the next run's metrics scope counts only its own file reads."""
    info = _session(tmp_path, n_files=6, n_markers=10)
    with open(str(tmp_path / "synth_01.vhdr"), "w") as f:
        f.write("[Binary Infos]\nBinaryFormat=NO_SUCH_FORMAT\n")
    odp = provider.OfflineDataProvider([info], device="cpu", workers=4, filesystem=_SlowTail())
    with pytest.raises(ValueError, match="Unsupported BinaryFormat"):
        list(odp.iter_recordings())
    assert _ingest_threads() == []
    with obs.metrics.scope() as m:
        list(provider.OfflineDataProvider([session], device="cpu", workers=4).iter_recordings())
    assert m.snapshot()["counters"]["ingest.file_reads"] == 9
    assert _ingest_threads() == []


def test_the_pool_is_counted_and_traced(session):
    recorder = events.SpanRecorder("pool")
    with obs.metrics.scope() as m, events.recording(recorder):
        list(provider.OfflineDataProvider([session], device="cpu", workers=4).iter_recordings())
    snap = m.snapshot()
    assert snap["gauges"]["ingest.parallel_workers"] == 3  # min(workers, files)
    assert snap["counters"]["ingest.files_parsed"] == 3
    assert snap["counters"]["ingest.file_reads"] == 9
    parses = [s for s in recorder.spans() if s["name"] == "ingest.parse"]
    assert len(parses) == 3 and all(s["attrs"]["pooled"] for s in parses)
    assert all(s["thread"].startswith("eeg-tpu-ingest") for s in parses)


def test_a_pool_wider_than_the_cores_under_a_short_switch_interval(tmp_path):
    """More workers than cores and a 10 us switch interval: the ordered
    merge and the shared counters lose nothing (every file read counted
    once, the batch the pool of one's), within a bounded time."""
    n = min((os.cpu_count() or 1) + 4, 20)
    info = _session(tmp_path, n_files=n, n_markers=12)
    want = provider.OfflineDataProvider([info], device="cpu", workers=1).load()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with obs.metrics.scope() as m:
            got = provider.OfflineDataProvider([info], device="cpu", workers=n,
                                               prefetch_depth=1).load()
    finally:
        sys.setswitchinterval(interval)
    assert m.snapshot()["gauges"]["ingest.parallel_workers"] == n
    assert m.snapshot()["counters"]["ingest.file_reads"] == 3 * n
    assert m.snapshot()["counters"]["ingest.files_parsed"] == n
    np.testing.assert_array_equal(got.epochs, want.epochs)
    np.testing.assert_array_equal(got.targets, want.targets)


def test_worker_and_depth_configuration(monkeypatch):
    monkeypatch.setenv(provider.ENV_INGEST_WORKERS, "7")
    assert provider.default_ingest_workers() == jax_provider.default_ingest_workers() == 7
    monkeypatch.setenv(provider.ENV_INGEST_WORKERS, "garbage")
    assert provider.default_ingest_workers() == jax_provider.default_ingest_workers() == 4
    monkeypatch.delenv(provider.ENV_INGEST_WORKERS)
    assert provider.default_ingest_workers() == min(4, os.cpu_count() or 1)
    monkeypatch.setenv(provider.ENV_PREFETCH_DEPTH, "5")
    odp = provider.OfflineDataProvider(["x.txt"], device="cpu")
    assert (odp._workers, odp._prefetch_depth) == (min(4, os.cpu_count() or 1), 5)
    monkeypatch.setenv(provider.ENV_PREFETCH_DEPTH, "bad")
    odp = provider.OfflineDataProvider(["x.txt"], device="cpu", workers=3, prefetch_depth=0)
    assert (odp._workers, odp._prefetch_depth) == (3, 1)
    assert provider.default_prefetch_depth() == 2


def test_a_fault_plan_clamps_the_pool_to_one():
    odp = provider.OfflineDataProvider(["x.txt"], device="cpu", workers=8)
    assert odp._resolved_workers(8) == 8 and odp._resolved_workers(3) == 3
    with chaos.faults("remote.request:p=0.5", seed=1):
        assert odp._resolved_workers(8) == 1
    assert odp._resolved_workers(8) == 8


def test_the_query_keys_reach_the_provider(session, monkeypatch):
    """ingest_workers= and prefetch= size the run's pool (the batch path
    ignored both before the pool was ported)."""
    made = []

    class Spy(provider.OfflineDataProvider):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append((self._workers, self._prefetch_depth))

    monkeypatch.setattr(provider, "OfflineDataProvider", Spy)
    q = f"info_file={session}&fe=dwt-8-fused&train_clf=logreg&cache=false"
    want = str(PipelineBuilder(q + "&ingest_workers=1", device="cpu").execute())
    got = str(PipelineBuilder(q + "&ingest_workers=3&prefetch=2", device="cpu").execute())
    assert made == [(1, provider.default_prefetch_depth()), (3, 2)]
    assert got == want


@pytest.mark.parametrize("key", ["ingest_workers", "prefetch"])
def test_a_malformed_knob_raises_the_jax_packages_message(session, key):
    q = f"info_file={session}&fe=dwt-8-fused&train_clf=logreg&{key}=many"
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(q)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value)


# -- the remote filesystems under the pool ----------------------------------


@pytest.fixture(scope="module")
def loopback(tmp_path_factory):
    with _loopback.Server() as srv:
        srv.store.add_tree(os.path.dirname(_session(tmp_path_factory.mktemp("remote_pool"))),
                           "/data")
        circuit.reset()
        yield srv
        circuit.reset()


def test_each_thread_gets_its_own_connection(loopback):
    """One HttpFileSystem across threads: a keep-alive connection per
    thread (reused within it), so concurrent reads never share one
    ``http.client`` connection."""
    fs = remote.HttpFileSystem(base_url=loopback.base)
    scheme, netloc, _ = fs._split("/data/info.txt")
    conns, ok = {}, []
    barrier = threading.Barrier(4)

    def work(i):
        barrier.wait(timeout=10)
        first = fs._connect(scheme, netloc)
        for _ in range(5):
            ok.append(fs.read_bytes("/data/synth_00.vhdr") == loopback.store.files[
                "/data/synth_00.vhdr"])
        conns[i] = (first, fs._connect(scheme, netloc))

    recorder = events.SpanRecorder("threads")
    with events.recording(recorder):
        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(ok) == 20 and all(ok)
    assert len({id(first) for first, _ in conns.values()}) == 4
    assert all(first is last for first, last in conns.values())  # reused in its thread
    assert not [e for e in recorder.recent_events() if e["name"] == "remote.retry"]


@pytest.mark.parametrize("scheme", ["http", "hdfs"])
def test_remote_pool_of_four_equals_the_sequential_run(loopback, scheme):
    """Three recordings over the loopback store (the object store and the
    WebHDFS namenode) at ingest_workers=4, the pool on (no
    EEG_TPU_INGEST_WORKERS pin): statistics byte-equal to the sequential
    run, with no retry."""
    base = loopback.base if scheme == "http" else f"hdfs://{loopback.authority}"
    q = f"info_file={base}/data/info.txt&fe=dwt-8-fused&train_clf=logreg&cache=false"
    sequential = str(PipelineBuilder(q + "&ingest_workers=1", device="cpu").execute())
    recorder = events.SpanRecorder("remote_pool")
    with events.recording(recorder), obs.metrics.scope() as m:
        pooled = str(PipelineBuilder(q + "&ingest_workers=4", device="cpu").execute())
    assert pooled == sequential
    assert m.snapshot()["gauges"]["ingest.parallel_workers"] == 3
    assert not [e for e in recorder.recent_events() if e["name"] == "remote.retry"]


def test_a_filesystem_handed_in_serves_the_pool(loopback, session, serial_features):
    fs = remote.HttpFileSystem(base_url=loopback.base)
    feats, targets = provider.OfflineDataProvider(
        ["/data/info.txt"], filesystem=fs, device="cpu", workers=4).load_features_device()
    assert np.array_equal(feats.numpy(), serial_features[0].numpy())
    np.testing.assert_array_equal(targets, serial_features[1])
