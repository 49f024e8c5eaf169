"""The port's feature cache (``io/feature_cache.py``), its provider pieces
and the precision-gate memo against the JAX package's.

- The fused run key (f32 and int8 precision classes), the seizure key
  and the content digests equal the JAX package's on the same session.
- An entry either package writes is a hit for the other, with the
  writer's statistics.
- A hit's statistics are byte-equal to the miss's, and a hit runs no
  featurizer (the fused kernel's wrapper, the seizure extractor);
  ``cache=false`` runs it again. The hit's rows are the miss's, on the
  run's device in the miss's dtype.
- ``EEG_TPU_NO_FEATURE_CACHE``, ``EEG_TPU_FEATURE_CACHE_DIR`` and the
  default directory resolve as in the JAX package; a corrupt entry is a
  miss; the single flight holds in process and across processes.
- The gate memo replays a decision (``cached: True``) for the same
  content only.

Every test points the cache at its own directory (the conftest turns the
cache off for every other test).
"""

import os
import sys
import threading

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.features import registry as jax_fe_registry
from eeg_dataanalysispackage_tpu.io import feature_cache as jax_cache
from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu_torch.features import registry as fe_registry
from eeg_dataanalysispackage_tpu_torch.features import subband
from eeg_dataanalysispackage_tpu_torch.io import feature_cache, provider
from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

LINEAR = "config_num_iterations=30&config_step_size=1.0&config_mini_batch_fraction=1.0"
SEIZURE_FE = "dwt-4:level=4:stats=energy,std"


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    return _synthetic.write_session(str(tmp_path_factory.mktemp("cache_session")),
                                    n_markers=60)


@pytest.fixture(scope="module")
def seizure_info(tmp_path_factory):
    return _synthetic.write_seizure_session(str(tmp_path_factory.mktemp("cache_seizure")),
                                            n_files=2, n_samples=20000)


@pytest.fixture()
def cache_dir(tmp_path, monkeypatch):
    """The cache on, in a fresh directory of the test's own."""
    d = str(tmp_path / "feature-cache")
    monkeypatch.delenv("EEG_TPU_NO_FEATURE_CACHE", raising=False)
    monkeypatch.setenv("EEG_TPU_FEATURE_CACHE_DIR", d)
    return d


@pytest.fixture()
def featurizer_calls(monkeypatch):
    """Counts calls of the fused kernel's featurizer and of the subband
    extractor: what a hit must not run."""
    calls = {"fused": 0, "seizure": 0}
    make = ingest_cuda.make_cuda_ingest_featurizer

    def counting_make(*args, **kwargs):
        featurize = make(*args, **kwargs)

        def counted(*a, **k):
            calls["fused"] += 1
            return featurize(*a, **k)
        return counted

    extract = subband.SubbandWaveletFeatures.extract_batch

    def counted_extract(self, epochs):
        calls["seizure"] += 1
        return extract(self, epochs)

    monkeypatch.setattr(ingest_cuda, "make_cuda_ingest_featurizer", counting_make)
    monkeypatch.setattr(subband.SubbandWaveletFeatures, "extract_batch", counted_extract)
    return calls


def _run(query):
    b = PipelineBuilder(query, device="cpu")
    b.execute()
    return b


# -- keys -------------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_fused_run_key_equals_jax(info, precision):
    ours = provider.OfflineDataProvider([info], device="cpu").prepare_fused_run(
        provider.fused_extractor_id(8, precision))
    theirs = jax_provider.OfflineDataProvider([info]).prepare_fused_run(
        jax_provider.fused_extractor_id(8, precision))
    assert provider.fused_extractor_id(8, precision) == jax_provider.fused_extractor_id(
        8, precision)
    assert ours.key == theirs.key and ours.digests == theirs.digests
    assert [r[:2] for r in ours.recordings] == [r[:2] for r in theirs.recordings]
    assert (provider.OfflineDataProvider([info], device="cpu").content_digests()
            == jax_provider.OfflineDataProvider([info]).content_digests())
    odp = provider.OfflineDataProvider([info], device="cpu")
    assert odp.run_key_for(ours, ("other", 1)) == jax_provider.OfflineDataProvider(
        [info]).run_key_for(theirs, ("other", 1))


def test_seizure_key_equals_jax(seizure_info):
    """The seizure path's key, ``("seizure", fe.cache_id(), window,
    stride, label_overlap)`` over the one read pass."""
    fe, jax_fe = fe_registry.create(SEIZURE_FE, device="cpu"), jax_fe_registry.create(SEIZURE_FE)
    assert fe.cache_id() == jax_fe.cache_id()
    ours = provider.OfflineDataProvider([seizure_info], device="cpu").prepare_run(
        ("seizure", fe.cache_id(), 512, 256, 0.5))
    theirs = jax_provider.OfflineDataProvider([seizure_info]).prepare_run(
        ("seizure", jax_fe.cache_id(), 512, 256, 0.5))
    assert ours.key == theirs.key


# -- hits and misses --------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_hit_equals_miss_and_skips_the_featurizer(info, cache_dir, featurizer_calls, precision):
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}&precision={precision}"
    miss = _run(q)
    assert miss.backend_resolved == {"requested": "decode", "landed": "decode"}
    launched = featurizer_calls["fused"]
    assert launched >= 1
    hit = _run(q)
    assert hit.backend_resolved["landed"] == "cache"
    assert featurizer_calls["fused"] == launched  # no featurizer, no gate
    assert str(hit.statistics) == str(miss.statistics)
    assert hit.features.dtype == miss.features.dtype == torch.float32
    assert hit.features.device == miss.features.device
    assert torch.equal(hit.features, miss.features)
    np.testing.assert_array_equal(hit.targets, miss.targets)
    if precision != "f32":
        assert hit.precision_resolved == {"requested": precision, "used": precision,
                                          "gate": {"source": "cache"}}
    off = _run(q + "&cache=false")
    assert off.backend_resolved["landed"] == "decode"
    assert featurizer_calls["fused"] > launched
    assert str(off.statistics) == str(miss.statistics)
    assert len(os.listdir(cache_dir)) == 1  # one entry, stored once


def test_seizure_hit_equals_miss_and_skips_the_extractor(seizure_info, cache_dir,
                                                         featurizer_calls):
    q = (f"info_file={seizure_info}&task=seizure&fe={SEIZURE_FE}&train_clf=logreg"
         f"&{LINEAR}")
    miss = _run(q)
    assert featurizer_calls["seizure"] == 1
    hit = _run(q)
    assert featurizer_calls["seizure"] == 1
    assert str(hit.statistics) == str(miss.statistics)
    assert hit.features.dtype == miss.features.dtype
    assert torch.equal(hit.features, miss.features)
    _run(q + "&cache=false")
    assert featurizer_calls["seizure"] == 2


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_entries_are_shared_with_jax(info, cache_dir, writer):
    """An entry written by one package is a hit for the other, which then
    reports the writer's statistics."""
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}"
    jax_cache.reset_stats()
    if writer == "jax":
        want = str(JaxBuilder(q).execute())
        got = _run(q)
        assert got.backend_resolved["landed"] == "cache"
        assert str(got.statistics) == want
    else:
        want = str(_run(q).statistics)
        assert str(JaxBuilder(q).execute()) == want
        assert jax_cache.stats()["hits"] == 1
    assert len(os.listdir(cache_dir)) == 1


def test_seizure_entries_are_shared_with_jax(seizure_info, cache_dir, featurizer_calls):
    q = (f"info_file={seizure_info}&task=seizure&fe={SEIZURE_FE}&train_clf=logreg"
         f"&{LINEAR}")
    want = str(JaxBuilder(q).execute())
    assert str(_run(q).statistics) == want
    assert featurizer_calls["seizure"] == 0


# -- configuration and robustness ------------------------------------------------------


def test_env_knobs_resolve_as_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    monkeypatch.delenv("EEG_TPU_FEATURE_CACHE_DIR", raising=False)
    monkeypatch.delenv("EEG_TPU_NO_FEATURE_CACHE", raising=False)
    assert feature_cache.default_cache_dir() == jax_cache.default_cache_dir() == str(
        tmp_path / "xdg" / "eeg-tpu" / "feature-cache")
    assert feature_cache.open_cache().directory == feature_cache.default_cache_dir()
    monkeypatch.setenv("EEG_TPU_FEATURE_CACHE_DIR", str(tmp_path / "env"))
    assert feature_cache.open_cache().directory == str(tmp_path / "env")
    assert feature_cache.resolve_cache_dir("x") == jax_cache.resolve_cache_dir("x") == "x"
    monkeypatch.setenv("EEG_TPU_NO_FEATURE_CACHE", "1")
    assert feature_cache.open_cache() is None and jax_cache.open_cache() is None


def test_disabled_cache_stores_nothing(info, tmp_path, monkeypatch, featurizer_calls):
    monkeypatch.setenv("EEG_TPU_NO_FEATURE_CACHE", "1")
    monkeypatch.setenv("EEG_TPU_FEATURE_CACHE_DIR", str(tmp_path / "never"))
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}"
    _run(q)
    _run(q)
    assert featurizer_calls["fused"] == 2 and not os.path.exists(tmp_path / "never")


def test_corrupt_entry_is_a_miss_and_is_rebuilt(info, cache_dir):
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}"
    want = str(_run(q).statistics)
    (entry,) = os.listdir(cache_dir)
    with open(os.path.join(cache_dir, entry), "wb") as f:
        f.write(b"not a zip")
    feature_cache.reset_stats()
    again = _run(q)
    assert again.backend_resolved["landed"] == "decode" and str(again.statistics) == want
    assert feature_cache.stats()["corrupt"] == 1
    assert _run(q).backend_resolved["landed"] == "cache"


def test_single_flight_in_process_and_across_processes(tmp_path, monkeypatch):
    """A second builder of a key waits for the first's store, then hits;
    a foreign process's live lock is waited on until it times out."""
    cache = feature_cache.FeatureCache(str(tmp_path / "c"))
    features, targets = np.ones((3, 2), np.float32), np.zeros(3)
    slot = cache.begin_build("k")
    order = []

    def follower():
        s = cache.begin_build("k")
        order.append(("waited", s.waited, cache.lookup("k") is not None))
        s.release()

    t = threading.Thread(target=follower)
    t.start()
    cache.store("k", features, targets)
    order.append("stored")
    slot.release()
    t.join(10)
    assert order == ["stored", ("waited", True, True)]
    # a foreign process's fresh lock file: waited on, then passed
    monkeypatch.setenv("EEG_TPU_CACHE_LOCK_TIMEOUT_S", "0.2")
    with open(cache._lock_path_for("j"), "w") as f:
        f.write("1")
    feature_cache.reset_stats()
    s = cache.begin_build("j")
    assert feature_cache.stats()["cross_process_waits"] == 1
    s.release()
    assert cache.try_begin_build("j") is not None


# -- the gate memo ------------------------------------------------------------------------


def test_gate_memo_replays_for_the_same_content_only(info, tmp_path, featurizer_calls):
    """``cache=false`` still memoizes the gate under the first
    recording's content digest: a re-run replays the decision without
    featurizing twice, and another recording's run gates afresh."""
    provider.reset_gate_memo()
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}&precision=int8&cache=false"
    first = _run(q)
    assert first.precision_resolved["gate"]["cached"] is False
    calls = featurizer_calls["fused"]
    second = _run(q)
    gate = second.precision_resolved["gate"]
    assert gate["cached"] is True and gate["gate_seconds"] == 0.0
    assert {k: v for k, v in gate.items() if k not in ("cached", "gate_seconds")} == {
        k: v for k, v in first.precision_resolved["gate"].items()
        if k not in ("cached", "gate_seconds")}
    assert featurizer_calls["fused"] == calls + 1  # the run's own launch only
    assert str(second.statistics) == str(first.statistics)
    os.makedirs(tmp_path / "other")
    other = _synthetic.write_session(str(tmp_path / "other"), n_markers=60, seed=11)
    assert _run(q.replace(info, other)).precision_resolved["gate"]["cached"] is False
