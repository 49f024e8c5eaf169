"""The port's plan cache (``ops/plan_cache.py``) and its memo of the
ingest planner against the JAX package's.

- The named LRU: hits, misses, eviction at ``EEG_TPU_PLAN_CACHE_SIZE``,
  the content digest equal to the JAX package's.
- ``device_ingest.plan_ingest`` under the memo: plans equal to the JAX
  package's planner over a session's recordings, with one balance state
  across files; a repeat pass replays every plan (hits) and leaves the
  balance counters where a fresh scan leaves them; entries are host
  numpy.
- A repeated fused run counts its plans as hits in ``obs/report``'s
  ``caches.plan_cache``.
- The cross-process file (``EEG_TPU_PLAN_CACHE_FILE``, ``save_file`` /
  ``load_file``): a round trip carries each cache's capacity and replays
  the plans as hits; a missing, corrupt or foreign file loads 0 entries;
  a file the JAX package wrote loads 0 entries and imports nothing of it.
"""

import os
import pickle
import sys

import numpy as np
import pytest

from eeg_dataanalysispackage_tpu.epochs.extractor import BalanceState as JaxBalance
from eeg_dataanalysispackage_tpu.io import brainvision as jax_bv
from eeg_dataanalysispackage_tpu.ops import device_ingest as jax_device_ingest
from eeg_dataanalysispackage_tpu.ops import plan_cache as jax_plan_cache
from eeg_dataanalysispackage_tpu_torch.epochs.extractor import BalanceState
from eeg_dataanalysispackage_tpu_torch.io import brainvision
from eeg_dataanalysispackage_tpu_torch.ops import device_ingest, plan_cache
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("plan_session"))
    paths = [_synthetic.write_recording(d, name=f"synth_{i}", n_markers=50 + 7 * i, seed=i)
             for i in range(3)]
    with open(os.path.join(d, "info.txt"), "w") as f:
        f.writelines(f"synth_{i}.eeg 2\n" for i in range(3))
    return os.path.join(d, "info.txt"), paths


def test_named_lru_counts_and_evicts_like_jax(monkeypatch):
    monkeypatch.setenv("EEG_TPU_PLAN_CACHE_SIZE", "2")
    for module in (plan_cache, jax_plan_cache):
        c = module.PlanCache("t")
        built = []
        for key in ("a", "b", "a", "c", "b"):
            c.get_or_build(key, lambda key=key: built.append(key) or key.upper())
        assert built == ["a", "b", "c", "b"]  # "b" was evicted by "c"
        assert c.stats() == {"hits": 1, "misses": 4, "entries": 2}
        c.clear()
        assert c.stats() == {"hits": 0, "misses": 0, "entries": 0}
    arrays = (np.arange(5, dtype=np.int64), np.ones(3, bool))
    assert plan_cache.digest(*arrays, extra=(1, "x")) == jax_plan_cache.digest(
        *arrays, extra=(1, "x"))
    assert plan_cache.digest(arrays[0]) != plan_cache.digest(arrays[0].astype(np.int32))


def test_memoized_plans_equal_jax_and_replay_the_balance(recordings):
    _info, paths = recordings
    plan_cache.clear()
    cache = plan_cache.cache("ingest_plan")

    def plan_pass(bv, planner, balance):
        out = []
        for p in paths:
            rec = bv.load_recording(p)
            out.append(planner(rec.markers, 2, rec.num_samples, balance=balance))
        return out, (balance.n_targets, balance.n_nontargets)

    first, counters = plan_pass(brainvision, device_ingest.plan_ingest, BalanceState())
    assert cache.stats()["misses"] == 3 and cache.stats()["hits"] == 0
    theirs, jax_counters = plan_pass(jax_bv, jax_device_ingest.plan_ingest, JaxBalance())
    again, counters_again = plan_pass(brainvision, device_ingest.plan_ingest, BalanceState())
    assert cache.stats() == {"hits": 3, "misses": 3, "entries": 3}
    assert counters == counters_again == jax_counters
    for a, b, c in zip(first, again, theirs):
        assert a is b  # the cached host plan itself
        for field in ("positions", "mask", "targets", "stimulus_indices"):
            assert isinstance(getattr(a, field), np.ndarray)
            np.testing.assert_array_equal(getattr(a, field), np.asarray(getattr(c, field)))
    # another entering balance state is another plan
    shifted = BalanceState()
    shifted.n_nontargets = 3
    rec = brainvision.load_recording(paths[0])
    other = device_ingest.plan_ingest(rec.markers, 2, rec.num_samples, balance=shifted)
    assert cache.stats()["misses"] == 4
    jax_shifted = JaxBalance()
    jax_shifted.n_nontargets = 3
    want = jax_device_ingest.plan_ingest(rec.markers, 2, rec.num_samples, balance=jax_shifted)
    np.testing.assert_array_equal(other.positions, np.asarray(want.positions))
    assert (shifted.n_targets, shifted.n_nontargets) == (jax_shifted.n_targets,
                                                         jax_shifted.n_nontargets)


def test_a_repeated_run_reports_plan_hits(recordings, tmp_path):
    info, _paths = recordings
    plan_cache.clear()
    q = f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&cache=false"
    first = PipelineBuilder(q, device="cpu")
    first.execute()
    second = PipelineBuilder(q + f"&report={tmp_path}", device="cpu")
    second.execute()
    import json

    with open(tmp_path / "run_report.json") as f:
        block = json.load(f)["caches"]["plan_cache"]
    assert block == {"hits": 3, "misses": 3}
    assert str(first.statistics) == str(second.statistics)


# -- the cross-process file -------------------------------------------------


def test_save_and_load_file_round_trip_with_the_capacity(recordings, tmp_path, monkeypatch):
    """A process saves its plans (and each cache's own capacity) and a
    process with empty caches warm-starts from the file: the planner
    replays the loaded plan as a hit, with the JAX package's arrays. The
    env name is the JAX package's."""
    _info, paths = recordings
    assert plan_cache.ENV_FILE == jax_plan_cache.ENV_FILE == "EEG_TPU_PLAN_CACHE_FILE"
    plan_cache.clear()
    small = plan_cache.cache("bounded_roundtrip", capacity=2)
    for key in ("a", "b", "c"):
        small.get_or_build(key, lambda key=key: np.full(3, ord(key)))
    rec = brainvision.load_recording(paths[0])
    plan = device_ingest.plan_ingest(rec.markers, 2, rec.num_samples, balance=BalanceState())
    path = str(tmp_path / "plans.pkl")
    monkeypatch.setenv(plan_cache.ENV_FILE, path)
    assert plan_cache.persist_path() == path and plan_cache.save_file() == path
    # a fresh process: every cache empty, the bounded one not made yet
    plan_cache.clear()
    monkeypatch.delitem(plan_cache._registry, "bounded_roundtrip")
    assert plan_cache.load_file() == 3  # two bounded entries and the plan
    restored = plan_cache.cache("bounded_roundtrip")
    assert restored.capacity == 2 and restored.stats() == {"hits": 0, "misses": 0, "entries": 2}
    again = device_ingest.plan_ingest(rec.markers, 2, rec.num_samples, balance=BalanceState())
    assert plan_cache.cache("ingest_plan").stats() == {"hits": 1, "misses": 0, "entries": 1}
    jax_plan = jax_device_ingest.plan_ingest(rec.markers, 2, rec.num_samples,
                                             balance=JaxBalance())
    for field in ("positions", "mask", "targets", "stimulus_indices"):
        np.testing.assert_array_equal(getattr(again, field), getattr(plan, field))
        np.testing.assert_array_equal(getattr(again, field), np.asarray(getattr(jax_plan, field)))


@pytest.mark.parametrize("content", [b"", b"not a pickle", b"\x80\x05K\x01.",
                                     pickle.dumps({"caches": {"x": {"entries": {"k": 1}}}}),
                                     None])
def test_a_missing_corrupt_or_foreign_file_loads_nothing(tmp_path, monkeypatch, content):
    monkeypatch.delenv(plan_cache.ENV_FILE, raising=False)
    assert plan_cache.persist_path() is None and plan_cache.load_file() == 0
    path = tmp_path / "plans.pkl"
    if content is not None:
        path.write_bytes(content)
    assert plan_cache.load_file(str(path)) == 0


_LOAD_JAX_FILE = """
import sys
from eeg_dataanalysispackage_tpu_torch.ops import plan_cache
n = plan_cache.load_file(sys.argv[1])
leaked = sorted(k for k in sys.modules if k.split(".")[0] == "eeg_dataanalysispackage_tpu")
print(n, leaked)
assert n == 0 and not leaked, (n, leaked)
"""


def test_a_jax_written_file_loads_nothing_and_imports_nothing_of_it(recordings, tmp_path):
    """The JAX package's file holds its own plan classes: the port's
    restricted unpickler refuses them before they are imported, so a
    fresh process loads 0 entries and has no JAX package module."""
    import subprocess

    _info, paths = recordings
    rec = jax_bv.load_recording(paths[0])
    jax_plan_cache.cache("ingest_plan_jax_file").get_or_build(
        "k", lambda: jax_device_ingest.plan_ingest(rec.markers, 2, rec.num_samples,
                                                   balance=JaxBalance()))
    path = jax_plan_cache.save_file(str(tmp_path / "jax_plans.pkl"))
    assert path is not None
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _LOAD_JAX_FILE, path], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert plan_cache.load_file(path) == 0
