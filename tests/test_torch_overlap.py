"""The port's overlapped fused ingest (``overlap=``, ``io/provider.py``
over ``io/staging.prefetch``) against the JAX package's, as its
``tests/test_overlap_ingest.py`` holds its own.

Overlap moves each recording's staging, planning and kernel launch onto
the staging producer's thread; it never changes a result: features and
targets are bit-equal on and off at prefetch depths 1, 2 and 5, the
statistics byte-equal to the serial run and to the JAX package's
overlapped run. ``EEG_TPU_OVERLAP=1`` is the process default, and a query
decides per run with the JAX package's grammar and message. The report's
``overlap`` key takes the JAX package's form. Where the JAX package steps
down its degradation ladder on a ``staging.producer`` fault, the port has
no ladder: the fault fails the run and leaves a crash report (ROADMAP.md
C, by design). On the card the producer's own CUDA stream and pinned
copies are held in ``tests/test_torch_cuda.py``.
"""

import json
import os
import sys

import numpy as np
import pytest

from eeg_dataanalysispackage_tpu.pipeline.builder import PipelineBuilder as JaxBuilder
from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan
from eeg_dataanalysispackage_tpu_torch import obs
from eeg_dataanalysispackage_tpu_torch.io import provider, staging
from eeg_dataanalysispackage_tpu_torch.obs import chaos
from eeg_dataanalysispackage_tpu_torch.pipeline.builder import PipelineBuilder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

LINEAR = "config_step_size=1.0&config_num_iterations=40&config_mini_batch_fraction=1.0"


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """Three recordings: overlap is about recording K+1 against K."""
    d = tmp_path_factory.mktemp("overlap_session")
    lines = []
    for i in range(3):
        name = f"ov_{i:02d}"
        _synthetic.write_recording(str(d), name=name, n_markers=60, guessed=2 + i, seed=i)
        lines.append(f"{name}.eeg {2 + i}")
    (d / "info.txt").write_text("\n".join(lines) + "\n")
    return str(d / "info.txt")


def _load(info, overlap, **kwargs):
    odp = provider.OfflineDataProvider([info], device="cpu")
    feats, targets = odp.load_features_device(overlap=overlap, **kwargs)
    return feats, targets, odp.timings


@pytest.fixture(scope="module")
def serial(session):
    return _load(session, overlap=False)


@pytest.mark.parametrize("depth", ["1", "2", "5"])
def test_overlap_features_are_bit_equal_at_every_depth(session, serial, monkeypatch, depth):
    monkeypatch.setenv(staging.ENV_PREFETCH_DEPTH, depth)
    feats, targets, timings = _load(session, overlap=True)
    assert np.array_equal(feats.numpy(), serial[0].numpy())
    assert np.array_equal(targets, serial[1])
    # the stages ran on two threads at once: the wall is reported beside them
    assert set(timings) == {"parse", "stage", "featurize", "wall"}
    assert set(serial[2]) == {"parse", "stage", "featurize"}


def test_the_env_default_turns_overlap_on(session, serial, monkeypatch):
    monkeypatch.setenv(provider.ENV_OVERLAP, "1")
    assert provider.default_overlap()
    with obs.metrics.scope() as m:
        feats, _t, _timings = _load(session, overlap=None)
    assert m.snapshot()["counters"]["ingest.overlap_runs"] == 1
    assert np.array_equal(feats.numpy(), serial[0].numpy())
    monkeypatch.setenv(provider.ENV_OVERLAP, "0")
    assert not provider.default_overlap()


def test_the_recordings_featurize_on_the_producer_thread(session, monkeypatch):
    from eeg_dataanalysispackage_tpu_torch.ops import device_ingest

    threads = []
    plan = device_ingest.plan_ingest

    def spy(*args, **kwargs):
        import threading

        threads.append(threading.current_thread().name)
        return plan(*args, **kwargs)

    monkeypatch.setattr(device_ingest, "plan_ingest", spy)
    _load(session, overlap=True)
    assert threads == ["eeg-tpu-prefetch"] * 3  # one planner thread, in order
    threads.clear()
    _load(session, overlap=False)
    assert threads == ["MainThread"] * 3


@pytest.fixture(scope="module")
def jax_overlapped(session):
    q = f"info_file={session}&fe=dwt-8-fused-decode&train_clf=logreg&{LINEAR}&cache=false"
    return str(JaxBuilder(q + "&overlap=true").execute())


@pytest.mark.parametrize("value", ["true", "false"])
def test_overlap_query_statistics_equal_the_jax_package(session, jax_overlapped, value):
    q = f"info_file={session}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}&cache=false"
    ours = PipelineBuilder(q + f"&overlap={value}", device="cpu")
    assert str(ours.execute()) == jax_overlapped
    assert ours.overlap_resolved is (value == "true")
    assert ("wall" in ours.timers) is (value == "true")


def test_a_malformed_overlap_raises_the_jax_packages_message(session):
    q = f"info_file={session}&fe=dwt-8-fused&train_clf=logreg&overlap=maybe"
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(q)
    with pytest.raises(ValueError) as ours:
        PipelineBuilder(q, device="cpu").execute()
    assert str(ours.value) == str(theirs.value) == "overlap= must be true or false, got 'maybe'"


@pytest.mark.parametrize("overlap", ["true", ""])
def test_the_report_overlap_key_takes_the_jax_packages_form(session, tmp_path, overlap):
    q = f"info_file={session}&fe=dwt-8-fused&train_clf=logreg&{LINEAR}&cache=false"
    if overlap:
        q += f"&overlap={overlap}"
    PipelineBuilder(q + f"&report={tmp_path / 'port'}", device="cpu").execute()
    JaxBuilder(q + f"&report={tmp_path / 'jax'}").execute()
    got, want = ({k: json.loads((tmp_path / d / "run_report.json").read_text())[k]
                  for k in ("overlap", "backend")} for d in ("port", "jax"))
    assert got["overlap"] is want["overlap"] is (overlap == "true")


def test_a_staging_producer_fault_fails_the_overlapped_run(session, tmp_path):
    """The JAX package's ladder absorbs this fault; the port has none: the
    injected error surfaces at the consumer and fails the run, and the
    crash report records the rule fired once."""
    q = (f"info_file={session}&fe=dwt-8-fused&train_clf=logreg&cache=false&overlap=true"
         f"&faults=staging.producer:once@1&report={tmp_path}")
    with pytest.raises(chaos.ChaosInjectedError, match="staging.producer"):
        PipelineBuilder(q, device="cpu").execute()
    crash = json.loads((tmp_path / "crash_report.json").read_text())
    rule = crash["chaos"]["rules"]["staging.producer"]
    assert rule["fired"] == 1 and rule["calls"] == 1
    # without overlap the point is never reached, and the run completes
    clean = q.replace("&overlap=true", "&overlap=false").replace(f"&report={tmp_path}", "")
    PipelineBuilder(clean, device="cpu").execute()
