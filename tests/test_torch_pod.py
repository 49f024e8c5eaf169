"""The port's pod layer (``parallel/pod.py``, ``parallel/distributed.py``,
the builder's pod grammar) against the JAX package's, hermetic half.

Twins of ``tests/test_pod.py``'s passing tests: the recording partition,
the bootstrap latch, the preflight's "unreachable" and "peer" errors, the
partitioned ingest simulated host by host in one process for 1, 2, 3 and
5 hosts (bit-equal to the port's unpartitioned rows, within the fused
tolerance of the JAX package's simulated rows), the global plan's targets
and row counts, ``processes=1`` byte-identical with its pod block, the
grammar's and the precision refusal's messages. Where the JAX package
degrades a pod that cannot assemble to one host, the port raises
``PodBootstrapError`` within its deadline, before reading any waveform.
The live multi-process half is tests/test_torch_pod_pipeline.py.
"""

import json
import os
import socket
import sys
import time

import numpy as np
import pytest
import torch

from eeg_dataanalysispackage_tpu.io import provider as jax_provider
from eeg_dataanalysispackage_tpu.parallel import distributed as jax_distributed
from eeg_dataanalysispackage_tpu.parallel import pod as jax_pod
from eeg_dataanalysispackage_tpu.pipeline import builder as jax_builder
from eeg_dataanalysispackage_tpu_torch.io import provider
from eeg_dataanalysispackage_tpu_torch.ops import ingest_cuda
from eeg_dataanalysispackage_tpu_torch.parallel import distributed, pod
from eeg_dataanalysispackage_tpu_torch.pipeline import builder

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

FUSED_TOL = 1e-6  # port rows against the JAX package's fused rows (test_torch_pipeline.py)

_POP_QUERY = (
    "fe=dwt-8-fused&train_clf=logreg&cv=2&sweep=lr:1.0,0.5&cache=false"
    "&config_num_iterations=12&config_step_size=1.0"
    "&config_mini_batch_fraction=1.0"
)


def _session(directory, n_files=3, n_markers=40):
    lines = []
    for i in range(n_files):
        name = f"pod_{i:02d}"
        guessed = 2 + i
        _synthetic.write_recording(str(directory), name=name, n_markers=n_markers,
                                   guessed=guessed, seed=i)
        lines.append(f"{name}.eeg {guessed}")
    info = os.path.join(str(directory), "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    return _session(tmp_path_factory.mktemp("pod_session"))


@pytest.fixture(autouse=True)
def _no_pod_env(monkeypatch):
    for var in ("JAX_NUM_PROCESSES", "JAX_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "JAX_PROCESS_ID", distributed.ENV_NO_PREFLIGHT):
        monkeypatch.delenv(var, raising=False)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _q(info, *parts):
    return "&".join([f"info_file={info}", _POP_QUERY, *parts])


# -- partition ------------------------------------------------------------


def test_partition_equals_the_jax_packages_and_is_exhaustive():
    for n in range(0, 14):
        for procs in range(1, 8):
            ranges = pod.partition(n, procs)
            assert ranges == jax_pod.partition(n, procs)
            assert [i for lo, hi in ranges for i in range(lo, hi)] == list(range(n))
            sizes = [hi - lo for lo, hi in ranges]
            assert max(sizes) - min(sizes) <= 1


def test_partition_empty_host_edge():
    assert [hi - lo for lo, hi in pod.partition(2, 5)] == [1, 1, 0, 0, 0]
    with pytest.raises(ValueError, match=">= 1"):
        pod.partition(3, 0)


# -- the bootstrap seam ----------------------------------------------------


def test_initialize_is_a_single_process_noop():
    assert distributed.initialize() == (None, 1, 0) == jax_distributed.initialize()
    assert not distributed.is_initialized()
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)


def test_shutdown_resets_the_latch():
    assert not distributed.is_initialized()
    distributed._initialized = True
    distributed._resolution = ("127.0.0.1:1", 2, 0)
    try:
        assert distributed.initialize() == ("127.0.0.1:1", 2, 0)
        distributed.shutdown()  # no group is live: the teardown logs, the latch resets
        assert not distributed.is_initialized()
        assert distributed.initialize() == (None, 1, 0)
    finally:
        distributed._initialized = False
        distributed._resolution = None


def test_partial_setup_is_refused_with_the_jax_message(monkeypatch):
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(ValueError) as ours:
        distributed.initialize()
    with pytest.raises(ValueError) as theirs:
        jax_distributed.initialize()
    assert str(ours.value) == str(theirs.value)


def test_env_twins_resolve_like_the_jax_package(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert distributed.resolve_env_knobs() == jax_distributed.resolve_env_knobs() == (
        "10.0.0.1:1234", 4, 2)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.2:99")
    assert distributed.resolve_env_knobs("h:1", 3, 0) == ("h:1", 3, 0)
    assert distributed.resolve_env_knobs()[0] == "10.0.0.2:99"


@pytest.mark.parametrize("kind", ["unreachable", "peer"])
def test_preflight_raises_the_jax_packages_errors(kind):
    """A coordinator that never answers (rank 1) and a peer that never
    arrives (rank 0): PodBootstrapError within the deadline, with the JAX
    package's message."""
    port = _free_port()
    address, pid = ((f"127.0.0.1:{port}", 1) if kind == "unreachable"
                    else (f"127.0.0.1:{port - 1}", 0))
    t0 = time.monotonic()
    with pytest.raises(distributed.PodBootstrapError, match=kind) as ours:
        distributed._preflight_rendezvous(address, 2, pid, timeout_s=1.0)
    assert time.monotonic() - t0 < 1.0 + 5.0
    with pytest.raises(jax_distributed.PodBootstrapError) as theirs:
        jax_distributed._preflight_rendezvous(address, 2, pid, timeout_s=1.0)
    assert str(ours.value).split(":")[:2] == str(theirs.value).split(":")[:2]
    if kind == "peer":
        assert str(ours.value) == str(theirs.value)


def test_free_port_pair_frees_the_preflight_port():
    port = distributed.free_port_pair()
    for p in (port, port + 1):
        s = socket.socket()
        s.bind(("", p))
        s.close()


@pytest.mark.parametrize("uuids,backend", [
    ([["a"], ["b"]], "nccl"),         # one card a rank
    ([["a", "b"], ["c", "d"]], "nccl"),
    ([["a"], ["a"]], "gloo"),         # two ranks on one card
    ([["a", "b"], ["b", "c"]], "gloo"),
    ([[], []], "gloo"),               # the CPU
])
def test_the_backend_follows_the_topology(uuids, backend):
    assert distributed.choose_backend(uuids) == backend


# -- the partitioned ingest, simulated host by host -------------------------


def _partitioned_rows(info, num_processes):
    """Every host of an N-process pod in turn: the global metadata pass
    and the host's own block, concatenated in process order."""
    parts, plan = [], None
    for pid in range(num_processes):
        odp = provider.OfflineDataProvider([info], device="cpu")
        plan = pod.plan_pod_ingest(odp)
        parts.append(pod.local_features(odp, plan, num_processes, pid,
                                        odp.planned_featurizer(backend="decode"), n_feat=48))
    return torch.cat(parts), plan


def _jax_partitioned_rows(info, num_processes):
    parts = []
    for pid in range(num_processes):
        odp = jax_provider.OfflineDataProvider([info])
        plan = jax_pod.plan_pod_ingest(odp)
        parts.append(jax_pod.local_features(odp, plan, num_processes, pid,
                                            odp.planned_featurizer(backend="decode"),
                                            n_feat=48))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def unpartitioned(info):
    return provider.OfflineDataProvider([info], device="cpu").load_features_device()


@pytest.mark.parametrize("procs", [1, 2, 3, 5])
def test_partitioned_ingest_bit_identical_to_one_process(info, unpartitioned, procs):
    f_ref, t_ref = unpartitioned
    rows, plan = _partitioned_rows(info, procs)
    assert torch.equal(rows, f_ref)
    np.testing.assert_array_equal(plan.targets, t_ref)
    np.testing.assert_allclose(rows.numpy(), _jax_partitioned_rows(info, procs), rtol=0,
                               atol=FUSED_TOL)
    counts = plan.host_row_counts(procs)
    assert sum(counts) == len(f_ref)
    if procs == 5:  # hosts 3 and 4 own nothing
        assert counts[3] == counts[4] == 0


def test_the_plan_is_the_jax_packages(info):
    ours = pod.plan_pod_ingest(provider.OfflineDataProvider([info], device="cpu"))
    theirs = jax_pod.plan_pod_ingest(jax_provider.OfflineDataProvider([info]))
    np.testing.assert_array_equal(ours.targets, theirs.targets)
    assert ours.row_counts() == theirs.row_counts()
    for procs in (1, 2, 4):
        assert ours.host_row_counts(procs) == theirs.host_row_counts(procs)
    for a, b in zip(ours.entries, theirs.entries):
        assert (a.rel_path, a.n_samples, a.channel_indices) == (
            b.rel_path, b.n_samples, list(b.channel_indices))
        np.testing.assert_array_equal(a.plan.positions[a.plan.mask],
                                      np.asarray(b.plan.positions)[np.asarray(b.plan.mask)])
    batch = provider.OfflineDataProvider([info], device="cpu").load()
    np.testing.assert_array_equal(ours.targets, batch.targets)


def test_a_host_reads_only_its_own_waveforms(info):
    """The metadata pass reads two text files a recording; a host reads
    the waveform of the recordings it owns, and launches once for each
    (on the CPU, K1's plain version)."""
    from eeg_dataanalysispackage_tpu_torch import obs

    odp = provider.OfflineDataProvider([info], device="cpu")
    with obs.metrics.scope() as m:
        plan = pod.plan_pod_ingest(odp)
        pod.local_features(odp, plan, 3, 1, odp.planned_featurizer(), n_feat=48)
    counters = m.snapshot()["counters"]
    assert counters["ingest.file_reads"] == 2 * 3 + 1
    assert ingest_cuda.LAUNCHES == 0


def test_a_recording_changed_mid_run_raises(info, tmp_path):
    import shutil

    d = tmp_path / "copy"
    shutil.copytree(os.path.dirname(info), d)
    odp = provider.OfflineDataProvider([str(d / "info.txt")], device="cpu")
    plan = pod.plan_pod_ingest(odp)
    with open(d / "pod_00.eeg", "ab") as f:
        f.write(b"\0" * 4096)  # more samples than the plan was made for
    with pytest.raises(ValueError, match="changed mid-run"):
        odp.planned_featurizer()(plan.entries[0])


def test_an_unsupported_binary_format_raises_the_jax_message(info, tmp_path):
    import shutil

    d = tmp_path / "bad"
    shutil.copytree(os.path.dirname(info), d)
    vhdr = (d / "pod_01.vhdr").read_text().replace("BinaryFormat=INT_16",
                                                   "BinaryFormat=NO_SUCH")
    (d / "pod_01.vhdr").write_text(vhdr)
    with pytest.raises(ValueError) as ours:
        pod.plan_pod_ingest(provider.OfflineDataProvider([str(d / "info.txt")], device="cpu"))
    with pytest.raises(ValueError) as theirs:
        jax_pod.plan_pod_ingest(jax_provider.OfflineDataProvider([str(d / "info.txt")]))
    assert str(ours.value) == str(theirs.value)


def test_exchange_refuses_a_disagreeing_row_count():
    with pytest.raises(ValueError, match="disagree"):
        pod.exchange_features(None, torch.zeros((3, 48)), [4, 2], 48, 0)


def test_spawn_refuses_a_placed_member():
    with pytest.raises(ValueError, match="process_id"):
        pod.spawn_pod_member("info_file=x&process_id=0", "127.0.0.1:1", 2, 0)


# -- the builder ----------------------------------------------------------


@pytest.fixture(scope="module")
def baselines(info):
    return (str(builder.PipelineBuilder(_q(info), device="cpu").execute()),
            str(jax_builder.PipelineBuilder(_q(info)).execute()))


def test_processes1_byte_identical_with_pod_block(info, baselines):
    pb = builder.PipelineBuilder(_q(info, "processes=1"), device="cpu")
    got = str(pb.execute())
    assert got == baselines[0] == baselines[1]
    theirs = jax_builder.PipelineBuilder(_q(info, "processes=1"))
    assert str(theirs.execute()) == got
    assert pb.mesh_resolved == theirs.mesh_resolved
    assert pb.mesh_resolved["pod"] == {"processes": 1, "coordinator": None,
                                       "process_id": None, "rung": "single_host"}
    assert not distributed.is_initialized()


@pytest.mark.parametrize("bad", [
    "processes=0",
    "process_id=1",
    "processes=2&process_id=2",
    "processes=2&process_id=-1",
    "processes=2&coordinator=nocolon",
    "processes=2&coordinator=host:notaport",
    "processes=2&coordinator=host:70000",
    "processes=2&serve=true",
    "processes=2&task=seizure",
    "processes=two",
])
def test_pod_grammar_errors_carry_the_jax_messages(info, bad):
    from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan

    with pytest.raises(ValueError) as ours:
        builder.PipelineBuilder(_q(info, bad), device="cpu").execute()
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(_q(info, bad))
    assert str(ours.value) == str(theirs.value)


def test_precision_refused_by_the_grammar_with_the_jax_message(info):
    from eeg_dataanalysispackage_tpu.pipeline.plan import ExecutionPlan

    q = _q(info, "processes=2&precision=bf16")
    with pytest.raises(ValueError, match="pod runs compute f32") as ours:
        builder.PipelineBuilder(q, device="cpu").execute()
    with pytest.raises(ValueError) as theirs:
        ExecutionPlan.parse(q)
    assert str(ours.value) == str(theirs.value)


def test_precision_from_the_environment_refused_on_pod_runs(info, monkeypatch):
    """A non-f32 rung resolved from EEG_TPU_PRECISION runs behind a gate
    the partitioned ingest cannot stage: the run raises, as the JAX
    package's does, before any ingest."""
    monkeypatch.setenv("EEG_TPU_PRECISION", "bf16")
    fake = pod.PodRuntime(mesh=None, num_processes=2, process_id=0)
    monkeypatch.setattr(builder.PipelineBuilder, "_resolve_pod", lambda self, request: fake)
    pb = builder.PipelineBuilder(_q(info).replace("fe=dwt-8-fused", "fe=dwt-8-fused-decode"),
                                 device="cpu")
    with pytest.raises(ValueError, match="pod runs compute f32"):
        pb.execute()
    jfake = jax_pod.PodRuntime(mesh=None, num_processes=2, process_id=0)
    monkeypatch.setattr(jax_builder.PipelineBuilder, "_resolve_pod",
                        lambda self, request: jfake)
    with pytest.raises(ValueError, match="pod runs compute f32"):
        jax_builder.PipelineBuilder(
            _q(info).replace("fe=dwt-8-fused", "fe=dwt-8-fused-decode")).execute()


@pytest.mark.parametrize("pid,kind", [(1, "unreachable"), (0, "peer")])
def test_a_pod_that_cannot_assemble_raises_and_reads_no_waveform(info, monkeypatch, tmp_path,
                                                                 pid, kind):
    """Where the JAX package degrades to one host, the port raises
    PodBootstrapError with the preflight's evidence within the deadline
    plus 5 s; no .eeg byte was read, the latch is clean, and under
    report= the crash report carries the pod record and the evidence."""
    monkeypatch.setenv(distributed.ENV_BOOTSTRAP_TIMEOUT, "1.5")
    port = _free_port() if kind == "unreachable" else _free_port() - 1
    q = _q(info, f"processes=2&coordinator=127.0.0.1:{port}&process_id={pid}",
           f"report={tmp_path}")
    pb = builder.PipelineBuilder(q, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(distributed.PodBootstrapError, match=kind):
        pb.execute()
    assert time.monotonic() - t0 < 1.5 + 5.0
    assert "ingest.file_reads" not in pb.run_metrics.snapshot()["counters"]
    assert not distributed.is_initialized()
    crash = json.loads((tmp_path / "crash_report.json").read_text())
    block = crash["mesh"]["pod"]
    assert block["processes"] == 2 and block["process_id"] == pid
    assert kind in block["error"] and block["error"].startswith("PodBootstrapError")
    assert kind in json.dumps(crash["error"])
