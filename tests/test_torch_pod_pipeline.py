"""The port's multi-process runs, live: ``processes=2`` and ``processes=4``
over gloo on the CPU.

Twin of the JAX package's ``tests/test_pod_pipeline.py``, whose own
two-process run fails on this host (ROADMAP.md C1), so the port is held
against the JAX package's single-process run of the same query, which the
JAX design pins its pod runs byte-identical to. Each rank is a fresh
``parallel/pod_worker`` process started by ``pod.spawn_pod_member(device=
"cpu")`` over a loopback coordinator (``distributed.free_port_pair``): the
preflight, ``torch.distributed`` over gloo, the partitioned fused ingest
(each rank reads and featurizes its own recordings, one all-gather), the
population's members over hosts x devices. Every rank's statistics must
be byte-identical to the JAX package's single-process run, its exchanged
matrix bit-equal to the port's unpartitioned rows, and its counters must
show it read only its own waveforms. The worker's watchdog exits 70 when
its spawner dies.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from eeg_dataanalysispackage_tpu.pipeline import builder as jax_builder
from eeg_dataanalysispackage_tpu_torch.io import provider
from eeg_dataanalysispackage_tpu_torch.parallel import distributed, pod, pod_worker

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _synthetic  # noqa: E402

_POP_QUERY = (
    "fe=dwt-8-fused-decode&train_clf=logreg&cv=2&sweep=lr:1.0,0.5"
    "&cache=false&config_num_iterations=12"
    "&config_step_size=1.0&config_mini_batch_fraction=1.0"
)
N_FILES = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def info(tmp_path_factory):
    directory = tmp_path_factory.mktemp("pod_pipe")
    lines = []
    for i in range(N_FILES):
        name = f"podp_{i}"
        guessed = 2 + i
        _synthetic.write_recording(str(directory), name=name, n_markers=60, guessed=guessed,
                                   seed=i)
        lines.append(f"{name}.eeg {guessed}")
    info = os.path.join(str(directory), "info.txt")
    with open(info, "w") as f:
        f.write("\n".join(lines) + "\n")
    return info


@pytest.fixture(scope="module")
def references(info):
    """The JAX package's single-process statistics digest, and the port's
    unpartitioned feature rows' digest and per-recording row counts."""
    stats = str(jax_builder.PipelineBuilder(f"info_file={info}&{_POP_QUERY}").execute())
    odp = provider.OfflineDataProvider([info], device="cpu")
    features, _ = odp.load_features_device()
    rows = pod.plan_pod_ingest(provider.OfflineDataProvider([info], device="cpu")).row_counts()
    return (hashlib.sha256(stats.encode()).hexdigest(),
            hashlib.sha256(features.numpy().tobytes()).hexdigest(), rows)


def _child_env(monkeypatch):
    # one thread a rank: four ranks import torch and train at once
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("EEG_TPU_NO_FEATURE_CACHE", "1")
    monkeypatch.delenv("EEG_TPU_FAULTS", raising=False)
    for var in ("JAX_NUM_PROCESSES", "JAX_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(REPO)


def _run_pod(query, n, timeout_s="60"):
    """``n`` ranks of ``query``; their JSON results in rank order. Every
    rank is bounded and stragglers are killed if a peer fails."""
    port = distributed.free_port_pair()
    procs = [pod.spawn_pod_member(query, f"127.0.0.1:{port}", n, r, timeout_s=timeout_s,
                                  device="cpu") for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, port


@pytest.mark.parametrize("n", [2, 4])
def test_pod_statistics_byte_identical_to_the_jax_single_process_run(info, references,
                                                                     monkeypatch, n):
    _child_env(monkeypatch)
    stats_sha, features_sha, rows = references
    outs, port = _run_pod(f"info_file={info}&{_POP_QUERY}", n)
    ranges = pod.partition(N_FILES, n)
    host_rows = [sum(rows[lo:hi]) for lo, hi in ranges]
    for pid, o in enumerate(outs):
        assert o["sha"] == stats_sha, o["statistics"]
        # the exchanged matrix is the unpartitioned run's, bit for bit
        assert o["features_sha256"] == features_sha
        mesh = o["mesh"]
        assert mesh["rung"] == "pod" and mesh["backend"] == "gloo"
        assert (mesh["processes"], mesh["process_id"]) == (n, pid)
        assert mesh["coordinator"] == f"127.0.0.1:{port}"
        assert mesh["dcn_shape"] == {"hosts": n}
        assert mesh["shape"] == {"hosts": n, "data": 1}
        assert mesh["population"]["rung"] == "mesh"
        assert mesh["population"]["axis"] == "hosts,data"
        owned = ranges[pid][1] - ranges[pid][0]
        m = o["metrics"]
        assert m["pod.recordings_owned"] == owned
        assert m["pod.recordings_total"] == N_FILES
        # the metadata pass reads two text files a recording, the rank
        # the waveforms of its own recordings only
        assert m["ingest.file_reads"] == 2 * N_FILES + owned
        assert m["pod.exchange_bytes"] == max(host_rows) * 48 * 4 * (n - 1)
        assert m["pipeline.pod_runs"] == 1
        assert "exchange" in o["timers"]


def test_the_workers_watchdog_exits_when_its_spawner_dies(info, monkeypatch, tmp_path):
    """A rank whose spawner is SIGKILLed while the rank waits in the
    preflight exits with ORPHANED_EXIT. A harness process is made the
    orphans' subreaper, so it can read the rank's exit status."""
    _child_env(monkeypatch)
    port = distributed.free_port_pair()
    spawner = (
        "import sys, time\n"
        "from eeg_dataanalysispackage_tpu_torch.parallel import pod\n"
        f"p = pod.spawn_pod_member({f'info_file={info}&{_POP_QUERY}'!r}, "
        f"'127.0.0.1:{port}', 2, 1, timeout_s='120', device='cpu')\n"
        "print(p.pid, flush=True)\n"
        "time.sleep(120)\n"
    )
    harness = (
        "import ctypes, os, signal, subprocess, sys, time\n"
        "ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)  # PR_SET_CHILD_SUBREAPER\n"
        f"s = subprocess.Popen([sys.executable, '-c', {spawner!r}], stdout=subprocess.PIPE, "
        "text=True)\n"
        "member = int(s.stdout.readline())\n"
        "os.kill(s.pid, signal.SIGKILL)\n"
        "s.wait()\n"
        "t0 = time.monotonic()\n"
        "_, status = os.waitpid(member, 0)\n"
        "print(os.waitstatus_to_exitcode(status), time.monotonic() - t0)\n"
    )
    out = subprocess.run([sys.executable, "-c", harness], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    code, seconds = out.stdout.split()
    assert int(code) == pod_worker.ORPHANED_EXIT
    assert float(seconds) < 30.0
