"""The PyTorch port imports neither JAX nor the JAX package.

A fresh interpreter imports the port and every one of its submodules
and must leave ``jax``, ``flax``, ``optax``, ``msgpack`` and
``eeg_dataanalysispackage_tpu`` out of ``sys.modules`` (a subprocess:
tests/conftest.py imports JAX into this one; the card's host has none of
them, so the checkpoint store writes flax's bytes with its own codec). An
AST scan pins the same for every source file of the port, for
``chip_smoke.py`` and ``chip_compare.py``, for the lifecycle's kill
worker ``tests/_torch_lifecycle_worker.py``, the two-process worker
``tests/_torch_distributed_worker.py`` and the executor's kill worker
``tests/_torch_scheduler_worker.py``, including imports inside
functions. The plan IR and the scheduler's modules are its own copies
of the JAX package's pure-Python ones, walked and scanned like the rest. A pod member (``parallel/pod_worker``) runs a whole query and
its ``sys.modules`` holds none of them either.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "eeg_dataanalysispackage_tpu_torch")

_PROBE = """
import importlib, pkgutil, sys
import eeg_dataanalysispackage_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "flax", "optax", "msgpack", "eeg_dataanalysispackage_tpu")
)
print(len(names), leaked, " ".join(names))
assert not leaked, leaked
"""


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "chip_compare.py"),
           os.path.join(REPO, "tests", "_torch_lifecycle_worker.py"),
           os.path.join(REPO, "tests", "_torch_distributed_worker.py"),
           os.path.join(REPO, "tests", "_torch_scheduler_worker.py")]
    for root, _dirs, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_fresh_import_of_every_submodule_leaves_jax_out():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    count = int(proc.stdout.split()[0])
    assert count >= 20  # every subpackage and module was walked


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    banned = ("jax", "flax", "optax", "msgpack", "eeg_dataanalysispackage_tpu")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in banned, f"{path}:{node.lineno} imports {name}"


def test_the_remote_layer_is_scanned():
    """The remote filesystem layer and the observability modules it
    needs are among the scanned sources (and walked by the fresh import)."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("io/sources.py", "io/remote.py", "io/circuit.py", "io/deadline.py",
                "io/export.py", "io/modelfiles.py", "obs/__init__.py", "obs/chaos.py",
                "obs/events.py", "obs/domain.py"):
        assert rel in scanned


def test_the_lifecycle_modules_are_walked_and_scanned():
    """The serving lifecycle, the checkpoint store and its codec are among
    the modules the fresh import walks, and (with the kill worker) among
    the scanned sources."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("checkpoint", "checkpoint.manager", "checkpoint.codec", "serve.lifecycle",
                 "models.sgd", "models.stats"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("eeg_dataanalysispackage_tpu_torch/checkpoint/__init__.py",
                "eeg_dataanalysispackage_tpu_torch/checkpoint/manager.py",
                "eeg_dataanalysispackage_tpu_torch/checkpoint/codec.py",
                "eeg_dataanalysispackage_tpu_torch/serve/lifecycle.py",
                "tests/_torch_lifecycle_worker.py"):
        assert rel in scanned


def test_the_nn_slice_modules_are_walked_and_scanned():
    """The threefry streams, the neural-network classifier and the DL4J
    architecture import keep their own copies of flax's fold-in and
    initializers and optax's rules: walked by the fresh import, scanned."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("utils.threefry", "models.nn", "io.dl4j_compat"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("utils/threefry.py", "models/nn.py", "io/dl4j_compat.py"):
        assert rel in scanned


def test_the_tree_modules_are_walked_and_scanned():
    """The tree classifiers and the device growers keep their own copy of
    the MLlib split sketch (the JAX package's ``mllib_tree_oracle`` is
    JAX-free, but it is the JAX package's): walked by the fresh import,
    scanned, and neither names ``mllib_tree_oracle``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("models.trees", "models.trees_device"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("models/trees.py", "models/trees_device.py"):
        assert rel in scanned
        with open(os.path.join(PORT, rel), encoding="utf-8") as f:
            assert "mllib_tree_oracle" not in f.read()


def test_the_seizure_modules_are_walked_and_scanned():
    """The seizure workload keeps its own copies of the JAX package's
    JAX-free sliding epocher and subband extractor: walked by the fresh
    import, scanned, and neither names the JAX package's modules."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("epochs.sliding", "features.subband", "features.registry", "ops.dwt_host",
                 "io.provider", "models.population", "models.seizure", "parallel.population",
                 "serve.pipeline", "pipeline.builder"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("epochs/sliding.py", "features/subband.py", "models/seizure.py"):
        assert rel in scanned


def test_the_run_record_modules_are_walked_and_scanned():
    """The MLlib directory interchange, the feature and plan caches, the
    run report and the run bracket keep their own copies of the JAX
    package's modules (``io/mllib_format.py`` imports no JAX, but it is
    the JAX package's): walked by the fresh import without ``pyarrow``
    being imported, and scanned."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE + "\nassert 'pyarrow' not in sys.modules\n"
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    modules = ("io.mllib_format", "io.feature_cache", "ops.plan_cache", "obs.report",
               "scheduler", "scheduler.runtime")
    for name in modules:
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("io/mllib_format.py", "io/feature_cache.py", "ops/plan_cache.py",
                "obs/report.py", "scheduler/__init__.py", "scheduler/runtime.py"):
        assert rel in scanned


def test_the_input_pipeline_modules_are_walked_and_scanned():
    """The input pipeline's modules (the staging producer, the native
    binding, the pooled provider, the plan cache's file) are walked by
    the fresh import, which builds nothing, and scanned; the native
    binding builds the port's own ``csrc/eeg_host.cc`` and names nothing
    of the JAX package's ``native/`` build."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE + (
        "\nfrom eeg_dataanalysispackage_tpu_torch.ops import cuda_build"
        "\nassert cuda_build.BUILD_SECONDS == {}, cuda_build.BUILD_SECONDS\n")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("io.staging", "io.native", "io.provider", "ops.plan_cache", "ops.cuda_build"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("io/__init__.py", "io/staging.py", "io/native.py", "ops/cuda_build.py"):
        assert rel in scanned
    assert os.path.isfile(os.path.join(PORT, "csrc", "eeg_host.cc"))
    with open(os.path.join(PORT, "io", "native.py"), encoding="utf-8") as f:
        source = f.read()
    assert "build_host(_SOURCE)" in source and '_SOURCE = "eeg_host"' in source
    assert "libeeg_host" not in source and "Makefile" not in source


def test_the_single_process_mesh_modules_are_walked_and_scanned():
    """The mesh, the sharded ingest, the sharded population engine and the
    data-parallel trainers keep their own copies of the JAX package's
    mesh grammar and helpers: walked by the fresh import, which builds no
    kernel and touches no card, and scanned."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE + (
        "\nfrom eeg_dataanalysispackage_tpu_torch.ops import cuda_build"
        "\nassert cuda_build.BUILD_SECONDS == {}, cuda_build.BUILD_SECONDS\n")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("parallel", "parallel.mesh", "parallel.sharded_ingest", "parallel.population",
                 "parallel.train", "models.trees_device", "models.sgd", "ops.device_ingest"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharded_ingest.py",
                "parallel/population.py", "parallel/train.py"):
        assert rel in scanned


def test_the_multi_process_modules_are_walked_and_scanned():
    """The multi-process runtime, the pod layer, the pod worker and the
    streaming front end keep their own copies of the JAX package's
    JAX-free parts (the preflight, the partition, the signal helpers):
    walked by the fresh import, which starts no process group, and
    scanned with the two-process worker."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE + (
        "\nfrom eeg_dataanalysispackage_tpu_torch.parallel import distributed"
        "\nassert not distributed.is_initialized()\n")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    for name in ("parallel.distributed", "parallel.pod", "parallel.pod_worker",
                 "parallel.streaming", "ops.signal"):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("eeg_dataanalysispackage_tpu_torch/parallel/distributed.py",
                "eeg_dataanalysispackage_tpu_torch/parallel/pod.py",
                "eeg_dataanalysispackage_tpu_torch/parallel/pod_worker.py",
                "eeg_dataanalysispackage_tpu_torch/parallel/streaming.py",
                "eeg_dataanalysispackage_tpu_torch/ops/signal.py",
                "tests/_torch_distributed_worker.py"):
        assert rel in scanned


_POD_MEMBER_PROBE = """
import runpy, sys
sys.argv = ["pod_worker", "--query=" + sys.argv[1], "--device=cpu"]
try:
    runpy.run_module("eeg_dataanalysispackage_tpu_torch.parallel.pod_worker", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
leaked = sorted(
    k for k in sys.modules
    if k.split(".")[0] in ("jax", "flax", "optax", "msgpack", "eeg_dataanalysispackage_tpu")
)
print("LEAKED", leaked)
assert not leaked, leaked
"""


def test_a_pod_members_modules_hold_no_jax(tmp_path):
    """A pod member runs a whole fused population query (``processes=1``:
    the pod grammar and its record, the single-process path) and leaves
    no JAX module in its ``sys.modules``."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _synthetic

    info = _synthetic.write_session(str(tmp_path))
    query = (f"info_file={info}&fe=dwt-8-fused&train_clf=logreg&cv=2&cache=false"
             "&processes=1")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _POD_MEMBER_PROBE, query], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "LEAKED []" in proc.stdout
    assert '"sha"' in proc.stdout


def test_the_plan_ir_and_scheduler_modules_are_walked_and_scanned():
    """``pipeline/plan`` and ``scheduler/*`` are the port's own copies of
    JAX-free modules of the JAX package: walked by the fresh import and
    scanned, so none of them reaches into the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    modules = ("pipeline.plan", "scheduler", "scheduler.runtime", "scheduler.journal",
               "scheduler.lease", "scheduler.executor")
    for name in modules:
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in modules:
        rel = name.replace(".", "/") + ("/__init__.py" if name == "scheduler" else ".py")
        assert rel in scanned
    assert os.path.join("..", "tests", "_torch_scheduler_worker.py") in scanned


def test_the_operator_tools_are_scanned():
    """The operator tools (``tools/``: ``plan_admin``, ``fleet_top``,
    ``chaos_run``, ``obs_report``) are the port's own copies of the JAX
    package's stdlib tools: scanned here, walked by the fresh import (which
    runs none of them)."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("__init__", "plan_admin", "fleet_top", "chaos_run", "obs_report"):
        assert f"tools/{name}.py" in scanned



WALKTHROUGHS = ("train_p300", "fused_ingest", "raw_stream_training", "sharded_long_recording",
                "stream_continuous", "mllib_migration")


def test_the_walkthrough_modules_are_walked_and_scanned():
    """The six walkthroughs (``examples/``, the twins of the JAX
    package's ``examples/`` scripts) are walked by the fresh import, which
    runs none of them (no build, no launch), and scanned; none imports
    from ``tests/``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = _PROBE + (
        "\nfrom eeg_dataanalysispackage_tpu_torch.ops import cuda_build, ingest_cuda"
        "\nassert cuda_build.BUILD_SECONDS == {}, cuda_build.BUILD_SECONDS"
        "\nassert ingest_cuda.LAUNCHES == 0\n")
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = set(proc.stdout.split("] ", 1)[1].split())
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for name in ("examples",) + tuple(f"examples.{w}" for w in WALKTHROUGHS):
        assert f"eeg_dataanalysispackage_tpu_torch.{name}" in walked
    for rel in ("examples/__init__.py",) + tuple(f"examples/{w}.py" for w in WALKTHROUGHS):
        assert rel in scanned
        with open(os.path.join(PORT, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert (node.module or "").split(".")[0] not in ("tests", "_synthetic")
            elif isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] not in ("tests", "_synthetic")
                           for a in node.names)
