"""The PyTorch port imports neither JAX nor the JAX package.

A fresh interpreter imports the port and every one of its submodules
and must leave ``jax``, ``flax``, ``optax``, ``msgpack`` and
``eeg_dataanalysispackage_tpu`` out of ``sys.modules`` (a subprocess:
tests/conftest.py imports JAX into this one; the card's host has none of
them, so the checkpoint store writes flax's bytes with its own codec). An
AST scan pins the same for every source file of the port, for
``chip_smoke.py`` and ``chip_compare.py`` and for the lifecycle's kill
worker ``tests/_torch_lifecycle_worker.py``, including imports inside
functions.
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
           os.path.join(REPO, "tests", "_torch_lifecycle_worker.py")]
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
