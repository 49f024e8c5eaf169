"""The PyTorch port imports neither JAX nor the JAX package.

A fresh interpreter imports the port and every one of its submodules
and must leave ``jax`` and ``eeg_dataanalysispackage_tpu`` out of
``sys.modules`` (a subprocess: tests/conftest.py imports JAX into this
one). An AST scan pins the same for every source file of the port and
for ``chip_smoke.py``, including imports inside functions.
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
    if k == "jax" or k.startswith("jax.") or k == "eeg_dataanalysispackage_tpu"
    or k.startswith("eeg_dataanalysispackage_tpu.")
)
print(len(names), leaked)
assert not leaked, leaked
"""


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
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
    banned = ("jax", "eeg_dataanalysispackage_tpu")
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
