"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/<name>-<hash>.so``, keyed by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, and loads with ``ctypes``. The kernels expose plain ``extern "C"``
launchers that return ``cudaGetLastError()``, so no PyTorch header is
compiled. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: the largest count a kernel's C ``int`` launch argument holds
INT32_MAX = 2**31 - 1

#: the fused kernels' launchers' code (not a ``cudaError_t``) for sizes
#: outside their generic engine's reach (``csrc/window_features_any.cuh``:
#: kSharedMemoryExceeded)
SHARED_MEMORY_EXCEEDED = -1

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
#: ptxas register / shared-memory report of each build made by this process
BUILD_LOGS: Dict[str, str] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME/bin`` (the toolkit's
    usual default when unset); raises."""
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = os.path.join(home, "bin", "nvcc")
        nvcc = candidate if os.path.exists(candidate) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at "
            "first use and need the CUDA toolkit"
        )
    return nvcc


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to for its current content and
    that of the headers it may include."""
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256()
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(SOURCE_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return os.path.join(BUILD_DIR, f"{name}-{digest[:16]}.so")


def build(name: str, nvcc: Optional[str] = None) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists;
    returns the library path."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    cmd = [nvcc or find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(SOURCE_DIR, name + ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    return path


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _LOADED[name] = lib
        return lib


@functools.lru_cache(maxsize=4096)
def plan_array(plan):
    """A generic tile plan (``generic_plan.TilePlan``) as the launchers'
    ``const int*``; ``None`` (a null pointer) where there is none. One
    array a plan, made once: the launchers only read it."""
    if plan is None:
        return None
    fields = plan.fields()
    return (ctypes.c_int * len(fields))(*fields)


_LIMITS: Dict[tuple, tuple] = {}


def device_limits(fn, error_string, device) -> tuple:
    """(multiprocessors, per-block shared-memory opt-in bytes) of the card
    ``device`` (a ``torch.device``), through a library's
    ``*_device_limits`` function; cached per library and card; raises on
    a CUDA error."""
    import torch

    key = (fn.__name__, device.index)
    limits = _LIMITS.get(key)
    if limits is None:
        sms, optin = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = fn(ctypes.byref(sms), ctypes.byref(optin))
        if rc != 0:
            raise RuntimeError(
                f"reading the card's limits failed: CUDA error {rc} "
                f"({error_string(rc).decode()})"
            )
        limits = _LIMITS[key] = (sms.value, optin.value)
    return limits
