"""Build the package's native sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``_build/<name>-<hash>.so``, keyed by a hash of the source, the shared
``csrc/*.cuh`` headers and the flags, and loads with ``ctypes``. The kernels expose plain ``extern "C"``
launchers that return ``cudaGetLastError()``, so no PyTorch header is
compiled. The host library ``csrc/<name>.cc`` (the input pipeline's
parsers, demux and epoch stage) compiles the same way with ``g++``
(:data:`HOST_FLAGS`, no ``-ffast-math``). Each build writes a file of its own and renames it into
place, so processes building at once never load a partial library. A
missing compiler or a failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: the host library's compiler and flags: strict IEEE float arithmetic
#: (no ``-ffast-math``), so the float32 baseline fold stays bit-equal to
#: numpy
CXX = "g++"
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

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
#: wall seconds of each build made by this process, by source file name
BUILD_SECONDS: Dict[str, float] = {}


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


def _hashed_path(name: str, sources: Sequence[str], flags: Sequence[str]) -> str:
    h = hashlib.sha256()
    for fname in sources:
        with open(os.path.join(SOURCE_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to for its current content and
    that of the headers it may include."""
    headers = sorted(f for f in os.listdir(SOURCE_DIR) if f.endswith(".cuh"))
    return _hashed_path(name, [name + ".cu", *headers], NVCC_FLAGS)


def host_library_path(name: str) -> str:
    """Where the host source ``csrc/<name>.cc`` builds to."""
    return _hashed_path(name, [name + ".cc"], HOST_FLAGS)


def _compile(path: str, compiler: Sequence[str], source: str) -> str:
    """Run ``compiler -o <tmp> source`` and rename the result to
    ``path``; returns the compiler's output, raises with it."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([*compiler, "-o", tmp, os.path.join(SOURCE_DIR, source)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler[0]} failed to build {source}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(
            f"{compiler[0]} failed to build {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)
    BUILD_SECONDS[source] = time.perf_counter() - t0
    return proc.stdout + proc.stderr


def build(name: str, nvcc: Optional[str] = None) -> str:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists;
    returns the library path."""
    path = library_path(name)
    if not os.path.exists(path):
        BUILD_LOGS[name] = _compile(path, [nvcc or find_nvcc(), *NVCC_FLAGS], name + ".cu")
    return path


def build_host(name: str) -> str:
    """Compile the host source ``csrc/<name>.cc`` with :data:`CXX` unless
    its hashed library exists; returns the library path."""
    path = host_library_path(name)
    if not os.path.exists(path):
        _compile(path, [CXX, *HOST_FLAGS], name + ".cc")
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
