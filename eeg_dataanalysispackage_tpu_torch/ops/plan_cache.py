"""Cached host plans for the fused-ingest path.

Port of the JAX package's ``ops/plan_cache.py``: a small named LRU of
host plans keyed on a content digest of the planner's inputs, with
hit/miss counters the run report carries (``caches.plan_cache``). The
port's one planner is ``ops/device_ingest.plan_ingest``: marker metadata
and the balance scan's entering state -> the padded kernel plan, a
function of nothing else, so a repeated run over an unchanged session
plans each recording once.

Entries are host numpy plans, never CUDA tensors. The capacity bounds
memory for long-running services ingesting many distinct recordings;
``EEG_TPU_PLAN_CACHE_SIZE`` overrides it, and a cache made with its own
``capacity`` keeps that.

Across processes: :func:`save_file` pickles every cache (entries and
capacity) to ``EEG_TPU_PLAN_CACHE_FILE`` (or the path given), and
:func:`load_file` warm-starts a process from it, best effort: a missing
or corrupt file loads 0 entries and raises nothing. The loader admits
only this package's plan classes and numpy (a restricted
``pickle.Unpickler``) and only a file this package wrote. The JAX package
reads the same env name, but a file it wrote holds its own plan classes:
the port loads 0 entries from it and imports nothing of the JAX package,
so the two packages' files do not interchange.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
import threading
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np

#: default per-cache entry bound; a plan is a few KB of int32/bool/f64
_DEFAULT_CAPACITY = 128


def _capacity() -> int:
    try:
        return max(1, int(os.environ.get("EEG_TPU_PLAN_CACHE_SIZE", "")))
    except ValueError:
        return _DEFAULT_CAPACITY


class PlanCache:
    """One named, thread-safe, bounded LRU of host plans. ``capacity``
    overrides the shared default bound for this cache."""

    def __init__(self, name: str, capacity: Optional[int] = None):
        self.name = name
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, object]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: str, builder: Callable[[], object]):
        """The cached plan for ``key``, built (and cached) on a miss. The
        builder runs outside the lock: two racing builders of one key
        are redundant, not wrong (plans are pure functions of the key)."""
        with self._lock:
            if key in self._entries:
                self.hits += 1
                self._entries.move_to_end(key)
                return self._entries[key]
        value = builder()
        with self._lock:
            self.misses += 1
            self._entries[key] = value
            self._entries.move_to_end(key)
            cap = self.capacity or _capacity()
            while len(self._entries) > cap:
                self._entries.popitem(last=False)
        return value

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses, "entries": len(self._entries)}

    def clear(self) -> None:
        """Drop entries and counters."""
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0


_registry_lock = threading.Lock()
_registry: Dict[str, PlanCache] = {}


def cache(name: str, capacity: Optional[int] = None) -> PlanCache:
    """The process-wide cache for ``name`` (created on first use;
    ``capacity`` applies only at creation)."""
    with _registry_lock:
        if name not in _registry:
            _registry[name] = PlanCache(name, capacity=capacity)
        return _registry[name]


def digest(*arrays: np.ndarray, extra: Tuple = ()) -> str:
    """Content key for planner inputs: dtype, shape and raw bytes of
    every array, plus the repr of the static ``extra`` tuple."""
    h = hashlib.blake2b(digest_size=20)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    h.update(repr(extra).encode())
    return h.hexdigest()


def stats() -> Dict[str, object]:
    """Aggregate and per-cache counters; always carries ``hits`` and
    ``misses`` (zeros when no planner ran)."""
    with _registry_lock:
        caches = list(_registry.values())
    per = {c.name: c.stats() for c in caches}
    return {
        "hits": sum(s["hits"] for s in per.values()),
        "misses": sum(s["misses"] for s in per.values()),
        "caches": per,
    }


def clear() -> None:
    """Reset every registered cache (entries and counters)."""
    with _registry_lock:
        caches = list(_registry.values())
    for c in caches:
        c.clear()


# -- cross-process persistence ---------------------------------------------

ENV_FILE = "EEG_TPU_PLAN_CACHE_FILE"

#: the tag of a file :func:`save_file` wrote (the JAX package's files
#: have none)
FILE_FORMAT = "eeg-tpu-torch-plan-cache/v1"

_PACKAGE = __name__.split(".")[0]
#: the classes a plan-cache file may name: this package's plans and numpy's
#: array and dtype reconstructors
_ADMITTED = {(f"{_PACKAGE}.ops.device_ingest", "IngestPlan")}
_NUMPY_NAMES = {"_reconstruct", "ndarray", "dtype", "_frombuffer", "scalar"}


class _PlanUnpickler(pickle.Unpickler):
    """Unpickles only the admitted plan classes and numpy: anything else
    (the JAX package's plans among them) raises before it is imported."""

    def find_class(self, module: str, name: str):
        if (module, name) in _ADMITTED or (
                module.split(".")[0] == "numpy" and name in _NUMPY_NAMES):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"a plan-cache file may not name {module}.{name}")


def persist_path(path: Optional[str] = None) -> Optional[str]:
    """The persistence file in effect (the path given, else
    ``EEG_TPU_PLAN_CACHE_FILE``), or None."""
    return path or os.environ.get(ENV_FILE) or None


def save_file(path: Optional[str] = None) -> Optional[str]:
    """Pickle every registered cache's entries and capacity to ``path``
    (a temporary file renamed into place); returns the path, or None when
    persistence is off or the write failed (never fatal)."""
    path = persist_path(path)
    if path is None:
        return None
    with _registry_lock:
        caches = list(_registry.items())
    payload = {"format": FILE_FORMAT, "caches": {}}
    for name, c in caches:
        with c._lock:
            payload["caches"][name] = {"capacity": c.capacity, "entries": dict(c._entries)}
    try:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".plan-cache-")
        try:
            with os.fdopen(fd, "wb") as f:
                pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except (OSError, pickle.PicklingError):
        return None
    return path


def load_file(path: Optional[str] = None) -> int:
    """Warm-start the registered caches from ``path``; returns the number
    of entries loaded: 0 for a missing or corrupt file, a file this
    package did not write, or one naming a class outside the admitted
    set. Loaded entries count as neither hits nor misses; a cache made
    here takes the file's capacity, and every cache's bound applies."""
    path = persist_path(path)
    if path is None or not os.path.exists(path):
        return 0
    try:
        with open(path, "rb") as f:
            payload = _PlanUnpickler(f).load()
    except Exception:  # a warm start is best effort: any unreadable file is empty
        return 0
    if not isinstance(payload, dict) or payload.get("format") != FILE_FORMAT:
        return 0
    records = payload.get("caches")
    if not isinstance(records, dict):
        return 0
    loaded = 0
    for name, record in records.items():
        if not isinstance(record, dict) or not isinstance(record.get("entries"), dict):
            continue
        c = cache(name, capacity=record.get("capacity"))
        if c.capacity is None:
            # a cache made before this load without a bound of its own
            # takes the saved one
            c.capacity = record.get("capacity")
        with c._lock:
            for key, value in record["entries"].items():
                c._entries[key] = value
                c._entries.move_to_end(key)
                loaded += 1
            cap = c.capacity or _capacity()
            while len(c._entries) > cap:
                c._entries.popitem(last=False)
    return loaded
