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
``EEG_TPU_PLAN_CACHE_SIZE`` overrides it. The JAX package's
cross-process pickle file (``EEG_TPU_PLAN_CACHE_FILE``, its ingest
bench's warm start) is not ported.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Callable, Dict, Tuple

import numpy as np

#: default per-cache entry bound; a plan is a few KB of int32/bool/f64
_DEFAULT_CAPACITY = 128


def _capacity() -> int:
    try:
        return max(1, int(os.environ.get("EEG_TPU_PLAN_CACHE_SIZE", "")))
    except ValueError:
        return _DEFAULT_CAPACITY


class PlanCache:
    """One named, thread-safe, bounded LRU of host plans."""

    def __init__(self, name: str):
        self.name = name
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
            cap = _capacity()
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


def cache(name: str) -> PlanCache:
    """The process-wide cache for ``name`` (created on first use)."""
    with _registry_lock:
        if name not in _registry:
            _registry[name] = PlanCache(name)
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
