"""Cross-tenant plan-prefix dedup: common-subplan elimination over the
``ExecutionPlan`` IR.

Port of the JAX package's ``scheduler/dedup.py``. Tenants tuning classifier
knobs over the same recordings share one ingest+featurize prefix:
:meth:`~..pipeline.plan.ExecutionPlan.prefix_key` names it from the typed
fields alone (no I/O), so plans that share a key share one in-memory
``(features, targets)`` build, and only one of them reads the files.

Protocol (the feature cache's single flight, carrying the value):

- the first plan to :meth:`PrefixRegistry.acquire` a key is the
  **leader**: it computes the prefix as an undeduped run would (read,
  digest, feature-cache lookup, the kernel) and
  :meth:`~PrefixClaim.publish`-es the result;
- a concurrent plan acquiring the same key is a **follower**: it blocks,
  within the ambient deadline (:func:`~..io.deadline.cond_wait`), until
  the leader publishes, then reuses the published value and skips its
  ingest+featurize stage;
- a leader that fails :meth:`~PrefixClaim.abandon`-s the entry (its
  ``settle`` in a ``finally``); the first waiting follower is promoted to
  leader and computes its own prefix. A leader's fault costs a follower
  time, never correctness.

**Shared values.** The fused path publishes its feature rows as the
tensor on the run's device and its targets as a numpy array; the seizure
path one device tensor per extractor config. Numpy arrays are marked
read-only, as the JAX package marks them. A torch tensor cannot be marked
so, and it is shared, not cloned: a follower reads the leader's tensor
(moved to its own device when it runs on another one), and no downstream
path writes into a run's feature rows (every classifier, fan-out and
population path gathers or casts them into new tensors;
``tests/test_torch_dedup.py`` and ``chip_smoke.py`` phase 4l hold the
leader's rows to one digest across a follower's fit). A leader publishes
only after its featurize stage's device-wide synchronize, so a follower on
another worker thread never reads rows a kernel is still writing.

``bytes_saved`` counts the bytes of the shared value's numpy arrays and
torch tensors: the feature rows and the targets. The JAX package counts
numpy arrays, which its published rows are, so the two counts agree for the
same pair of plans (``tests/test_torch_dedup.py``).

Attribution lands in each plan's own domain metrics (``dedup.lead`` /
``dedup.hit`` / ``dedup.bytes_saved``) and in its run report's ``dedup``
block. Entries are keyed on the plan, not on file bytes, so the registry
assumes input files do not change while the process lives. The READY
entries are bounded by an LRU capacity (``EEG_TPU_PREFIX_CACHE_ENTRIES``,
default 8); ``dedup=false`` or ``EEG_TPU_NO_PREFIX_DEDUP=1`` opt out.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

#: set to "1" to disable prefix dedup process-wide
ENV_DISABLE = "EEG_TPU_NO_PREFIX_DEDUP"
#: LRU capacity of READY entries (building entries are never evicted)
ENV_CAPACITY = "EEG_TPU_PREFIX_CACHE_ENTRIES"

_DEFAULT_CAPACITY = 8

_BUILDING = "building"
_READY = "ready"


def _freeze(value: Any) -> None:
    """Mark every numpy array inside ``value`` read-only, recursively (torch
    tensors are shared as they are; see the module docstring)."""
    if isinstance(value, np.ndarray):
        try:
            value.flags.writeable = False
        except ValueError:  # views of foreign buffers
            pass
    elif isinstance(value, (tuple, list)):
        for item in value:
            _freeze(item)


def _nbytes(value: Any) -> int:
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, torch.Tensor):
        return int(value.numel() * value.element_size())
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(item) for item in value)
    return 0


class _Entry:
    __slots__ = ("state", "leader_plan", "value", "meta", "build_seconds", "stored_at")

    def __init__(self, leader_plan: Optional[str]):
        self.state = _BUILDING
        self.leader_plan = leader_plan
        self.value: Any = None
        self.meta: Dict[str, Any] = {}
        self.build_seconds = 0.0
        self.stored_at = 0.0


class PrefixClaim:
    """One plan's stake in one prefix build.

    ``role`` is ``"leader"`` (compute, then :meth:`publish`, or let
    :meth:`settle` abandon on the error path) or ``"follower"``
    (``value``/``meta`` already hold the leader's build). ``waited``: the
    claim blocked behind another plan; ``leader_failed``: it was promoted
    after an abandon. :meth:`settle` is idempotent and belongs in a
    ``finally``."""

    __slots__ = ("registry", "key", "role", "plan_id", "value", "meta", "leader_plan",
                 "build_seconds", "bytes_saved", "waited", "leader_failed", "_settled",
                 "_started")

    def __init__(self, registry, key, role, plan_id, waited=False, leader_failed=False):
        self.registry = registry
        self.key = key
        self.role = role
        self.plan_id = plan_id
        self.value: Any = None
        self.meta: Dict[str, Any] = {}
        self.leader_plan: Optional[str] = plan_id
        self.build_seconds = 0.0
        self.bytes_saved = 0
        self.waited = waited
        self.leader_failed = leader_failed
        self._settled = False
        self._started = time.perf_counter()

    def publish(self, value: Any, meta: Optional[Dict[str, Any]] = None) -> None:
        """Leader only: hand the computed prefix to the registry and wake
        every follower. The build time is acquire-to-publish, the seconds
        a follower is credited with saving."""
        if self._settled or self.role != "leader":
            return
        self._settled = True
        self.build_seconds = time.perf_counter() - self._started
        self.registry._publish(self.key, value, meta or {}, self.plan_id, self.build_seconds)

    def abandon(self) -> None:
        """Leader only: the build failed; release the entry so the first
        waiting follower is promoted to leader."""
        if self._settled or self.role != "leader":
            return
        self._settled = True
        self.registry._abandon(self.key)

    def settle(self) -> None:
        """Idempotent cleanup for ``finally`` blocks: an unpublished leader
        abandons; everything else is a no-op."""
        self.abandon()


class PrefixRegistry:
    """In-memory, process-local map of prefix key -> one computed value,
    with single-flight build semantics and leader/follower attribution."""

    def __init__(self, capacity: Optional[int] = None):
        self._capacity = capacity
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._entries: Dict[str, _Entry] = {}
        self._leads = 0
        self._hits = 0
        self._leader_failures = 0
        self._evictions = 0

    def _cap(self) -> int:
        if self._capacity is not None:
            return self._capacity
        try:
            return max(1, int(os.environ.get(ENV_CAPACITY, _DEFAULT_CAPACITY)))
        except ValueError:
            return _DEFAULT_CAPACITY

    def acquire(self, key: str, plan_id: Optional[str] = None) -> PrefixClaim:
        """Leader or follower claim for ``key``; blocks (within the ambient
        deadline) while another plan builds it. Counts land in the calling
        thread's fault domain: the plan's own worker thread."""
        from .. import obs
        from ..io import deadline as deadline_mod
        from ..obs import events

        waited = False
        with self._cond:
            while True:
                entry = self._entries.get(key)
                if entry is None:
                    entry = _Entry(plan_id)
                    self._entries[key] = entry
                    self._leads += 1
                    if waited:
                        self._leader_failures += 1
                    break
                if entry.state == _READY:
                    claim = PrefixClaim(self, key, "follower", plan_id, waited=waited)
                    claim.value = entry.value
                    claim.meta = dict(entry.meta)
                    claim.leader_plan = entry.leader_plan
                    claim.build_seconds = entry.build_seconds
                    claim.bytes_saved = _nbytes(entry.value)
                    entry.stored_at = time.monotonic()  # LRU touch
                    self._hits += 1
                    obs.metrics.count("dedup.hit")
                    obs.metrics.count("dedup.bytes_saved", claim.bytes_saved)
                    events.event("dedup.hit", prefix=key, leader=entry.leader_plan or "",
                                 bytes_saved=claim.bytes_saved)
                    return claim
                # BUILDING: wait for the leader to publish or abandon
                waited = True
                obs.metrics.count("dedup.wait")
                deadline_mod.cond_wait(
                    self._cond,
                    lambda: self._entries.get(key) is not entry or entry.state != _BUILDING,
                    f"prefix-dedup wait for {key}",
                )
        obs.metrics.count("dedup.lead")
        if waited:
            # promoted after an abandon: the follower computes its own prefix
            obs.metrics.count("dedup.leader_failed")
            events.event("dedup.leader_failed", prefix=key)
        events.event("dedup.lead", prefix=key)
        return PrefixClaim(self, key, "leader", plan_id, waited=waited, leader_failed=waited)

    def _publish(self, key, value, meta, plan_id, build_seconds):
        from .. import obs
        from ..obs import events

        _freeze(value)
        with self._cond:
            entry = self._entries.get(key)
            if entry is None or entry.state != _BUILDING:
                return  # abandoned meanwhile
            entry.state = _READY
            entry.value = value
            entry.meta = dict(meta)
            entry.leader_plan = plan_id
            entry.build_seconds = build_seconds
            entry.stored_at = time.monotonic()
            self._evict_locked()
            self._cond.notify_all()
        obs.metrics.count("dedup.publish")
        events.event("dedup.publish", prefix=key, build_s=round(build_seconds, 4))

    def _abandon(self, key):
        with self._cond:
            entry = self._entries.get(key)
            if entry is not None and entry.state == _BUILDING:
                del self._entries[key]
            self._cond.notify_all()

    def _evict_locked(self):
        ready = [(e.stored_at, k) for k, e in self._entries.items() if e.state == _READY]
        cap = self._cap()
        if len(ready) <= cap:
            return
        ready.sort()
        for _, k in ready[: len(ready) - cap]:
            del self._entries[k]
            self._evictions += 1

    def stats(self) -> Dict[str, Any]:
        """Process-wide dedup attribution (hit ratio = follows / all
        acquisitions)."""
        with self._lock:
            total = self._leads + self._hits
            return {
                "leads": self._leads,
                "hits": self._hits,
                "leader_failures": self._leader_failures,
                "evictions": self._evictions,
                "entries": len(self._entries),
                "hit_ratio": round(self._hits / total, 6) if total else 0.0,
            }

    def reset(self) -> None:
        """Drop entries and zero the counters. Never call with builds in
        flight."""
        with self._cond:
            self._entries.clear()
            self._leads = self._hits = 0
            self._leader_failures = self._evictions = 0
            self._cond.notify_all()


_registry = PrefixRegistry()


def registry() -> PrefixRegistry:
    return _registry


def stats() -> Dict[str, Any]:
    return _registry.stats()


def reset() -> None:
    _registry.reset()


def eligible(plan) -> bool:
    """Whether ``plan`` takes part in prefix dedup: opted in (``dedup=``
    defaults true, ``EEG_TPU_NO_PREFIX_DEDUP=1`` wins), batch mode, and on
    a path that makes an in-memory feature matrix: the fused P300 modes
    and every seizure run. The host P300 path (``fe=dwt-8``) loads an
    epoch batch instead and is not deduped."""
    if plan is None or os.environ.get(ENV_DISABLE) == "1":
        return False
    if not getattr(plan, "dedup", True) or plan.serve:
        return False
    if plan.task == "seizure":
        return True
    return bool(plan.fused)


def acquire_for(plan) -> Optional[PrefixClaim]:
    """A claim for the plan's prefix, or None when the plan is ineligible
    or runs outside a plan's fault domain: dedup is for executor- and
    gateway-driven runs only, so a solo ``PipelineBuilder`` run claims
    nothing and its feature-cache counters stay as they were."""
    from ..obs import domain as run_domain

    if not eligible(plan):
        return None
    plan_id = run_domain.current_plan_id()
    if plan_id is None:
        return None
    key = plan.prefix_key()
    if key is None:
        return None
    return _registry.acquire(key, plan_id)
