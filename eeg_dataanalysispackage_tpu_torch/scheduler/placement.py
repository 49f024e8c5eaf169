"""Device-aware fleet placement: the shared device pool.

Port of the JAX package's ``scheduler/placement.py``. Replicas over one
journal directory otherwise run their plans on whatever cards their
processes see, so two replicas running two 4-card plans on one 8-card host
would time-share the same cards. This module makes the host's ordinals a
claimable pool over the lease protocol plans already use
(``scheduler/lease.py``): one ``device-<ordinal>.lease`` file an ordinal
beside the journal, ``O_CREAT|O_EXCL`` creation as the claim, mtime
heartbeats from the holder's beat thread, break only the provably dead. A
plan's whole footprint (``ExecutionPlan.device_footprint()``) is claimed
**all-or-nothing**: a partial hold is released at once, so two replicas'
gangs never deadlock holding half a pool each.

Gang scheduling with backfill lives in the executor's worker loop
(``scheduler/executor.py``): a plan whose footprint cannot be met now goes
back to the queue's tail (its journal record stays ``submitted``, its plan
lease stays held) while smaller plans backfill past it. Starvation is
bounded by an age rule: every unmet footprint is advertised as a
``waiting-<plan_id>.json`` record in the lease directory, and once the
fleet's oldest waiting plan has waited past ``EEG_TPU_GANG_PROMOTION_S``
(default 5 s), no replica grants any other plan new ordinals until it fits.

Ordinals are the process's visible CUDA indices (``cuda:<i>``). Replicas
that share a pool must see the same cards in the same order (one
``CUDA_VISIBLE_DEVICES`` for all of them, or none). ``EEG_TPU_DEVICE_POOL``
sizes the pool: unset, empty or ``0`` turns placement off; ``auto`` is
``torch.cuda.device_count()`` at replica start and raises when no card is
visible; an integer is that many ordinals.

Semantics, as in the JAX package: a single-device plan's grant is a
capacity token (the plan runs on the builder's device); a meshed plan's mesh
is built from exactly its leased ordinals (``PipelineBuilder._resolve_mesh``,
``mesh_resolved["leased"]``). Serve plans and pod plans with
``processes>1`` are exempt and run unplaced; so does a footprint larger than
the pool, and a plan whose placement attempt raised (counted in
``placement.errors``). Unplaced is still the plan's own device: where the
JAX package's mesh ladder then degrades an oversize gang to one device, the
port's mesh raises (``requested N devices, only M present``), as every
unbuildable mesh does.

Counters ride :func:`lease.stats` (``device_claims`` /
``device_claim_losses`` / ``device_releases``) and ``obs.metrics``
(``placement.*``); :func:`device_table`, :func:`waiting_entries` and
:func:`pool_size_marker` are the operator's view of the directory.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from . import lease as lease_mod

logger = logging.getLogger(__name__)

#: pool size: unset/""/"0" = placement off; "auto" = the visible cards;
#: an integer = exactly that many ordinals
ENV_DEVICE_POOL = "EEG_TPU_DEVICE_POOL"
#: seconds the fleet's oldest waiting footprint may starve before it is
#: promoted (no replica grants any other plan new ordinals)
ENV_GANG_PROMOTION = "EEG_TPU_GANG_PROMOTION_S"
_DEFAULT_PROMOTION_S = 5.0

#: :meth:`DevicePool.admit`'s answer "run without a grant": the plan is
#: exempt (serve/pod), its footprint exceeds the pool, or the pool failed
UNPLACED = object()

_POOL_MARKER = "device-pool.json"
_MARKER_SCHEMA = "eeg-tpu-device-pool/v1"
_WAIT_SCHEMA = "eeg-tpu-placement-wait/v1"


def promotion_age() -> float:
    value = os.environ.get(ENV_GANG_PROMOTION)
    if not value:
        return _DEFAULT_PROMOTION_S
    try:
        return float(value)
    except ValueError:
        logger.warning("unparseable %s=%r; using the default %.1fs",
                       ENV_GANG_PROMOTION, value, _DEFAULT_PROMOTION_S)
        return _DEFAULT_PROMOTION_S


def _atomic_write_text(path: str, text: str) -> None:
    from ..io import modelfiles

    modelfiles.atomic_write_bytes(path, text.encode("utf-8"))


def _wait_path(directory: str, plan_id: str) -> str:
    return os.path.join(directory, f"waiting-{plan_id}.json")


def waiting_entries(directory: str, clear_dead: bool = False) -> List[Dict[str, Any]]:
    """Every valid waiting record in ``directory``, oldest first. A record
    whose advertising process is provably dead (pid and start token, the
    lease module's test) is skipped, and unlinked when ``clear_dead``: a
    killed replica's waiting gang must not promote forever and block the
    fleet (its plan re-runs through its stale plan lease and advertises
    again under the survivor)."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    out = []
    for name in names:
        if not (name.startswith("waiting-") and name.endswith(".json")):
            continue
        path = os.path.join(directory, name)
        try:
            with open(path) as f:
                entry = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(entry, dict) or "plan_id" not in entry:
            continue
        pid = entry.get("pid")
        if pid is not None and lease_mod._holder_dead(pid, entry.get("start_token", "")):
            if clear_dead:
                try:
                    os.unlink(path)
                except OSError:
                    pass
            continue
        out.append(entry)
    out.sort(key=lambda e: (e.get("since", 0.0), e.get("plan_id", "")))
    return out


def device_table(directory: str) -> List[Dict[str, Any]]:
    """The device leases in ``directory``, one row a held ordinal
    (``holder_info`` plus ``ordinal``), by ordinal."""
    observer = lease_mod.LeaseDir(directory, holder="placement-observer")
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return []
    out = []
    for name in names:
        if not (name.startswith("device-") and name.endswith(".lease")):
            continue
        stem = name[len("device-"):-len(".lease")]
        if not stem.isdigit():
            continue
        info = observer.holder_info(f"device:{stem}")
        if info is not None:
            info["ordinal"] = int(stem)
            out.append(info)
    out.sort(key=lambda r: r["ordinal"])
    return out


def pool_size_marker(directory: str) -> Optional[int]:
    """The advertised pool size, or None when no pool ever ran here."""
    try:
        with open(os.path.join(directory, _POOL_MARKER)) as f:
            marker = json.load(f)
        return int(marker["size"])
    except (OSError, ValueError, KeyError, TypeError):
        return None


class DeviceGrant:
    """One plan's granted ordinals, released once when its execution ends."""

    __slots__ = ("plan_id", "ordinals", "_pool", "_released")

    def __init__(self, plan_id: str, ordinals: Tuple[int, ...], pool):
        self.plan_id = plan_id
        self.ordinals = tuple(ordinals)
        self._pool = pool
        self._released = False

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        self._pool._release_ordinals(self.ordinals)

    def __repr__(self) -> str:
        return f"DeviceGrant(plan={self.plan_id}, ordinals={list(self.ordinals)})"


class DevicePool:
    """One replica's handle on the shared device pool.

    Across processes the lease file decides (the ``O_EXCL`` create wins);
    in the process ``_lock`` and the granted set do, because
    ``LeaseDir.try_claim`` hands a lease this holder already holds back to a
    second caller, which for an ordinal would be a double grant."""

    def __init__(self, leases: lease_mod.LeaseDir, size: int):
        if size < 1:
            raise ValueError(f"device pool size must be >= 1, got {size}")
        self.leases = leases
        self.size = int(size)
        self._lock = threading.Lock()
        #: ordinals granted to plans in this process now
        self._granted: set = set()
        self._write_marker()

    @classmethod
    def from_env(cls, leases: lease_mod.LeaseDir) -> Optional["DevicePool"]:
        """The pool ``EEG_TPU_DEVICE_POOL`` asks for; None when placement is
        off (the default). ``auto`` counts the visible cards and raises
        when there are none."""
        value = (os.environ.get(ENV_DEVICE_POOL) or "").strip()
        if not value or value == "0":
            return None
        if value.lower() == "auto":
            import torch

            size = torch.cuda.device_count()
            if size < 1:
                raise ValueError(f"{ENV_DEVICE_POOL}=auto counts the visible CUDA devices, "
                                 "and this process sees none")
        else:
            try:
                size = int(value)
            except ValueError:
                logger.warning("unparseable %s=%r; placement disabled", ENV_DEVICE_POOL, value)
                return None
            if size < 1:
                return None
        return cls(leases, size)

    def _write_marker(self) -> None:
        """Advertise the pool size beside the lease files for offline
        observers. A marker that cannot land degrades the view, not the
        pool."""
        try:
            _atomic_write_text(
                os.path.join(self.leases.directory, _POOL_MARKER),
                json.dumps({"schema": _MARKER_SCHEMA, "size": self.size,
                            "holder": self.leases.holder, "pid": os.getpid()},
                           sort_keys=True) + "\n",
            )
        except OSError as e:
            logger.warning("device-pool marker write failed (%s: %s)", type(e).__name__, e)

    # -- the scheduling surface

    def admit(self, plan_id: str, footprint: Dict[str, Any]):
        """One placement attempt for ``plan_id``: a :class:`DeviceGrant`
        (run on these ordinals), ``None`` (wait: the caller requeues the
        plan and smaller plans backfill past it) or :data:`UNPLACED` (run
        without a grant: exempt, larger than the pool)."""
        from .. import obs

        if footprint.get("memory_class") == "serve" or footprint.get("hosts", 1) > 1:
            # resident services, and pod plans (their processes own their
            # devices)
            obs.metrics.count("placement.exempt")
            return UNPLACED
        need = int(footprint.get("devices", 1))
        if need == 0:
            need = self.size
        if need > self.size:
            obs.metrics.count("placement.unsatisfiable")
            logger.warning("plan %s wants %d devices but the pool holds %d; running unplaced",
                           plan_id, need, self.size)
            self.clear_waiting(plan_id)
            return UNPLACED
        with self._lock:
            promoted = self.promoted()
            if promoted is not None and promoted["plan_id"] != plan_id:
                # a starved gang owns every ordinal that frees up until it fits
                self._note_waiting(plan_id, footprint)
                obs.metrics.count("placement.promotion_blocked")
                return None
            claimed: List[int] = []
            for ordinal in range(self.size):
                if len(claimed) == need:
                    break
                if ordinal in self._granted:
                    continue
                if isinstance(self.leases.try_claim(f"device:{ordinal}"), lease_mod.PlanLease):
                    claimed.append(ordinal)
            if len(claimed) < need:
                # all-or-nothing: a partial gang would deadlock against a
                # peer holding the complement
                for ordinal in claimed:
                    self.leases.release(f"device:{ordinal}")
                    lease_mod._count("device_releases")
                self._note_waiting(plan_id, footprint)
                obs.metrics.count("placement.waits")
                return None
            self._granted.update(claimed)
        self.clear_waiting(plan_id)
        obs.metrics.count("placement.grants")
        if promoted is not None and promoted["plan_id"] == plan_id:
            obs.metrics.count("placement.promotions")
        elif self.waiting_others(plan_id):
            # a smaller plan ran past a footprint that still waits
            obs.metrics.count("placement.backfills")
        return DeviceGrant(plan_id, tuple(claimed), self)

    def _release_ordinals(self, ordinals: Tuple[int, ...]) -> None:
        with self._lock:
            for ordinal in ordinals:
                self.leases.release(f"device:{ordinal}")
                lease_mod._count("device_releases")
                self._granted.discard(ordinal)

    def release_all(self) -> None:
        """Free every ordinal this process granted (replica close)."""
        with self._lock:
            for ordinal in sorted(self._granted):
                self.leases.release(f"device:{ordinal}")
                lease_mod._count("device_releases")
            self._granted.clear()

    # -- waiting records

    def _note_waiting(self, plan_id: str, footprint: Dict[str, Any]) -> None:
        """Advertise an unmet footprint. The first wait's time is the
        promotion clock, so our own record is never rewritten; a dead
        peer's record for the plan is (after a takeover the survivor owns
        the wait)."""
        path = _wait_path(self.leases.directory, plan_id)
        try:
            with open(path) as f:
                existing = json.load(f)
            if existing.get("holder") == self.leases.holder:
                return
            pid = existing.get("pid")
            if pid is not None and not lease_mod._holder_dead(pid,
                                                              existing.get("start_token", "")):
                return  # a live peer's record (its plan lease rules)
        except (OSError, ValueError):
            pass
        try:
            _atomic_write_text(path, json.dumps({
                "schema": _WAIT_SCHEMA,
                "plan_id": plan_id,
                "footprint": dict(footprint),
                "since": time.time(),
                "holder": self.leases.holder,
                "pid": os.getpid(),
                "start_token": lease_mod._pid_start_token(os.getpid()) or "",
            }, sort_keys=True) + "\n")
        except OSError as e:
            logger.warning("placement waiting record write failed for %s (%s: %s)",
                           plan_id, type(e).__name__, e)

    def clear_waiting(self, plan_id: str) -> None:
        try:
            os.unlink(_wait_path(self.leases.directory, plan_id))
        except OSError:
            pass

    def waiting_entries(self) -> List[Dict[str, Any]]:
        return waiting_entries(self.leases.directory, clear_dead=True)

    def waiting_others(self, plan_id: str) -> List[Dict[str, Any]]:
        return [e for e in self.waiting_entries() if e.get("plan_id") != plan_id]

    def promoted(self) -> Optional[Dict[str, Any]]:
        """The fleet's oldest waiting record once it has starved past
        :func:`promotion_age`, else None. Every replica reads the same
        directory, so promotion is fleet-wide."""
        entries = self.waiting_entries()
        if not entries:
            return None
        oldest = entries[0]
        if time.time() - float(oldest.get("since", 0.0)) > promotion_age():
            return oldest
        return None

    # -- observation

    def free_ordinals(self) -> List[int]:
        """Ordinals claimable now: no lease file, or a stale one."""
        out = []
        for ordinal in range(self.size):
            info = self.leases.holder_info(f"device:{ordinal}")
            if info is None or info["stale"]:
                out.append(ordinal)
        return out

    def health(self) -> Dict[str, Any]:
        """The ``/readyz`` evidence: pool size, this replica's held
        ordinals, the fleet's claimable count, the waiting plans."""
        waiting = self.waiting_entries()
        return {
            "size": self.size,
            "held": self.leases.held_device_ordinals(),
            "free": len(self.free_ordinals()),
            "waiting": len(waiting),
            "oldest_waiting": waiting[0]["plan_id"] if waiting else None,
        }
