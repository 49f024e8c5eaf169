"""Plan leases: the cross-process claim on a journaled plan.

Port of the JAX package's ``scheduler/lease.py``. Executors over one shared
journal directory need one answer to "who executes plan p0007?"; the answer
is a lease file beside the record::

    <journal_dir>/plan-<id>.lease     "<holder-id>\\n<pid>\\n<start-token>\\n"

taken with ``O_CREAT|O_EXCL``: creation is the claim, the content names the
holder, and the file's mtime is the heartbeat (the holder touches it, so a
fresh mtime means a live owner even where its pid cannot be seen).

- **Break only the provably dead.** A lease is broken only when its
  heartbeat is older than ``EEG_TPU_LEASE_TIMEOUT_S`` (default 30 s) *and*
  its holder no longer exists: ``os.kill(pid, 0)`` raises
  ``ProcessLookupError``, or the pid is alive with another start token
  (``/proc/<pid>/stat`` field 22), which means it was recycled. An unknown
  or unreadable pid reads as alive.
- **Break atomically.** Breakers are serialized by a ``<lease>.breaking``
  guard (the same ``O_EXCL`` claim), staleness is re-read under it, and
  the stale file is captured with ``os.rename`` to a breaker-unique name
  and checked to be the observed record before it is dropped; a capture
  that caught a fresh lease republishes it with ``os.link``, which cannot
  overwrite a newer claim. Racing breakers break once and grant one claim.
- **Unlink only your own lease**: a holder whose stale lease a peer broke
  and re-took must not delete the peer's.

The same files serialize an idempotency key's registration across
executors (``key-<hash>.lease``, :func:`key_claim_id`); ``device:<n>``
claims (``device-<n>.lease``) and ``assist:<plan>:<k>`` claims
(``assist-<plan>-<k>.lease``) are written as the JAX package writes them,
for device placement (``scheduler/placement.py``) and the fleet's pod
assist (``gateway/fleet.py``). A fleet replica registers its lease
directory with :func:`set_active`, so a crash report can name the leases
the process held (:func:`active_held`).

Chaos points: ``fleet.lease`` fires inside one claim attempt and
``fleet.heartbeat`` inside one heartbeat, both raised as ``OSError`` so
they land in the degraded paths (a failed claim is no claim, a failed beat
a skipped one; both counted, neither fatal). :func:`stats` holds the
process's counters, which ``obs.metrics`` also counts as ``fleet.lease_*``.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

#: seconds a lease's heartbeat may go untouched before it may be broken
#: (its holder must also be provably dead)
ENV_LEASE_TIMEOUT = "EEG_TPU_LEASE_TIMEOUT_S"
_DEFAULT_LEASE_TIMEOUT_S = 30.0

#: :meth:`LeaseDir.try_claim`'s answer when a live holder (or one not yet
#: breakable) holds the plan: the caller must not execute it
FOREIGN_HELD = object()

_COUNTERS = ("claims", "takeovers", "breaks", "heartbeats", "heartbeat_failures",
             "claim_failures", "claim_losses", "device_claims", "device_claim_losses",
             "device_releases")
_lock = threading.Lock()
_stats: Dict[str, int] = dict.fromkeys(_COUNTERS, 0)


def lease_timeout() -> float:
    value = os.environ.get(ENV_LEASE_TIMEOUT)
    if not value:
        return _DEFAULT_LEASE_TIMEOUT_S
    try:
        return float(value)
    except ValueError:
        logger.warning("unparseable %s=%r; using the default %.0fs",
                       ENV_LEASE_TIMEOUT, value, _DEFAULT_LEASE_TIMEOUT_S)
        return _DEFAULT_LEASE_TIMEOUT_S


def stats() -> Dict[str, int]:
    """The process's lease counters (zeros when no lease was ever taken):
    claims, takeovers, breaks, heartbeats and their failures, claim
    failures and losses, and the device claims'."""
    with _lock:
        return dict(_stats)


def reset_stats() -> None:
    with _lock:
        for name in _COUNTERS:
            _stats[name] = 0


#: the replica's live LeaseDir (a weak reference), registered by
#: gateway/fleet.py so the crash report (obs/report.py) can name the
#: leases the process held when a plan died
_active_dir = None


def set_active(lease_dir: "LeaseDir") -> None:
    import weakref

    global _active_dir
    _active_dir = weakref.ref(lease_dir)


def active_held() -> List[str]:
    """Names of the leases the registered LeaseDir holds right now; []
    when no fleet replica runs in this process."""
    ld = _active_dir() if _active_dir is not None else None
    if ld is None:
        return []
    return sorted(lease.plan_id for lease in ld.held_leases())


def _count(name: str) -> None:
    from .. import obs

    with _lock:
        _stats[name] += 1
    obs.metrics.count(f"fleet.lease_{name}")


def key_claim_id(idempotency_key: str) -> str:
    """The claim name that serializes registering an idempotency key
    (``key-<hash>.lease``): hashed, so key contents never reach a file
    name."""
    digest = hashlib.sha256(idempotency_key.encode()).hexdigest()[:16]
    return f"key:{digest}"


def _pid_start_token(pid: int) -> Optional[str]:
    """The pid's start time (``/proc/<pid>/stat`` field 22): a (pid, token)
    pair survives pid reuse. None when unreadable."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            # the command name (field 2) may hold spaces and parentheses:
            # the fixed fields start after the last ')'
            fields = f.read().rsplit(b")", 1)[1].split()
        return fields[19].decode()
    except (OSError, IndexError, ValueError, UnicodeDecodeError):
        return None


def _holder_dead(pid: Optional[int], token: str = "") -> bool:
    """True only when the recorded holder provably no longer exists: its
    pid is gone, or alive with another start token. Unknown, unparseable
    or permission-denied pids read as alive."""
    if pid is None:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    except OSError:
        return False
    if token:
        current = _pid_start_token(pid)
        if current is not None and current != token:
            return True
    return False


class PlanLease:
    """One owned lease: heartbeat from the holder, released once when the
    plan's terminal record lands (or when the holder hands it back)."""

    __slots__ = ("plan_id", "path", "holder", "acquired_at", "_released")

    def __init__(self, plan_id: str, path: str, holder: str):
        self.plan_id = plan_id
        self.path = path
        self.holder = holder
        self.acquired_at = time.time()
        self._released = False

    def heartbeat(self) -> bool:
        """Touch the lease's mtime; False (counted) when the beat could not
        land, and the lease then ages toward breakability."""
        from ..obs import chaos

        if self._released:
            return False
        try:
            chaos.maybe_fire("fleet.heartbeat", OSError)
            os.utime(self.path, None)
        except OSError as e:
            _count("heartbeat_failures")
            logger.warning("lease heartbeat failed for %s (%s: %s)",
                           self.plan_id, type(e).__name__, e)
            return False
        _count("heartbeats")
        return True

    def release(self) -> None:
        """Unlink the lease only while it names this holder."""
        if self._released:
            return
        self._released = True
        try:
            with open(self.path) as f:
                owner = f.readline().strip()
            if owner == self.holder:
                os.unlink(self.path)
        except OSError:
            pass

    @property
    def released(self) -> bool:
        return self._released


class LeaseDir:
    """The lease files of one shared journal directory, as one holder
    sees and holds them."""

    def __init__(self, directory: str, holder: str):
        self.directory = directory
        self.holder = holder
        self._held: Dict[str, PlanLease] = {}
        self._held_lock = threading.Lock()

    def _path(self, name: str) -> str:
        for prefix in ("key", "device"):
            if name.startswith(prefix + ":"):
                return os.path.join(self.directory,
                                    f"{prefix}-{name[len(prefix) + 1:]}.lease")
        if name.startswith("assist:"):
            stem = name[len("assist:"):].replace(":", "-")
            return os.path.join(self.directory, f"assist-{stem}.lease")
        return os.path.join(self.directory, f"plan-{name}.lease")

    # -- claiming

    def _try_create(self, path: str) -> Optional[bool]:
        """``O_EXCL`` create with this holder's id, pid and start token:
        True claimed, False a holder exists, None locking unavailable
        (an unwritable directory, chaos)."""
        from ..obs import chaos

        try:
            chaos.maybe_fire("fleet.lease", OSError)
            os.makedirs(self.directory, exist_ok=True)
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        except OSError:
            return None
        token = _pid_start_token(os.getpid()) or ""
        try:
            os.write(fd, f"{self.holder}\n{os.getpid()}\n{token}\n".encode())
        finally:
            os.close(fd)
        return True

    @staticmethod
    def _read_id_file(path: str) -> Optional[Tuple[str, Optional[int], str]]:
        """(holder, pid, start token) from a lease or guard file; None when
        unreadable."""
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        holder = lines[0].strip() if lines else ""
        pid: Optional[int] = None
        if len(lines) > 1:
            try:
                pid = int(lines[1].strip())
            except ValueError:
                pid = None
        token = lines[2].strip() if len(lines) > 2 else ""
        return holder, pid, token

    def _break_stale(self, plan_id: str, path: str) -> Optional[bool]:
        """Break one observed-stale lease atomically (see the module
        docstring). True: this holder broke it and now races for the vacant
        claim; False: a peer owns the break, or the lease is live under
        re-read; None: locking unavailable."""
        from ..obs import events

        guard = path + ".breaking"
        took_guard = self._try_create(guard)
        if took_guard is False:
            ids = self._read_id_file(guard)
            try:
                age = time.time() - os.path.getmtime(guard)
            except OSError:
                return False
            if ids is None or not (_holder_dead(ids[1], ids[2]) or age > lease_timeout()):
                return False  # a live breaker owns the takeover
            # a guard whose breaker died (or wedged past the timeout): drop
            # it atomically, then take it
            trash = f"{guard}.{self.holder}.{os.getpid()}"
            try:
                os.rename(guard, trash)
                os.unlink(trash)
            except OSError:
                return False
            took_guard = self._try_create(guard)
        if took_guard is not True:
            return None if took_guard is None else False
        try:
            info = self.holder_info(plan_id)
            if info is None:
                return True  # released meanwhile: the claim is vacant
            if not info["stale"]:
                return False
            captured = f"{path}.broken.{self.holder}.{os.getpid()}"
            try:
                os.rename(path, captured)
            except OSError:
                return False
            got = self._read_id_file(captured)
            if got is not None and (got[0] != info["holder"] or got[1] != info["pid"]):
                # the capture caught a fresh lease: put it back (os.link
                # refuses to overwrite a claim that landed meanwhile)
                try:
                    os.link(captured, path)
                except OSError:
                    pass
                try:
                    os.unlink(captured)
                except OSError:
                    pass
                return False
            try:
                os.unlink(captured)
            except OSError:
                pass
            _count("breaks")
            events.event("fleet.lease_break", plan=plan_id, holder=info["holder"],
                         age_s=round(info["age_s"], 3))
            logger.warning("broke stale lease for %s (holder %s pid %s dead, heartbeat "
                           "%.1fs old > %.0fs timeout)", plan_id, info["holder"],
                           info["pid"], info["age_s"], lease_timeout())
            return True
        finally:
            ids = self._read_id_file(guard)
            if ids is not None and ids[0] == self.holder and ids[1] == os.getpid():
                try:
                    os.unlink(guard)
                except OSError:
                    pass

    def try_claim(self, plan_id: str, takeover: bool = False):
        """One non-blocking claim attempt: the owned :class:`PlanLease`;
        :data:`FOREIGN_HELD` when another holder has it (counted as a claim
        loss); or None when locking is unavailable (counted, retry later).
        A stale lease is broken first, atomically. ``takeover=True`` marks
        a claim of another executor's record for the counters."""
        device = plan_id.startswith("device:")
        loss = "device_claim_losses" if device else "claim_losses"
        path = self._path(plan_id)
        with self._held_lock:
            held = self._held.get(plan_id)
        if held is not None and not held.released:
            return held
        created = self._try_create(path)
        if created is False:
            info = self.holder_info(plan_id)
            if info is not None and info["holder"] == self.holder:
                # this holder's own lease, raced from two of its threads
                with self._held_lock:
                    held = self._held.get(plan_id)
                if held is not None and not held.released:
                    return held
            if info is None:
                created = self._try_create(path)  # released meanwhile: once more
            elif info["stale"]:
                broke = self._break_stale(plan_id, path)
                if broke is True:
                    created = self._try_create(path)
                elif broke is None:
                    _count("claim_failures")
                    return None
                else:
                    _count(loss)
                    return FOREIGN_HELD
            else:
                _count(loss)
                return FOREIGN_HELD
        if created is not True:
            if created is False:
                _count(loss)
                return FOREIGN_HELD
            _count("claim_failures")
            return None
        lease = PlanLease(plan_id, path, self.holder)
        with self._held_lock:
            self._held[plan_id] = lease
        _count("device_claims" if device else "claims")
        if takeover and not device:
            _count("takeovers")
        return lease

    # -- the holder's surface

    def held(self, plan_id: str) -> Optional[PlanLease]:
        with self._held_lock:
            lease = self._held.get(plan_id)
        return None if lease is None or lease.released else lease

    def held_leases(self) -> List[PlanLease]:
        with self._held_lock:
            return [lease for lease in self._held.values() if not lease.released]

    def held_plan_leases(self) -> List[PlanLease]:
        """Held plan leases only (device, assist and key claims left out):
        the plans this holder is executing."""
        return [lease for lease in self.held_leases() if ":" not in lease.plan_id]

    def held_device_ordinals(self) -> List[int]:
        """The device-pool ordinals this holder holds right now."""
        out = []
        for lease in self.held_leases():
            if lease.plan_id.startswith("device:"):
                try:
                    out.append(int(lease.plan_id[len("device:"):]))
                except ValueError:
                    continue
        return sorted(out)

    def heartbeat_all(self) -> int:
        """One beat across every held lease; returns the beats that landed."""
        return sum(1 for lease in self.held_leases() if lease.heartbeat())

    def release(self, plan_id: str) -> None:
        with self._held_lock:
            lease = self._held.pop(plan_id, None)
        if lease is not None:
            lease.release()

    def release_all(self) -> None:
        with self._held_lock:
            leases = list(self._held.values())
            self._held.clear()
        for lease in leases:
            lease.release()

    def holder_info(self, plan_id: str) -> Optional[Dict[str, Any]]:
        """Who holds ``plan_id``: ``{plan_id, holder, pid, age_s, pid_dead,
        stale}``, or None when unleased."""
        path = self._path(plan_id)
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            return None
        ids = self._read_id_file(path)
        if ids is None:
            return None
        holder, pid, token = ids
        age_s = max(0.0, time.time() - mtime)
        dead = _holder_dead(pid, token)
        return {"plan_id": plan_id, "holder": holder, "pid": pid, "age_s": age_s,
                "pid_dead": dead, "stale": age_s > lease_timeout() and dead}

    def scan(self) -> List[Dict[str, Any]]:
        """:meth:`holder_info` of every plan lease in the directory."""
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        out = []
        for name in names:
            if name.startswith("plan-") and name.endswith(".lease"):
                info = self.holder_info(name[len("plan-"):-len(".lease")])
                if info is not None:
                    out.append(info)
        return out
